"""Packed-word ("bunch") buddy system — paper §III-D, generalized.

Counterpart of `repro/core/bunch.py`, copied line for line (host code,
plain Python on ints); `tests/test_torch_host_alloc.py` holds it equal to the
original word for word.

The paper packs a 4-level sub-tree (a *bunch*: 15 nodes, of which only
the 8 leaf nodes are materialized, 8 x 5 = 40 bits) into one 64-bit word
so that one RMW updates four tree levels at once.  The enabling insight
(paper Fig. 6) is that an interior node's state is *derivable* from its
descendants within the word:

    occ(n)       = AND over n's bunch-leaf range of OCC
    occ_left(n)  = OR  over the left-half range of (OCC|OCC_L|OCC_R)
    coal_left(n) = OR  over the left-half range of (COAL_L|COAL_R)

so only bunch leaves carry explicit bits; within-word state transitions
are atomic by construction (the whole word is CAS'd), and the climb only
touches the one bunch-leaf that is the parent of the lower bunch's root
(one RMW per B levels instead of per level).

Hardware adaptation (docs/design.md §2): the device words are 32 bits
wide, so the device-side packing is **B=3 levels per 32-bit word**
(4 leaves x 5 bits = 20 bits; `core/layout.py::BunchPacked`).  The host-side allocator keeps the
paper's **B=4 per uint64**.  Both are provided by this one
implementation, parameterized by (B, word dtype); both are validated to
produce *identical allocation addresses* to the unpacked oracle
(`core/ref.py`) on arbitrary traces, while issuing ~B x fewer word RMWs
on climbs — the paper's central §III-D claim.

Bunch layout: bunch layers cover tree levels [kB, (k+1)B); the bottom
layer may be partial.  A bunch is identified by its root node index r
(level ≡ 0 mod B); its word stores its deepest-materialized level.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.bits import (
    BUSY,
    COAL_LEFT,
    COAL_RIGHT,
    OCC,
    OCC_LEFT,
    OCC_RIGHT,
    STATUS_BITS,
    level_of,
)
from repro_torch.core.ref import _ilog2


@dataclasses.dataclass
class BunchStats:
    word_rmws: int = 0          # CAS-class word updates (the §III-D metric)
    word_rmw_failures: int = 0
    plain_writes: int = 0
    allocs_ok: int = 0
    allocs_failed: int = 0
    frees: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class BunchBuddy:
    """Buddy system over packed bunch words (paper §III-D).

    B=4 with 64-bit words reproduces the paper exactly; B=3 with 32-bit
    words is the device layout's variant.
    """

    def __init__(
        self,
        total_memory: int,
        min_size: int,
        max_size: Optional[int] = None,
        base_address: int = 0,
        bunch_levels: int = 4,
        word_bits: int = 64,
    ) -> None:
        if max_size is None:
            max_size = total_memory
        leaves = 1 << (bunch_levels - 1)
        if leaves * STATUS_BITS > word_bits:
            raise ValueError(
                f"bunch of {bunch_levels} levels needs {leaves * STATUS_BITS}"
                f" bits > word size {word_bits}"
            )
        self.total_memory = total_memory
        self.min_size = min_size
        self.max_size = max_size
        self.base_address = base_address
        self.B = bunch_levels
        self.word_bits = word_bits
        self.depth = _ilog2(total_memory // min_size)
        self.max_level = _ilog2(total_memory // max_size)
        # words keyed by bunch-root node index (levels ≡ 0 mod B).
        self.words: Dict[int, int] = {}
        self.index: List[int] = [0] * (total_memory // min_size)
        self.stats = BunchStats()
        self._scan_hint: dict[int, int] = {}

    # ------------------------------------------------------------------
    # Geometry helpers
    # ------------------------------------------------------------------
    def _bunch_root(self, n: int) -> int:
        """Root node index of the bunch containing n."""
        return n >> (level_of(n) % self.B)

    def _stored_level(self, root: int) -> int:
        """Deepest tree level materialized in this bunch's word."""
        rl = level_of(root)
        return min(rl + self.B - 1, self.depth)

    def _leaf_range(self, n: int) -> range:
        """Within-word leaf slot range whose OR/AND derives node n."""
        root = self._bunch_root(n)
        lb = level_of(n) - level_of(root)          # within-bunch level of n
        sb = self._stored_level(root) - level_of(root)  # leaf within-level
        offset = n - (root << lb)
        lo = offset << (sb - lb)
        return range(lo, lo + (1 << (sb - lb)))

    def _word(self, root: int) -> int:
        return self.words.get(root, 0)

    def _leaf_bits(self, word: int, slot: int) -> int:
        return (word >> (slot * STATUS_BITS)) & 0x1F

    def _cas_word(self, root: int, expected: int, new: int) -> bool:
        self.stats.word_rmws += 1
        if self._word(root) != expected:
            self.stats.word_rmw_failures += 1
            return False
        if new:
            self.words[root] = new
        else:
            self.words.pop(root, None)
        return True

    # -- derived node state (paper Fig. 6) --------------------------------
    def node_state(self, n: int) -> int:
        """Reconstruct the 5-bit status of any tree node (for tests/debug)."""
        root = self._bunch_root(n)
        word = self._word(root)
        r = self._leaf_range(n)
        if len(r) == 1:
            return self._leaf_bits(word, r[0])
        half = len(r) // 2
        occ = all(self._leaf_bits(word, s) & OCC for s in r)
        lbusy = any(
            self._leaf_bits(word, s) & (OCC | OCC_LEFT | OCC_RIGHT)
            for s in r[:half]
        )
        rbusy = any(
            self._leaf_bits(word, s) & (OCC | OCC_LEFT | OCC_RIGHT)
            for s in r[half:]
        )
        lcoal = any(
            self._leaf_bits(word, s) & (COAL_LEFT | COAL_RIGHT) for s in r[:half]
        )
        rcoal = any(
            self._leaf_bits(word, s) & (COAL_LEFT | COAL_RIGHT) for s in r[half:]
        )
        return (
            (OCC if occ else 0)
            | (OCC_LEFT if lbusy else 0)
            | (OCC_RIGHT if rbusy else 0)
            | (COAL_LEFT if lcoal else 0)
            | (COAL_RIGHT if rcoal else 0)
        )

    def _is_free(self, n: int) -> bool:
        """Derived is_free: every leaf slot in n's range has no busy bit."""
        word = self._word(self._bunch_root(n))
        busy = OCC | OCC_LEFT | OCC_RIGHT
        return all((self._leaf_bits(word, s) & busy) == 0 for s in self._leaf_range(n))

    # ------------------------------------------------------------------
    # Size/level/address rules (identical to the unpacked allocator)
    # ------------------------------------------------------------------
    def level_for_size(self, size: int) -> int:
        level = _ilog2(self.total_memory // size) if size else self.depth
        return min(level, self.depth)

    def size_of_level(self, level: int) -> int:
        return self.total_memory >> level

    def starting_address(self, n: int) -> int:
        level = level_of(n)
        return self.base_address + (n - (1 << level)) * self.size_of_level(level)

    # ------------------------------------------------------------------
    # NBALLOC (Alg. 1) over bunches
    # ------------------------------------------------------------------
    def nb_alloc(self, size: int, scattered: bool = False) -> Optional[int]:
        if size > self.max_size or size < 0:
            self.stats.allocs_failed += 1
            return None
        level = self.level_for_size(max(size, 1))
        base = 1 << level
        n_nodes = 1 << level
        start = self._scan_hint.get(level, 0) if scattered else 0
        i = base + start
        end = base + n_nodes
        wrapped = not scattered
        while True:
            if i >= end:
                if wrapped:
                    break
                wrapped = True
                i = base
                end = base + start
                if i >= end:
                    break
            if self._is_free(i):
                failed_at = self._try_alloc(i)
                if not failed_at:
                    addr = self.starting_address(i)
                    self.index[(addr - self.base_address) // self.min_size] = i
                    self.stats.allocs_ok += 1
                    if scattered:
                        self._scan_hint[level] = (i + 1 - base) % n_nodes
                    return addr
                d = 1 << (level - level_of(failed_at))
                i = (failed_at + 1) * d
                continue
            i += 1
        self.stats.allocs_failed += 1
        return None

    # ------------------------------------------------------------------
    # TRYALLOC (Alg. 2): one RMW per bunch instead of one per level
    # ------------------------------------------------------------------
    def _busy_range_mask(self, n: int) -> int:
        mask = 0
        for s in self._leaf_range(n):
            mask |= BUSY << (s * STATUS_BITS)
        return mask

    def _range_nonzero_mask(self, n: int) -> int:
        mask = 0
        for s in self._leaf_range(n):
            mask |= 0x1F << (s * STATUS_BITS)
        return mask

    def _try_alloc(self, n: int) -> int:
        root = self._bunch_root(n)
        word = self._word(root)
        # CAS(range == 0 -> range |= BUSY): the bunch equivalent of T2.
        if word & self._range_nonzero_mask(n):
            self.stats.word_rmws += 1  # the failed CAS attempt
            self.stats.word_rmw_failures += 1
            return n
        if not self._cas_word(root, word, word | self._busy_range_mask(n)):
            return n  # pragma: no cover - sequential: cannot happen
        # Climb across bunches: mark the cross leaf (the parent of this
        # bunch's root) in each ancestor bunch — one RMW per bunch.
        cross = root >> 1
        while cross >= 1 and level_of(root) > self.max_level:
            proot = self._bunch_root(cross)
            slot = self._leaf_range(cross)[0]
            pword = self._word(proot)
            leaf = self._leaf_bits(pword, slot)
            if leaf & OCC:
                # Occupied ancestor discovered (T11): roll back.
                self._free_node(n, level_of(cross) + 1)
                return cross
            new_leaf = leaf & ~(COAL_LEFT >> (root & 1))   # clean_coal
            new_leaf = new_leaf | (OCC_LEFT >> (root & 1))  # mark
            nw = (pword & ~(0x1F << (slot * STATUS_BITS))) | (
                new_leaf << (slot * STATUS_BITS)
            )
            self._cas_word(proot, pword, nw)
            root = proot
            cross = root >> 1
        return 0

    # ------------------------------------------------------------------
    # NBFREE / FREENODE / UNMARK over bunches
    # ------------------------------------------------------------------
    def nb_free(self, addr: int) -> None:
        n = self.index[(addr - self.base_address) // self.min_size]
        self._free_node(n, self.max_level)
        self.stats.frees += 1

    def _derived_busy(self, m: int) -> bool:
        """Derived (OCC|OCC_L|OCC_R) != 0 for node m (paper Fig. 6 OR rule)."""
        word = self._word(self._bunch_root(m))
        busy = OCC | OCC_LEFT | OCC_RIGHT
        return any(
            (self._leaf_bits(word, s) & busy) != 0 for s in self._leaf_range(m)
        )

    def _derived_coal(self, m: int) -> bool:
        """Derived 'a release is in flight somewhere in m's subtree'."""
        word = self._word(self._bunch_root(m))
        return any(
            (self._leaf_bits(word, s) & (COAL_LEFT | COAL_RIGHT)) != 0
            for s in self._leaf_range(m)
        )

    def _is_cross(self, child: int) -> bool:
        """True iff `child` is a bunch root, i.e. its parent is an explicit
        RMW point (a bunch-leaf slot of the parent bunch)."""
        return level_of(child) % self.B == 0

    def _rmw_leaf(self, node: int, transform) -> int:
        """CAS-update the explicit leaf slot of `node`; returns the OLD
        5-bit leaf value (sequential: single attempt suffices)."""
        proot = self._bunch_root(node)
        slot = self._leaf_range(node)[0]
        pword = self._word(proot)
        leaf = self._leaf_bits(pword, slot)
        nw = (pword & ~(0x1F << (slot * STATUS_BITS))) | (
            transform(leaf) << (slot * STATUS_BITS)
        )
        self._cas_word(proot, pword, nw)
        return leaf

    def _free_node(self, n: int, upper_bound: int) -> None:
        """FREENODE over bunches: walk *every* level of the climb exactly
        as Alg. 3 does — buddy occupancy / coalescing decisions are taken
        at each level — but issue word RMWs only at explicit cross-bunch
        leaves; within-bunch levels are derived (Fig. 6) and their state
        transition happens atomically with phase 2's single word update.
        """
        # -- phase 1: coalescing marks bottom-up (lines F2-F18) -----------
        runner = n
        current = n >> 1
        while level_of(runner) > upper_bound:
            if self._is_cross(runner):
                leaf = self._rmw_leaf(
                    current, lambda v: v | (COAL_LEFT >> (runner & 1))
                )
                occ_buddy = (leaf & (OCC_RIGHT << (runner & 1))) != 0
                coal_buddy = (leaf & (COAL_RIGHT << (runner & 1))) != 0
            else:
                buddy = runner ^ 1
                occ_buddy = self._derived_busy(buddy)
                coal_buddy = self._derived_coal(buddy)
            if occ_buddy and not coal_buddy:
                break
            runner = current
            current >>= 1
        # -- phase 2: zero the node's leaf range (one atomic word op, F19) -
        root = self._bunch_root(n)
        word = self._word(root)
        self._cas_word(root, word, word & ~self._range_nonzero_mask(n))
        # -- phase 3: UNMARK upward (Alg. 4), same per-level walk ----------
        if level_of(n) == upper_bound:
            return
        current = n
        while True:
            child = current
            current >>= 1
            if self._is_cross(child):
                proot = self._bunch_root(current)
                slot = self._leaf_range(current)[0]
                leaf = self._leaf_bits(self._word(proot), slot)
                if not (leaf & (COAL_LEFT >> (child & 1))):
                    return  # branch re-used/re-released concurrently (U8)
                new_leaf = leaf & ~((OCC_LEFT | COAL_LEFT) >> (child & 1))
                self._rmw_leaf(current, lambda v: new_leaf)
                occ_buddy = (new_leaf & (OCC_RIGHT << (child & 1))) != 0
            else:
                occ_buddy = self._derived_busy(child ^ 1)
            if not (level_of(current) > upper_bound and not occ_buddy):
                return

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def allocated_ranges(self) -> List[range]:
        """Occupied address coverage at bunch-leaf granularity.

        A single allocation of an interior bunch node appears as its run
        of leaf-slot ranges (the bits cannot distinguish "parent
        occupied" from "both children occupied" — paper Fig. 6 makes
        them semantically identical), so this is an exact *coverage* set
        rather than a per-allocation list.
        """
        out = []
        for root, word in self.words.items():
            sb = self._stored_level(root)
            size = self.size_of_level(sb)
            n_slots = 1 << (sb - level_of(root))
            for s in range(n_slots):
                if self._leaf_bits(word, s) & OCC:
                    node = (root << (sb - level_of(root))) + s
                    addr = self.starting_address(node)
                    out.append(range(addr, addr + size))
        return out

    def free_bytes(self) -> int:
        return self.total_memory - sum(len(r) for r in self.allocated_ranges())
