"""Paper-faithful sequential oracle of the non-blocking buddy system.

Counterpart of `repro/core/ref.py`, copied line for line: plain Python
on ints, host code, never tensorized.  `tests/test_torch_host_alloc.py`
holds addresses, tree words and every stat equal to the original's.

This is a line-by-line transcription of Algorithms 1-4 of the paper
(NBALLOC / TRYALLOC / NBFREE / FREENODE / UNMARK) into pure Python, with
the CAS primitive factored out so that word-update ("RMW") counts can be
instrumented exactly as the paper reasons about them (§III-D: the number
of RMW instructions on the critical path is the optimization target).

It serves three roles:

  1. The *correctness oracle* for every other implementation in this
     port (the single-op API, the wavefront rounds, packed bunches, the
     CUDA kernels) — tests replay identical request traces and
     require identical allocation outcomes.
  2. The *host-side allocator* of the serving engine: the continuous
     batching scheduler runs on the host and allocates KV-cache pages
     from this allocator (a Python list of words, O(levels) per op).
  3. The faithful single-thread baseline of the paper's benchmarks.

Two pseudo-code typos in the paper are corrected here (both are obvious
from the surrounding prose and from the published C implementation at
github.com/HPDCS/NBBS):

  * Alg. 1 lines A9-A10 scan ``[2^(level-1), 2^level - 1]`` which is the
    range of ``level-1``; §III-A's text gives the correct range
    ``n ∈ [2^level, 2^(level+1) - 1]`` — we use the latter.
  * Alg. 3 line F5 computes the branch selector from ``current`` (the
    parent); the bit being set is the coalescing bit *of the branch that
    contains `runner`* (the child), so the selector must be
    ``mod2(runner)``.  Line F16 ``runner <- actual`` reads
    ``runner <- current``.  Line F20 compares an index against a level;
    the guard is ``level(n) != upper_bound``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core import bits
from repro_torch.core.bits import (
    BUSY,
    COAL_LEFT,
    OCC,
    clean_coal,
    is_coal,
    is_coal_buddy,
    is_free,
    is_occ_buddy,
    level_of,
    mark,
    mod2,
    unmark,
)


def _ilog2(x: int) -> int:
    """floor(log2(x)) for positive ints."""
    return x.bit_length() - 1


@dataclasses.dataclass
class NBBSStats:
    """Instrumentation mirroring the paper's cost model."""

    cas_attempts: int = 0       # every RMW issued (incl. failed retries)
    cas_failures: int = 0       # RMWs that observed a changed word
    plain_writes: int = 0       # non-RMW writes (F19: tree[n] <- 0)
    allocs_ok: int = 0
    allocs_failed: int = 0      # NBALLOC returned NULL
    frees: int = 0
    level_scan_steps: int = 0   # nodes inspected during level scans

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class NBBSRef:
    """Sequential reference implementation of the non-blocking buddy system.

    Parameters mirror the paper's notation: the allocator manages
    ``total_memory`` bytes starting at ``base_address``; leaves are
    allocation units of ``min_size`` bytes; no single request may exceed
    ``max_size`` (the level of which is ``max_level``).
    """

    def __init__(
        self,
        total_memory: int,
        min_size: int,
        max_size: Optional[int] = None,
        base_address: int = 0,
    ) -> None:
        if max_size is None:
            max_size = total_memory
        if total_memory & (total_memory - 1):
            raise ValueError("total_memory must be a power of two")
        if min_size & (min_size - 1) or min_size > total_memory:
            raise ValueError("min_size must be a power of two <= total_memory")
        if max_size & (max_size - 1) or max_size > total_memory:
            raise ValueError("max_size must be a power of two <= total_memory")
        self.total_memory = total_memory
        self.min_size = min_size
        self.max_size = max_size
        self.base_address = base_address
        self.depth = _ilog2(total_memory // min_size)
        self.max_level = _ilog2(total_memory // max_size)
        # tree[0] unused; root at index 1 (paper Fig. 2).
        self.tree: List[int] = [0] * (1 << (self.depth + 1))
        # index[] maps allocation-unit offset -> node index of the serving
        # allocation (paper §III-A).
        self.index: List[int] = [0] * (total_memory // min_size)
        self.stats = NBBSStats()
        # Scattered scan hint (paper: "not necessarily such a search has to
        # start from the first node at that level").
        self._scan_hint: dict[int, int] = {}

    # ------------------------------------------------------------------
    # CAS primitive.  Sequential => always succeeds when expected matches.
    # Factored out so subclasses / harnesses can instrument or perturb it.
    # ------------------------------------------------------------------
    def _cas(self, idx: int, expected: int, new: int) -> bool:
        self.stats.cas_attempts += 1
        if self.tree[idx] != expected:
            self.stats.cas_failures += 1
            return False
        self.tree[idx] = new
        return True

    # -- helpers --------------------------------------------------------
    def level_for_size(self, size: int) -> int:
        """Paper rule 1 / line A5: floor(log2(total/size)), clamped to depth.

        floor on the *ratio* rounds non-power-of-two sizes up to the next
        block size (e.g. size=3 in a 1024-byte tree lands at the 4-byte
        level, not the 2-byte level).
        """
        level = _ilog2(self.total_memory // size) if size else self.depth
        return min(level, self.depth)

    def size_of_level(self, level: int) -> int:
        return self.total_memory >> level

    def starting_address(self, n: int) -> int:
        """Paper eq. (3)."""
        level = level_of(n)
        size = self.size_of_level(level)
        return self.base_address + (n - (1 << level)) * size

    def node_for_address(self, addr: int) -> int:
        return self.index[(addr - self.base_address) // self.min_size]

    # ------------------------------------------------------------------
    # Algorithm 1 — NBALLOC
    # ------------------------------------------------------------------
    def nb_alloc(self, size: int, scattered: bool = False) -> Optional[int]:
        if size > self.max_size or size < 0:
            self.stats.allocs_failed += 1
            return None
        if size == 0:
            size = 1
        level = self.level_for_size(size)
        base = 1 << level
        n_nodes = 1 << level
        start = self._scan_hint.get(level, 0) if scattered else 0
        # Scan the level (wrapping once when scattered) looking for a free
        # node; skip whole sub-trees on TRYALLOC failure (lines A18-A19).
        scanned = 0
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
            self.stats.level_scan_steps += 1
            scanned += 1
            if is_free(self.tree[i]):
                failed_at = self._try_alloc(i)
                if not failed_at:
                    addr = self.starting_address(i)
                    self.index[(addr - self.base_address) // self.min_size] = i
                    self.stats.allocs_ok += 1
                    if scattered:
                        self._scan_hint[level] = (i + 1 - base) % n_nodes
                    return addr
                # Skip the whole sub-tree of the ancestor that failed us.
                d = 1 << (level - level_of(failed_at))
                i = (failed_at + 1) * d
                continue
            i += 1
        self.stats.allocs_failed += 1
        return None

    # ------------------------------------------------------------------
    # Algorithm 2 — TRYALLOC
    # ------------------------------------------------------------------
    def _try_alloc(self, n: int) -> int:
        """Returns 0 on success, else the node index that failed us."""
        if not self._cas(n, 0, BUSY):
            return n
        current = n
        while level_of(current) > self.max_level:
            child = current
            current >>= 1
            while True:
                curr_val = self.tree[current]
                if curr_val & OCC:
                    # An ancestor is fully reserved: roll back our marks.
                    self._free_node(n, level_of(child))
                    return current
                new_val = clean_coal(curr_val, child)
                new_val = mark(new_val, child)
                if self._cas(current, curr_val, new_val):
                    break
        return 0

    # ------------------------------------------------------------------
    # Algorithm 3 — NBFREE / FREENODE
    # ------------------------------------------------------------------
    def nb_free(self, addr: int) -> None:
        n = self.index[(addr - self.base_address) // self.min_size]
        self._free_node(n, self.max_level)
        self.stats.frees += 1

    def nb_free_many(self, addrs) -> None:
        """Release a burst of allocations in one call (the release-side
        batch API; this host oracle linearizes, device allocators process
        the whole burst in one merged `free_round` pass)."""
        for addr in addrs:
            self.nb_free(addr)

    def _free_node(self, n: int, upper_bound: int) -> None:
        # -- phase 1: mark the path as coalescing, bottom-up ------------
        current = n >> 1
        runner = n
        while level_of(runner) > upper_bound:
            or_val = COAL_LEFT >> mod2(runner)
            while True:
                cur_val = self.tree[current]
                new_val = cur_val | or_val
                if self._cas(current, cur_val, new_val):
                    old_val = cur_val
                    break
            if is_occ_buddy(old_val, runner) and not is_coal_buddy(old_val, runner):
                # The buddy sub-tree holds live allocations: the climb can
                # stop, chunks above cannot coalesce (paper Fig. 4).
                break
            runner = current
            current >>= 1
        # -- phase 2: release the node itself (plain write, line F19) ---
        self.tree[n] = 0
        self.stats.plain_writes += 1
        # -- phase 3: propagate the release towards the upper bound -----
        if level_of(n) != upper_bound:
            self._unmark(n, upper_bound)

    # ------------------------------------------------------------------
    # Algorithm 4 — UNMARK
    # ------------------------------------------------------------------
    def _unmark(self, n: int, upper_bound: int) -> None:
        current = n
        while True:
            child = current
            current >>= 1
            while True:
                curr_val = self.tree[current]
                if not is_coal(curr_val, child):
                    # A concurrent operation re-used / re-released the
                    # branch: our responsibility ends here.
                    return
                new_val = unmark(curr_val, child)
                if self._cas(current, curr_val, new_val):
                    break
            if not (
                level_of(current) > upper_bound
                and not is_occ_buddy(new_val, child)
            ):
                return

    # ------------------------------------------------------------------
    # Introspection helpers (used by tests / the serving engine)
    # ------------------------------------------------------------------
    def allocated_ranges(self) -> List[range]:
        """All currently reserved [start, end) address ranges (OCC nodes)."""
        out = []
        for n in range(1, len(self.tree)):
            if self.tree[n] & OCC:
                start = self.starting_address(n)
                out.append(range(start, start + self.size_of_level(level_of(n))))
        return out

    def free_bytes(self) -> int:
        occupied = sum(
            self.size_of_level(level_of(n))
            for n in range(1, len(self.tree))
            if self.tree[n] & OCC
        )
        return self.total_memory - occupied

    def check_invariants(self) -> None:
        """Structural sanity: status bits consistent with sub-tree state.

        In quiescent state (no in-flight ops) the paper's derivation rules
        (Fig. 6) must hold: a node's left/right occupancy bit is set iff
        its corresponding child sub-tree contains a reserved node, and no
        coalescing bits remain.
        """
        for n in range(1, 1 << self.depth):
            val = self.tree[n]
            left, right = 2 * n, 2 * n + 1
            left_busy = (self.tree[left] & BUSY) != 0
            right_busy = (self.tree[right] & BUSY) != 0
            if val & OCC:
                continue  # fully reserved: children state is not reflected
            has_left = (val & bits.OCC_LEFT) != 0
            has_right = (val & bits.OCC_RIGHT) != 0
            if has_left != left_busy or has_right != right_busy:
                raise AssertionError(
                    f"node {n}: bits {val:#x} inconsistent with children "
                    f"{self.tree[left]:#x}/{self.tree[right]:#x}"
                )
            if val & (bits.COAL_LEFT | bits.COAL_RIGHT):
                raise AssertionError(f"node {n}: stale coalescing bits {val:#x}")
