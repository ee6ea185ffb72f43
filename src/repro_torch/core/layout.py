"""Tree state layouts of the port: `Unpacked` and `BunchPacked`.

Counterpart of `repro/core/layout.py`.  The wavefront rounds of
`core/concurrent.py` scan a per-node *allocatable* predicate, arbitrate
in node-index space, and hand winner/freed node masks back to the layout
to commit.  Node indices are layout-independent: tree[0] is unused, the
root is 1 and the children of n are 2n and 2n+1.

  * `Unpacked`: one int32 status word per node, node n at index n.
  * `BunchPacked`: the paper's §III-D packing, B=3 tree levels per
    word, the bunch's 4 leaf slots x 5 status bits in the low 20 bits
    (slot s at bits 5s..5s+4).  Only bunch leaves are stored; a node's
    state is derived from its leaf range (occ = AND of the slots' OCC,
    busy/any = OR).  Layers are bottom-aligned (the partial layer is at
    the top), stored top layer first, each layer's words keyed by bunch
    root minus the level base (`_bunch_layers`).

The JAX package keeps packed words as uint32.  PyTorch has almost no CPU
kernels for `torch.uint32` (shifts, comparisons, `where` and
`index_put_` raise), so the port keeps them as **int32 with the same
bits**: a word uses 20 of its 32 bits and the sign bit is never set, so
every value, comparison and merged-write count is the same.  Tests
compare the two through int64.

Stale-handle caveat, copied as it is: packed bits cannot tell "n
allocated" from "both children of n allocated separately", so a junk
free of n in the latter state is dropped by `Unpacked` (its word lacks
OCC) but releases both children under `BunchPacked` (derived OCC holds).
On valid traces the two layouts give identical nodes.

Every pass here works on a *stack* of trees, `int32[S, n_state_words]`,
one row per pool shard: the JAX package lifts its single-tree passes to
the pool with `jax.vmap`, and the port writes that batch axis out.  A
single tree is the S=1 case (`core/concurrent.py` adds and removes the
axis).  Node masks are `bool[S, 2^(depth+1)]`; per-tree counters come
back as `int32[S]`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.core.bits import (
    BUSY,
    COAL_LEFT,
    COAL_RIGHT,
    OCC,
    OCC_LEFT,
    OCC_RIGHT,
    STATUS_BITS,
    STATUS_MASK,
)

I32 = torch.int32


def _level_of(n: torch.Tensor, max_level: int = 31) -> torch.Tensor:
    """Tree level of node index n >= 1: floor(log2(n)) in exact integer
    arithmetic (the count of powers 2^k, k = 1..max_level, that are <= n).
    `max_level` bounds the answer; nodes of a depth-d tree need d."""
    lev = torch.zeros_like(n, dtype=I32)
    for k in range(1, max_level + 1):
        lev += (n >= (1 << k)).to(I32)
    return lev


@functools.lru_cache(maxsize=None)
def _bunch_layers(depth: int, bunch_levels: int) -> Tuple[Tuple[int, int, int], ...]:
    """Static bunch layering, bottom-aligned: tuple of
    (root_level, leaf_level, word_offset), top layer first.  Layer k
    covers tree levels [root_level, leaf_level]; its words are keyed by
    bunch-root node index and stored contiguously from word_offset."""
    spans = []
    leaf = depth
    while leaf >= 0:
        root = max(leaf - (bunch_levels - 1), 0)
        spans.append((root, leaf))
        leaf = root - 1
    spans.reverse()  # top-first
    layers = []
    off = 0
    for root, leaf in spans:
        layers.append((root, leaf, off))
        off += 1 << root
    return tuple(layers)


def _ancestor_occ_from(depth: int, occ: torch.Tensor) -> torch.Tensor:
    """anc[s, n] is True iff some strict ancestor of n is OCC (one
    top-down pass over per-node occupancy booleans, paper T11)."""
    anc = torch.zeros_like(occ)
    for lev in range(1, depth + 1):
        lo, hi = 1 << lev, 1 << (lev + 1)
        p = anc[:, lo // 2 : hi // 2] | occ[:, lo // 2 : hi // 2]
        anc[:, lo:hi] = p.repeat_interleave(2, dim=1)
    return anc


def _where_i32(cond: torch.Tensor, a: int, b: int = 0) -> torch.Tensor:
    """int32 select between two Python constants."""
    return torch.where(cond, a, b).to(I32)


@dataclasses.dataclass(frozen=True)
class Unpacked:
    """One int32 status word per tree node (index = node index)."""

    name = "unpacked"

    def n_state_words(self, cfg) -> int:
        return 1 << (cfg.depth + 1)

    @property
    def state_dtype(self):
        return I32

    def empty_tree(self, cfg, device="cuda") -> torch.Tensor:
        return torch.zeros(self.n_state_words(cfg), dtype=I32, device=device)

    # -- derived views -------------------------------------------------
    def allocatable(self, cfg, tree: torch.Tensor) -> torch.Tensor:
        """CAS(0 -> BUSY) needs the word to be exactly zero (paper T2)
        and no fully-occupied ancestor may exist (paper T11)."""
        occ = (tree & OCC) != 0
        anc = _ancestor_occ_from(cfg.depth, occ)
        return (tree == 0) & ~anc

    def node_occ_at(self, cfg, tree: torch.Tensor, nodes: torch.Tensor):
        """OCC of `nodes[s, k]` in tree row s."""
        return (torch.gather(tree, 1, nodes.long()) & OCC) != 0

    # -- merged alloc commit (paper T2 + T6-T18, all winners at once) --
    def commit_allocs(self, cfg, tree: torch.Tensor, win_mask: torch.Tensor):
        """Write BUSY into every winner's word, then one merged
        bottom-up climb.  Returns (tree, merged_writes int32[S])."""
        S = tree.shape[0]
        tree = torch.where(win_mask, BUSY, tree).to(I32)
        marked = win_mask.clone()
        merged = win_mask.sum(dim=1, dtype=I32)
        for lev in range(cfg.depth, cfg.max_level, -1):
            lo, hi = 1 << lev, 1 << (lev + 1)
            pair = marked[:, lo:hi].reshape(S, -1, 2)
            left_m, right_m = pair[..., 0], pair[..., 1]
            or_mask = _where_i32(left_m, OCC_LEFT) | _where_i32(right_m, OCC_RIGHT)
            clear_mask = _where_i32(left_m, COAL_LEFT) | _where_i32(
                right_m, COAL_RIGHT
            )
            plo, phi = lo // 2, hi // 2
            tree[:, plo:phi] = (tree[:, plo:phi] | or_mask) & ~clear_mask
            touched = left_m | right_m
            marked[:, plo:phi] |= touched
            merged += touched.sum(dim=1, dtype=I32)
        return tree, merged

    # -- merged release (batch FREENODE + UNMARK) ----------------------
    def apply_frees(self, cfg, tree: torch.Tensor, freed_mask: torch.Tensor):
        """Clear every released word at once (F19), then one bottom-up
        sweep re-deriving branch occupancy along touched paths.
        Returns (tree, merged_writes int32[S])."""
        S = tree.shape[0]
        merged = freed_mask.sum(dim=1, dtype=I32)
        tree = torch.where(freed_mask, 0, tree).to(I32)
        sub_occ = (tree & OCC) != 0
        touched = freed_mask.clone()
        for lev in range(cfg.depth - 1, cfg.max_level - 1, -1):
            lo, hi = 1 << lev, 1 << (lev + 1)
            c_occ = sub_occ[:, 2 * lo : 2 * hi].reshape(S, -1, 2)
            c_tch = touched[:, 2 * lo : 2 * hi].reshape(S, -1, 2)
            any_tch = c_tch[..., 0] | c_tch[..., 1]
            pv = tree[:, lo:hi].clone()
            derived = _where_i32(c_occ[..., 0], OCC_LEFT) | _where_i32(
                c_occ[..., 1], OCC_RIGHT
            )
            own_occ = (pv & OCC) != 0
            nv = torch.where(any_tch & ~own_occ, derived, pv)
            tree[:, lo:hi] = nv
            merged += (nv != pv).sum(dim=1, dtype=I32)
            sub_occ[:, lo:hi] = own_occ | c_occ[..., 0] | c_occ[..., 1]
            # OR, not overwrite: an interior freed node has untouched
            # children but must still propagate its release upward.
            touched[:, lo:hi] |= any_tch
        return tree, merged

    # -- the paper's per-operation RMW cost model (Fig. 7) -------------
    def alloc_logical_rmws(self, cfg, win: torch.Tensor, levels: torch.Tensor):
        """One CAS for the node word plus one per climbed level."""
        climb = torch.where(win, levels - cfg.max_level, 0)
        return win.sum(dim=1, dtype=I32) + climb.sum(dim=1, dtype=I32)

    def free_logical_rmws(self, cfg, tree, tgt, valid):
        """2*climb + 1 per free, against the pre-round tree: the FREENODE
        climb CASes one word per level until the first ancestor whose
        buddy branch is occupied, UNMARK re-CASes the same segment, plus
        the one plain write of F19."""
        ub = cfg.max_level
        cur = torch.where(valid, tgt, 1).to(I32)
        lev = _level_of(cur, cfg.depth)
        climb = torch.zeros_like(cur)
        stopped = ~valid
        for _ in range(cfg.depth - ub):
            in_climb = ~stopped & (lev > ub)
            parent = cur >> 1
            pv = torch.gather(tree, 1, parent.long())
            climb += in_climb.to(I32)
            buddy_bit = torch.where((cur & 1) == 1, OCC_LEFT, OCC_RIGHT)
            buddy_occ = (pv & buddy_bit) != 0
            stopped = stopped | ~in_climb | buddy_occ
            cur = parent
            lev = lev - 1
        return torch.where(valid, 2 * climb + 1, 0).sum(dim=1, dtype=I32)


def _slot_word(mask: torch.Tensor, value: int, shifts: torch.Tensor) -> torch.Tensor:
    """Pack a per-slot bool mask [S, n_roots, n_slots] into int32 words
    holding `value` in every masked slot."""
    return (_where_i32(mask, value) << shifts).sum(dim=2, dtype=I32)


@dataclasses.dataclass(frozen=True)
class BunchPacked:
    """Packed-bunch layout (§III-D, 32-bit variant): B tree levels per
    int32 word, only bunch leaves stored (5 bits per leaf slot),
    interior state derived within the word.

    The derived views are per-node boolean scratch in node-index space,
    recomputed per round; only the packed words are persistent state,
    and only they are charged by the merged-write counters."""

    bunch_levels: int = 3
    word_bits: int = 32

    name = "bunch-packed"

    def __post_init__(self):
        leaves = 1 << (self.bunch_levels - 1)
        if leaves * STATUS_BITS > self.word_bits:
            raise ValueError(
                f"bunch of {self.bunch_levels} levels needs "
                f"{leaves * STATUS_BITS} bits > word size {self.word_bits}"
            )

    def layers(self, cfg) -> Tuple[Tuple[int, int, int], ...]:
        return _bunch_layers(cfg.depth, self.bunch_levels)

    def n_state_words(self, cfg) -> int:
        root, _, off = self.layers(cfg)[-1]
        return off + (1 << root)

    @property
    def state_dtype(self):
        return I32

    def empty_tree(self, cfg, device="cuda") -> torch.Tensor:
        return torch.zeros(self.n_state_words(cfg), dtype=I32, device=device)

    @staticmethod
    def _shifts(n_slots: int, device) -> torch.Tensor:
        return torch.arange(n_slots, dtype=I32, device=device) * STATUS_BITS

    # -- derived per-node views (Fig. 6 within each word) --------------
    def _slot_status(self, cfg, state: torch.Tensor, layer) -> torch.Tensor:
        """int32[S, 2^leaf_level] leaf-slot statuses of one layer in
        node order (slot s of root r is node (r << (F-L)) + s)."""
        L, F, off = layer
        n_roots, n_slots = 1 << L, 1 << (F - L)
        words = state[:, off : off + n_roots]
        slots = (words[:, :, None] >> self._shifts(n_slots, state.device)) & STATUS_MASK
        return slots.reshape(state.shape[0], -1)

    def derive(self, cfg, state: torch.Tensor):
        """(any5, occ, busy) bool[S, n_words]: some status bit in the
        node's leaf range (the packed analogue of word != 0), the AND of
        the range's OCC bits, the OR of its busy bits."""
        S = state.shape[0]
        shape = (S, cfg.n_words)
        any5 = torch.zeros(shape, dtype=torch.bool, device=state.device)
        occ = torch.zeros_like(any5)
        busy = torch.zeros_like(any5)
        for layer in self.layers(cfg):
            L, F, _ = layer
            st = self._slot_status(cfg, state, layer)
            a, o, b = st != 0, (st & OCC) != 0, (st & BUSY) != 0
            for lev in range(F, L - 1, -1):
                lo, hi = 1 << lev, 1 << (lev + 1)
                any5[:, lo:hi], occ[:, lo:hi], busy[:, lo:hi] = a, o, b
                if lev > L:
                    a = a.reshape(S, -1, 2).any(dim=2)
                    o = o.reshape(S, -1, 2).all(dim=2)
                    b = b.reshape(S, -1, 2).any(dim=2)
        return any5, occ, busy

    def allocatable(self, cfg, state: torch.Tensor) -> torch.Tensor:
        """Derived T2+T11: the node's leaf range is bit-free and no
        (derived-)occupied strict ancestor exists."""
        any5, occ, _ = self.derive(cfg, state)
        return ~any5 & ~_ancestor_occ_from(cfg.depth, occ)

    def node_occ_at(self, cfg, state: torch.Tensor, nodes: torch.Tensor):
        """Derived OCC of `nodes[s, k]` in tree row s."""
        _, occ, _ = self.derive(cfg, state)
        return torch.gather(occ, 1, nodes.long())

    def _in_layer(self, mask: torch.Tensor, L: int, F: int) -> torch.Tensor:
        """[S, 2^F]: some masked node at-or-above each leaf slot of the
        layer, within the layer (levels L..F)."""
        m = mask[:, 1 << L : 1 << (L + 1)]
        for lev in range(L + 1, F + 1):
            m = m.repeat_interleave(2, dim=1) | mask[:, 1 << lev : 1 << (lev + 1)]
        return m

    # -- merged alloc commit: range CAS + cross-word climb, per word ---
    def commit_allocs(self, cfg, state: torch.Tensor, win_mask: torch.Tensor):
        """All winners at once: each word ORs in BUSY over the leaf
        ranges of winners inside its bunch and OCC_LEFT/OCC_RIGHT cross
        marks on leaf slots whose child bunches hold a winner.  Returns
        (state, merged_writes int32[S]); merged_writes counts packed
        words whose value changed."""
        S, depth = state.shape[0], cfg.depth
        swin = win_mask.clone()  # a winner in subtree(n), n included
        for lev in range(depth - 1, -1, -1):
            lo, hi = 1 << lev, 1 << (lev + 1)
            child = swin[:, 2 * lo : 2 * hi].reshape(S, -1, 2)
            swin[:, lo:hi] |= child[..., 0] | child[..., 1]
        out = state.clone()
        merged = torch.zeros(S, dtype=I32, device=state.device)
        for L, F, off in self.layers(cfg):
            n_roots, n_slots = 1 << L, 1 << (F - L)
            shifts = self._shifts(n_slots, state.device)
            cl = self._in_layer(win_mask, L, F).reshape(S, n_roots, n_slots)
            word_or = _slot_word(cl, BUSY, shifts)
            if F < depth:
                sub = swin[:, 1 << (F + 1) : 1 << (F + 2)].reshape(S, n_roots, n_slots, 2)
                word_or |= _slot_word(sub[..., 0], OCC_LEFT, shifts)
                word_or |= _slot_word(sub[..., 1], OCC_RIGHT, shifts)
            old = state[:, off : off + n_roots]
            new = old | word_or
            merged += (new != old).sum(dim=1, dtype=I32)
            out[:, off : off + n_roots] = new
        return out, merged

    # -- merged release: clear ranges, rebuild the canonical words -----
    def apply_frees(self, cfg, state: torch.Tensor, freed_mask: torch.Tensor):
        """Clear every freed node's leaf range, then one bottom-up sweep
        over layers rebuilding each word from its surviving leaf
        occupancy and, at bunch roots, its child bunches' occupancy as
        OCC_LEFT/OCC_RIGHT marks.  Returns (state, merged_writes
        int32[S]), merged_writes counting packed words changed."""
        S, depth = state.shape[0], cfg.depth
        out = state.clone()
        merged = torch.zeros(S, dtype=I32, device=state.device)
        bocc = None  # child-layer bunch occupancy, keyed by bunch root
        for layer in reversed(self.layers(cfg)):
            L, F, off = layer
            n_roots, n_slots = 1 << L, 1 << (F - L)
            shifts = self._shifts(n_slots, state.device)
            st = self._slot_status(cfg, state, layer)
            in_occ = ((st & OCC) != 0) & ~self._in_layer(freed_mask, L, F)
            in_occ = in_occ.reshape(S, n_roots, n_slots)
            word = _slot_word(in_occ, BUSY, shifts)
            slot_busy = in_occ
            if F < depth:
                sub = bocc.reshape(S, n_roots, n_slots, 2)
                word |= _slot_word(sub[..., 0], OCC_LEFT, shifts)
                word |= _slot_word(sub[..., 1], OCC_RIGHT, shifts)
                slot_busy = slot_busy | sub[..., 0] | sub[..., 1]
            old = state[:, off : off + n_roots]
            merged += (word != old).sum(dim=1, dtype=I32)
            out[:, off : off + n_roots] = word
            bocc = slot_busy.any(dim=2)
        return out, merged

    # -- §III-D word-RMW cost model: one RMW per bunch, not per level --
    def _root_levels(self, cfg):
        return sorted({L for (L, _, _) in self.layers(cfg)})

    def _crosses_of(self, cfg, levels: torch.Tensor) -> torch.Tensor:
        """Count of bunch-root levels in (max_level, level]: the
        cross-word RMWs of a run-alone climb from that level."""
        crosses = torch.zeros_like(levels, dtype=I32)
        for r in self._root_levels(cfg):
            if cfg.max_level < r:
                crosses += (levels >= r).to(I32)
        return crosses

    def _is_root_level(self, cfg, levels: torch.Tensor) -> torch.Tensor:
        hit = torch.zeros_like(levels, dtype=torch.bool)
        for r in self._root_levels(cfg):
            hit |= levels == r
        return hit

    def alloc_logical_rmws(self, cfg, win: torch.Tensor, levels: torch.Tensor):
        """One range CAS in the node's own word plus one cross-leaf RMW
        per ancestor bunch."""
        cost = 1 + self._crosses_of(cfg, levels.clamp(0, cfg.depth))
        return torch.where(win, cost, 0).sum(dim=1, dtype=I32)

    def free_logical_rmws(self, cfg, state, tgt, valid):
        """2*cross_climb + 1 per free, against the pre-round state: the
        FREENODE walk decides at every level (derived busy of the buddy)
        but RMWs only where it crosses a bunch root; UNMARK re-walks the
        same segment; plus the one range-clear word op."""
        _, _, busy = self.derive(cfg, state)
        ub = cfg.max_level
        cur = torch.where(valid, tgt, 1).to(I32)
        climb = torch.zeros_like(cur)
        stopped = ~valid
        for _ in range(cfg.depth - ub):
            lev = _level_of(cur, cfg.depth)
            in_climb = ~stopped & (lev > ub)
            climb += (in_climb & self._is_root_level(cfg, lev)).to(I32)
            buddy = torch.where(cur > 1, cur ^ 1, 0)
            buddy_occ = torch.gather(busy, 1, buddy.long())
            stopped = stopped | ~in_climb | buddy_occ
            cur = cur >> 1
        return torch.where(valid, 2 * climb + 1, 0).sum(dim=1, dtype=I32)


# The two layout instances: default (oracle) and packed.
UNPACKED = Unpacked()
BUNCH_PACKED = BunchPacked()

TreeLayout = Unpacked | BunchPacked
