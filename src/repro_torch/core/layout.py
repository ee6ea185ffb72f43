"""Tree state layout of the port: one int32 word per node (`Unpacked`).

Counterpart of `repro/core/layout.py:79-238`.  Node n's 5-bit status
word lives at index n; tree[0] is unused, the root is 1 and the
children of n are 2n and 2n+1.

Every pass here works on a *stack* of trees, `int32[S, 2^(depth+1)]`,
one row per pool shard: the JAX package lifts its single-tree passes to
the pool with `jax.vmap`, and the port writes that batch axis out.  A
single tree is the S=1 case (`core/concurrent.py` adds and removes the
axis).  Per-tree counters come back as `int32[S]`.

`BunchPacked` is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bits import (
    BUSY,
    COAL_LEFT,
    COAL_RIGHT,
    OCC,
    OCC_LEFT,
    OCC_RIGHT,
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


UNPACKED = Unpacked()

TreeLayout = Unpacked
