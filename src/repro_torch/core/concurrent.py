"""Wavefront non-blocking buddy system: rounds over a stack of trees.

Counterpart of `repro/core/concurrent.py`.  The rounds follow the JAX
ones line for line; see that module for the algorithm (rank matching per
level, min-id arbitration over the tree, merged climbs, merged release).

Each round here takes a stack of trees `int32[S, n_words]` with
per-tree lane masks `[S, K]` and returns per-tree counters `int32[S]`:
that is the batch axis `core/pool.py` of the JAX package adds with
`jax.vmap`.  The single-tree entry points (`alloc_round`, `free_round`,
`wavefront_alloc`, `wavefront_free`, `wavefront_step`) take one tree and
run the S=1 case.

Arbitration primitives: the owner-id `.at[].min` scatters become
`scatter_reduce_(..., "amin", include_self=True)`, and
`searchsorted(side="left")` becomes `searchsorted(right=False)`.

Both layouts of `core/layout.py` run through these rounds: they go
through `cfg.layout` for the allocatable predicate, the merged commit,
the release and the logical counts.

The round loops here test `pending.any()` on the host, so they are the
plain versions.  On the card the same steps run as one kernel launch
each (`kernels/nbbs_alloc.py`): `ops.nbbs_wavefront_alloc` launches
kernel 4, `ops.nbbs_wavefront_step` kernel 3 and
`ops.nbbs_pool_wavefront_step` kernel A; the single-op API of
`core/nbbs.py` and the engine go through them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bits import COAL_LEFT, COAL_RIGHT, OCC_LEFT, OCC_RIGHT
from repro_torch.core.layout import (  # noqa: F401  (re-exported API)
    BUNCH_PACKED,
    UNPACKED,
    BunchPacked,
    TreeLayout,
    Unpacked,
    _level_of,
)

I32 = torch.int32
INF = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Static geometry of the allocator tree (+ its state layout)."""

    depth: int          # leaves are at this level; units = 2**depth
    max_level: int = 0  # largest allocatable block lives at this level
    layout: TreeLayout = UNPACKED

    @property
    def n_words(self) -> int:
        """Node-index space: 2^(depth+1)."""
        return 1 << (self.depth + 1)

    @property
    def n_state_words(self) -> int:
        return self.layout.n_state_words(self)

    @property
    def state_dtype(self):
        return self.layout.state_dtype

    def empty_tree(self, device="cuda") -> torch.Tensor:
        return self.layout.empty_tree(self, device)


def _min_id_fields(cfg: TreeConfig, own: torch.Tensor):
    """(desc_min, anc_min) [S, n_words]: min request id over strict
    descendants / strict ancestors of every node, given per-node
    tentative owner ids."""
    S = own.shape[0]
    desc = torch.full_like(own, INF)
    for lev in range(cfg.depth - 1, -1, -1):
        lo, hi = 1 << lev, 1 << (lev + 1)
        m = torch.minimum(own[:, 2 * lo : 2 * hi], desc[:, 2 * lo : 2 * hi])
        desc[:, lo:hi] = m.reshape(S, -1, 2).amin(dim=2)
    ancm = torch.full_like(own, INF)
    for lev in range(1, cfg.depth + 1):
        lo, hi = 1 << lev, 1 << (lev + 1)
        p = torch.minimum(ancm[:, lo // 2 : hi // 2], own[:, lo // 2 : hi // 2])
        ancm[:, lo:hi] = p.repeat_interleave(2, dim=1)
    return desc, ancm


# ---------------------------------------------------------------------------
# Wavefront allocation
# ---------------------------------------------------------------------------


def alloc_rounds(
    cfg: TreeConfig,
    trees: torch.Tensor,    # int32[S, n_words]
    levels: torch.Tensor,   # int32[K], shared by every tree
    pending: torch.Tensor,  # bool[S, K]
    nodes: torch.Tensor,    # int32[S, K]
):
    """One arbitration round on every tree of the stack.

    Returns (trees, nodes, pending, merged_writes[S], logical_rmws[S],
    won[S, K])."""
    layout = cfg.layout
    S, N = trees.shape[0], cfg.n_words
    K = levels.shape[0]
    dev = trees.device
    ids = torch.arange(K, dtype=I32, device=dev).expand(S, K)
    levels = levels.to(I32)

    allocatable = layout.allocatable(cfg, trees)

    target = torch.zeros((S, K), dtype=I32, device=dev)
    got = torch.zeros((S, K), dtype=torch.bool, device=dev)
    exhausted = torch.zeros((S, K), dtype=torch.bool, device=dev)
    for lev in range(cfg.max_level, cfg.depth + 1):
        lo, hi = 1 << lev, 1 << (lev + 1)
        avail = allocatable[:, lo:hi]
        cnt = avail.sum(dim=1, dtype=I32)[:, None]
        req = pending & (levels == lev)[None, :]
        rank = torch.cumsum(req.to(I32), dim=1, dtype=I32) - 1
        csum = torch.cumsum(avail.to(I32), dim=1, dtype=I32)
        node_of_rank = (
            torch.searchsorted(csum, rank + 1, right=False).to(I32) + lo
        )
        sel = req & (rank < cnt)
        target = torch.where(sel, node_of_rank, target)
        got = got | sel
        exhausted = exhausted | (req & (cnt == 0))

    # --- arbitration: min request id wins on overlap ----------------
    tgt = torch.where(got, target, 0).long()
    own = torch.full((S, N), INF, dtype=I32, device=dev)
    own.scatter_reduce_(1, tgt, torch.where(got, ids, INF), "amin", include_self=True)
    desc, ancm = _min_id_fields(cfg, own)
    tl = target.long()
    win = got & (ids < torch.gather(desc, 1, tl)) & (ids < torch.gather(ancm, 1, tl))

    # --- commit winners + merged climb ------------------------------
    win_mask = torch.zeros((S, N), dtype=torch.int8, device=dev)
    win_mask.scatter_(1, torch.where(win, target, 0).long(), win.to(torch.int8))
    win_mask[:, 0] = 0
    trees, merged = layout.commit_allocs(cfg, trees, win_mask != 0)

    nodes = torch.where(win, target, nodes)
    logical = layout.alloc_logical_rmws(cfg, win, levels[None, :].expand(S, K))
    pending = pending & ~win & ~exhausted
    return trees, nodes, pending, merged, logical, win


def alloc_round(cfg, tree, levels, pending, nodes):
    """Single-tree round: (tree, nodes, pending, merged, logical, won)."""
    t, n, p, m, l, w = alloc_rounds(
        cfg, tree[None], levels, pending[None], nodes[None]
    )
    return t[0], n[0], p[0], m[0], l[0], w[0]


def wavefront_alloc(cfg, tree, levels, active, max_rounds: int = 64):
    """Allocate a wavefront of requests on one tree.

    Returns (tree, nodes, ok, stats) with stats 'rounds',
    'merged_writes', 'logical_rmws' (0-d int32 tensors)."""
    dev = tree.device
    K = levels.shape[0]
    nodes = torch.zeros(K, dtype=I32, device=dev)
    pending = active.clone()
    rounds = 0
    merged = torch.zeros((), dtype=I32, device=dev)
    logical = torch.zeros((), dtype=I32, device=dev)
    while rounds < max_rounds and bool(pending.any()):
        tree, nodes, pending, m, l, _ = alloc_round(cfg, tree, levels, pending, nodes)
        rounds += 1
        merged, logical = merged + m, logical + l
    stats = {
        "rounds": torch.tensor(rounds, dtype=I32, device=dev),
        "merged_writes": merged,
        "logical_rmws": logical,
    }
    return tree, nodes, nodes > 0, stats


# ---------------------------------------------------------------------------
# Faithful sequential release (FREENODE + UNMARK, one node at a time)
# ---------------------------------------------------------------------------


def _free_one(cfg: TreeConfig, tree: list, n: int) -> int:
    """Release node `n` (paper Algorithms 3-4) in `tree`, a list of the
    tree's words, in place.  Returns the words written."""
    ub = cfg.max_level
    # -- phase 1: coalescing marks bottom-up --------------------------------
    current, runner, writes = n >> 1, n, 0
    while runner.bit_length() - 1 > ub:
        old = tree[current]
        tree[current] = old | (COAL_LEFT >> (runner & 1))
        writes += 1
        occ_buddy = (old & (OCC_RIGHT << (runner & 1))) != 0
        coal_buddy = (old & (COAL_RIGHT << (runner & 1))) != 0
        if occ_buddy and not coal_buddy:
            break
        runner, current = current, current >> 1
    # -- phase 2: plain write, release the node (F19) ------------------------
    tree[n] = 0
    writes += 1
    # -- phase 3: UNMARK (do-while) ------------------------------------------
    if n.bit_length() - 1 == ub:
        return writes
    current = n
    while True:
        child, current = current, current >> 1
        cv = tree[current]
        if not cv & (COAL_LEFT >> (child & 1)):
            return writes
        nv = cv & ~((OCC_LEFT | COAL_LEFT) >> (child & 1))
        tree[current] = nv
        writes += 1
        occ_buddy = (nv & (OCC_RIGHT << (child & 1))) != 0
        if not (current.bit_length() - 1 > ub and not occ_buddy):
            return writes


def free_batch_sequential(cfg: TreeConfig, tree: torch.Tensor, nodes: torch.Tensor,
                          active: torch.Tensor):
    """Release a batch of nodes one at a time, in lane order (faithful
    FREENODE/UNMARK scan; one legal linearization), on the host: the
    differential oracle of `free_round`.  Lanes that are inactive or name
    node 0 do nothing.  Returns (tree int32, writes int32 0-d).

    Unpacked-only: the scan replays the paper's per-word bit protocol,
    which has no meaning on packed state words."""
    if not isinstance(cfg.layout, Unpacked):
        raise ValueError(
            "free_batch_sequential requires the Unpacked layout; "
            f"got {cfg.layout!r} (use free_round / wavefront_free)"
        )
    words = tree.tolist()
    writes = 0
    for node, act in zip(nodes.tolist(), active.tolist()):
        if act and node > 0:
            writes += _free_one(cfg, words, node)
    return (torch.tensor(words, dtype=I32, device=tree.device),
            torch.tensor(writes, dtype=I32, device=tree.device))


# ---------------------------------------------------------------------------
# Merged vectorized release (free-side wavefront)
# ---------------------------------------------------------------------------


def free_rounds(
    cfg: TreeConfig,
    trees: torch.Tensor,   # int32[S, n_words]
    nodes: torch.Tensor,   # int32[K], shared by every tree
    active: torch.Tensor,  # bool[S, K]
):
    """One merged release pass on every tree of the stack.

    Validity (in range, word has OCC), min-lane dedup of duplicate
    handles, the per-free logical RMWs against the pre-round tree, then
    the layout's merged release.  Returns (trees, merged_writes[S],
    logical_rmws[S], freed[S, K])."""
    layout = cfg.layout
    S, N = trees.shape[0], cfg.n_words
    K = nodes.shape[0]
    dev = trees.device
    nodes = nodes.to(I32)
    safe = nodes.clamp(0, N - 1)[None, :].expand(S, K)
    # out-of-range ids are junk handles, not aliases of the last leaf
    in_range = ((nodes > 0) & (nodes < N))[None, :]
    valid = active & in_range & layout.node_occ_at(cfg, trees, safe)
    tgt = torch.where(valid, safe, 0)
    # duplicate handles within one batch: min lane id wins
    ids = torch.arange(K, dtype=I32, device=dev).expand(S, K)
    own = torch.full((S, N), INF, dtype=I32, device=dev)
    own.scatter_reduce_(
        1, tgt.long(), torch.where(valid, ids, INF), "amin", include_self=True
    )
    valid = valid & (torch.gather(own, 1, tgt.long()) == ids)
    tgt = torch.where(valid, tgt, 0)

    logical = layout.free_logical_rmws(cfg, trees, tgt, valid)

    freed = torch.zeros((S, N), dtype=torch.int8, device=dev)
    freed.scatter_(1, tgt.long(), valid.to(torch.int8))
    freed[:, 0] = 0
    trees, merged = layout.apply_frees(cfg, trees, freed != 0)
    return trees, merged, logical, valid


def free_round(cfg, tree, nodes, active):
    """Single-tree release: (tree, merged_writes, logical_rmws, freed)."""
    t, m, l, f = free_rounds(cfg, tree[None], nodes, active[None])
    return t[0], m[0], l[0], f[0]


def wavefront_free(cfg, tree, nodes, active):
    """Release a wavefront of nodes in one merged O(depth) pass.
    Returns (tree, freed, stats)."""
    tree, merged, logical, freed = free_round(cfg, tree, nodes, active)
    return tree, freed, {"merged_writes": merged, "logical_rmws": logical}


def free_batch(cfg, tree, nodes, active):
    """Release a batch through the merged pass; returns (tree,
    merged_writes), the historical signature."""
    tree, merged, _, _ = free_round(cfg, tree, nodes, active)
    return tree, merged


def wavefront_step(
    cfg, tree, free_nodes, free_active, alloc_levels, alloc_active,
    max_rounds: int = 64,
):
    """One scheduler round: the merged release first, then the alloc
    wavefront.  Returns (tree, nodes, ok, stats)."""
    tree, free_merged, free_logical, freed = free_round(
        cfg, tree, free_nodes, free_active
    )
    tree, nodes, ok, stats = wavefront_alloc(
        cfg, tree, alloc_levels, alloc_active, max_rounds
    )
    stats = dict(stats)
    stats["free_writes"] = free_merged
    stats["free_merged_writes"] = free_merged
    stats["free_logical_rmws"] = free_logical
    stats["freed"] = freed.sum(dtype=I32)
    return tree, nodes, ok, stats


def levels_from_sizes(cfg: TreeConfig, total_memory: int, sizes: torch.Tensor):
    """Paper rule A5: level = floor(log2(total/size)), clamped."""
    sizes = sizes.to(torch.int64).clamp(min=1)
    ratio = (total_memory // sizes).clamp(min=1)
    return _level_of(ratio).clamp(0, cfg.depth).to(I32)
