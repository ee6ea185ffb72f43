"""The allocator's in-graph API: single ops on one tree, on the pool,
and the leaf-page calls of the serving engine.

Counterpart of `repro/core/nbbs_jax.py:75-379`.  `AllocState` carries
the paper's two arrays, tree[] (the layout's state words) and index[]
(unit offset -> serving node), as tensors on one device; the calls
update them with no host sync, so they can sit inside a serving step.

  * `nb_alloc` / `nb_alloc_size` are K=1 wavefronts through
    `kernels.ops.nbbs_wavefront_alloc` (kernel 4 on the card);
  * `nb_free` / `nb_free_batch` are one merged release through kernel
    3's release half (`kernels.nbbs_alloc.wavefront_free`);
  * `nb_pool_alloc` / `nb_pool_free_batch` do the same on the sharded
    pool through kernel A (`ops.nbbs_pool_wavefront_step`,
    `nbbs_alloc.pool_free`);
  * `nb_pool_alloc_pages` / `nb_pool_free_pages` are the engine's
    leaf-page calls.  Every allocation is one leaf unit (one KV page), so
    a page handle is the pair (shard, unit offset), the serving node of
    offset o is always the leaf 2^depth + o, and no index[] is needed;
  * `nb_pool_alloc_pages_mag` / `nb_pool_free_pages_mag` put the per-lane
    magazines in front of them (`ops.nbbs_pool_wavefront_step(mags=)`
    on the card: the magazine ops around kernel A).

With `pcfg.fastpath` the pool's trees are the carved ones of
`PoolConfig.empty_trees`, and every call above runs the slab phase (in
kernel A on the card): handles are path-agnostic, a slab page is the
same leaf node.

On CPU tensors every call runs the plain rounds of `core/`.  index[]
keeps its stale entries after a release, exactly like the paper's
NBFREE: a re-free through a stale entry lands on a word without
(derived) OCC and is dropped by the release's validity mask.  Levels and
unit offsets come from integer arithmetic (`_level_of`), never from a
float log2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.concurrent import I32, TreeConfig, _level_of, levels_from_sizes
from repro_torch.core.magazine import MagazineState
from repro_torch.core.pool import PoolConfig, _mag_stash_phase
from repro_torch.kernels import nbbs_alloc
from repro_torch.kernels.ops import nbbs_pool_wavefront_step, nbbs_wavefront_alloc


class AllocState(NamedTuple):
    tree: torch.Tensor   # cfg.layout state words
    index: torch.Tensor  # int32[units] node that served each unit offset


def init_state(cfg: TreeConfig, device="cuda") -> AllocState:
    return AllocState(
        tree=cfg.empty_tree(device),
        index=torch.zeros(1 << cfg.depth, dtype=I32, device=device),
    )


def _node_to_unit_offset(cfg: TreeConfig, node: torch.Tensor) -> torch.Tensor:
    """Unit offset of a node's chunk: (n - 2^level) * 2^(depth-level);
    node 0 (no allocation) gives -2^depth, as in JAX."""
    node = node.to(I32)
    level = _level_of(node.clamp(min=1), cfg.depth)
    one = torch.ones_like(level)
    return (node - (one << level)) << (cfg.depth - level)


def _one(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).reshape(1).to(I32)


def nb_alloc(cfg: TreeConfig, state: AllocState, level):
    """Allocate one chunk at `level`.  Returns (state, unit_offset, ok)."""
    dev = state.tree.device
    tree, nodes, ok, _ = nbbs_wavefront_alloc(
        cfg, state.tree, _one(level, dev),
        active=torch.ones(1, dtype=torch.bool, device=dev),
    )
    node, ok = nodes[0], ok[0]
    off = _node_to_unit_offset(cfg, node)
    slot = torch.where(ok, off, 0).long().reshape(1)
    index = torch.where(ok, state.index.scatter(0, slot, node.reshape(1)), state.index)
    return AllocState(tree, index), off, ok


def nb_free(cfg: TreeConfig, state: AllocState, unit_offset) -> AllocState:
    """Release the chunk previously allocated at `unit_offset`."""
    dev = state.tree.device
    state, _ = nb_free_batch(
        cfg, state, _one(unit_offset, dev), torch.ones(1, dtype=torch.bool, device=dev)
    )
    return state


def nb_free_batch(cfg: TreeConfig, state: AllocState, unit_offsets, active):
    """Release a burst of chunks in one merged pass.  Returns (state,
    freed bool[K]); double frees and junk offsets are dropped."""
    unit_offsets = unit_offsets.to(I32)
    # out-of-range offsets are invalid handles, not aliases of unit 0
    in_range = (unit_offsets >= 0) & (unit_offsets < (1 << cfg.depth))
    nodes = state.index[torch.where(in_range, unit_offsets, 0).long()]
    tree, freed, _ = nbbs_alloc.wavefront_free(
        cfg, state.tree, nodes, active.to(torch.bool) & in_range
    )
    return AllocState(tree, state.index), freed


def nb_alloc_size(cfg: TreeConfig, state: AllocState, total_memory: int, size):
    """Size-based convenience (paper NBALLOC API, rule A5)."""
    level = levels_from_sizes(cfg, total_memory, _one(size, state.tree.device))[0]
    return nb_alloc(cfg, state, level)


# ---------------------------------------------------------------------------
# Sharded pool API (S replicated trees, each with its own index[])
# ---------------------------------------------------------------------------


class PoolAllocState(NamedTuple):
    trees: torch.Tensor  # [S, n_state_words] stacked layout state words
    index: torch.Tensor  # int32[S, units] per-shard unit offset -> node


def init_pool_state(pcfg: PoolConfig, device="cuda") -> PoolAllocState:
    return PoolAllocState(
        trees=pcfg.empty_trees(device),
        index=torch.zeros((pcfg.n_shards, 1 << pcfg.tree.depth), dtype=I32, device=device),
    )


def nb_pool_alloc(pcfg: PoolConfig, state: PoolAllocState, level, lane_id=0):
    """Allocate one chunk at `level` from the pool, homed by the hash of
    `lane_id`.  Returns (state, shard, unit_offset, ok)."""
    dev = state.trees.device
    none = torch.zeros(0, dtype=I32, device=dev)
    trees, nodes, shard, ok, _ = nbbs_pool_wavefront_step(
        pcfg, state.trees, none, none, none, _one(level, dev),
        lane_ids=_one(lane_id, dev), active=torch.ones(1, dtype=torch.bool, device=dev),
    )
    node, s, ok = nodes[0], shard[0], ok[0]
    off = _node_to_unit_offset(pcfg.tree, node)
    where = (s.long().reshape(1), torch.where(ok, off, 0).long().reshape(1))
    index = torch.where(ok, state.index.index_put(where, node.reshape(1)), state.index)
    return PoolAllocState(trees, index), s, off, ok


def nb_pool_free_batch(pcfg: PoolConfig, state: PoolAllocState, shards, unit_offsets,
                       active):
    """Release a burst of pool handles in one merged pass per shard.
    Returns (state, freed bool[K]); stale or junk handles are dropped."""
    shards, unit_offsets = shards.to(I32), unit_offsets.to(I32)
    in_range = (
        (unit_offsets >= 0)
        & (unit_offsets < (1 << pcfg.tree.depth))
        & (shards >= 0)
        & (shards < pcfg.n_shards)
    )
    sh = torch.where(in_range, shards, 0)
    nodes = state.index[sh.long(), torch.where(in_range, unit_offsets, 0).long()]
    trees, freed, _ = nbbs_alloc.pool_free(
        pcfg, state.trees, nodes, sh, active.to(torch.bool) & in_range
    )
    return PoolAllocState(trees, state.index), freed


# ---------------------------------------------------------------------------
# Leaf-page API (index[]-free; the serving engine)
# ---------------------------------------------------------------------------


def nb_pool_alloc_pages(
    pcfg: PoolConfig,
    trees: torch.Tensor,
    active: torch.Tensor,
    lane_ids: torch.Tensor,
    max_rounds: int = 64,
):
    """Allocate one leaf unit per active lane, routed by the home-shard
    hash of `lane_ids` with cyclic overflow probing.

    Returns (trees, shard int32[K], unit_offset int32[K] (-1 where
    failed), ok bool[K], stats)."""
    K = active.shape[0]
    dev = trees.device
    depth = pcfg.tree.depth
    levels = torch.full((K,), depth, dtype=I32, device=dev)
    none = torch.zeros(0, dtype=I32, device=dev)
    trees, nodes, shard, ok, stats = nbbs_pool_wavefront_step(
        pcfg, trees, none, none, none, levels,
        lane_ids=lane_ids.to(I32), active=active, max_rounds=max_rounds,
    )
    off = torch.where(ok, nodes - (1 << depth), -1).to(I32)
    return trees, shard, off, ok, stats


def nb_pool_free_pages(
    pcfg: PoolConfig,
    trees: torch.Tensor,
    shards: torch.Tensor,
    unit_offsets: torch.Tensor,
    active: torch.Tensor,
):
    """Release a burst of leaf-unit page handles in one merged pass per
    shard.  Offsets or shards outside the pool geometry are masked here;
    a stale in-range handle whose leaf lacks OCC is dropped by the
    release's validity mask.  Returns (trees, freed bool[K], stats) with
    `free_merged_writes`, `free_logical_rmws` and `freed`."""
    nodes, sh, act = _page_nodes(pcfg, shards, unit_offsets, active)
    return nbbs_alloc.pool_free(pcfg, trees, nodes, sh, act)


def _page_nodes(pcfg: PoolConfig, shards, unit_offsets, active):
    """(nodes, shards, active) of leaf page handles; offsets or shards
    outside the pool geometry are masked out."""
    depth = pcfg.tree.depth
    shards, unit_offsets = shards.to(I32), unit_offsets.to(I32)
    in_range = (
        (unit_offsets >= 0)
        & (unit_offsets < (1 << depth))
        & (shards >= 0)
        & (shards < pcfg.n_shards)
    )
    nodes = torch.where(in_range, (1 << depth) + unit_offsets, 0).to(I32)
    sh = torch.where(in_range, shards, 0).to(I32)
    return nodes, sh, active.to(torch.bool) & in_range


def nb_pool_alloc_pages_mag(
    pcfg: PoolConfig,
    trees: torch.Tensor,
    mags: MagazineState,
    active: torch.Tensor,
    lane_ids: torch.Tensor,
    max_rounds: int = 64,
    mag_lane: torch.Tensor | None = None,
    mag_rank: torch.Tensor | None = None,
):
    """`nb_pool_alloc_pages` with the per-lane magazines in front: each
    active lane first pops its own magazine (`mag_lane`, -1 = none),
    the misses take the slab/tree wavefront, and an exhaustion spills
    every stashed page back and retries (`pool_wavefront_alloc_mag`).
    `mag_rank` skips the claim's sort (all zeros when every lane has its
    own magazine).  Returns (trees, mags, shard, unit_offset, ok, stats)."""
    K = active.shape[0]
    dev = trees.device
    depth = pcfg.tree.depth
    levels = torch.full((K,), depth, dtype=I32, device=dev)
    none = torch.zeros(0, dtype=I32, device=dev)
    trees, mags, nodes, shard, ok, stats = nbbs_pool_wavefront_step(
        pcfg, trees, none, none, none, levels, lane_ids=lane_ids.to(I32),
        active=active, max_rounds=max_rounds, mags=mags,
        alloc_mag_lane=None if mag_lane is None else mag_lane.to(I32),
        alloc_mag_rank=mag_rank,
    )
    off = torch.where(ok, nodes - (1 << depth), -1).to(I32)
    return trees, mags, shard, off, ok, stats


def nb_pool_free_pages_mag(
    pcfg: PoolConfig,
    trees: torch.Tensor,
    mags: MagazineState,
    shards: torch.Tensor,
    unit_offsets: torch.Tensor,
    active: torch.Tensor,
    mag_lane: torch.Tensor | None = None,
    mag_rank: torch.Tensor | None = None,
    assume_owned: bool = False,
):
    """`nb_pool_free_pages` with the magazine stash in front: valid leaf
    handles of lanes with a magazine stash there (the page stays
    allocated until a claim or a spill), the rest take the merged
    release (kernel A's release half on the card).  `mag_rank` and
    `assume_owned` are the stash fast paths (`core.pool._mag_stash_phase`).
    Returns (trees, mags, freed bool[K], stats) with `free_merged_writes`,
    `free_logical_rmws`, `freed` and the stash drop-throughs
    `magazine_spills`."""
    nodes, sh, act = _page_nodes(pcfg, shards, unit_offsets, active)
    if mag_lane is None:
        mag_lane = torch.full((nodes.shape[0],), -1, dtype=I32, device=trees.device)
    mags, act2, stashed, spills = _mag_stash_phase(
        pcfg, trees, mags, nodes, sh, act, mag_lane,
        mag_rank=mag_rank, assume_owned=assume_owned,
    )
    trees, freed, stats = nbbs_alloc.pool_free(pcfg, trees, nodes, sh, act2)
    stats = dict(stats)
    stats["freed"] = stats["freed"] + stashed.sum(dtype=I32)
    stats["magazine_spills"] = spills
    return trees, mags, freed | stashed, stats
