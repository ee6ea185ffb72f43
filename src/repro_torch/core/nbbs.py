"""Leaf-page pool API of the jit-resident serving engine.

Counterpart of `repro/core/nbbs_jax.py:225-295` (`nb_pool_alloc_pages`,
`nb_pool_free_pages`).  Every allocation is one leaf unit (one KV page),
so a page handle is the pair (shard, unit offset) and the serving node
of offset o is always the leaf 2^depth + o: no index[] is needed.

Both calls run the pooled step: an alloc burst through
`kernels.ops.nbbs_pool_wavefront_step` with no active frees, which gives
exactly what `pool_wavefront_alloc` gives alone, and a free burst through
its release half alone (`kernels.nbbs_alloc.pool_free`), which gives
what `pool_free_round` gives and which handles it applied.  On the card
that is one kernel launch each; on the CPU it is the plain router.
"""

from __future__ import annotations

import torch

from repro_torch.core.concurrent import I32
from repro_torch.core.pool import PoolConfig
from repro_torch.kernels import nbbs_alloc
from repro_torch.kernels.ops import nbbs_pool_wavefront_step


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
    depth = pcfg.tree.depth
    shards = shards.to(I32)
    unit_offsets = unit_offsets.to(I32)
    in_range = (
        (unit_offsets >= 0)
        & (unit_offsets < (1 << depth))
        & (shards >= 0)
        & (shards < pcfg.n_shards)
    )
    nodes = torch.where(in_range, (1 << depth) + unit_offsets, 0).to(I32)
    sh = torch.where(in_range, shards, 0).to(I32)
    return nbbs_alloc.pool_free(pcfg, trees, nodes, sh, active & in_range)
