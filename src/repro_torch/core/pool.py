"""Sharded allocator pool: S replicated wavefront trees behind one API.

Counterpart of `repro/core/pool.py:81-513` (without the fastpath slab
and the magazines, which come with a later slice).  The pool is one
`int32[S, n_state_words]` stack of tree state words in either layout of
`core/layout.py`; the rounds of `core/concurrent.py` already take that
stack, so the JAX package's `jax.vmap` over shards is the leading axis
here.

Routing: every requester lane has a home shard (Fibonacci hash of its
lane id, computed in exact uint32 arithmetic), lanes whose shard is
exhausted at their level re-route to the next shard in the fixed cyclic
probe order between rounds, and a lane fails after probing all S
shards.  Releases carry their serving shard.

These functions are the plain version of the pooled step: their round
loop tests `pending.any()` on the host.  On the card the engine runs
`pool_wavefront_step` as one kernel launch (`kernels/nbbs_alloc.py`),
which is bit-identical to this module.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.bits import FIB_HASH
from repro_torch.core.concurrent import I32, TreeConfig, alloc_rounds, free_rounds
from repro_torch.obs.schema import POOL_STEP_SLOTS, spec as metric_spec

_FIB_LO = FIB_HASH & 0xFFFF
_FIB_HI = FIB_HASH >> 16
_U32 = 0xFFFFFFFF


def _named(stats: dict) -> dict:
    """Every stats key must be a registered metric (obs/schema.py)."""
    for name in stats:
        metric_spec(name)
    return stats


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static geometry of the sharded pool: S replicas of one tree."""

    tree: TreeConfig
    n_shards: int = 1

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")

    @property
    def n_words(self) -> int:
        return self.tree.n_words

    @property
    def n_state_words(self) -> int:
        return self.tree.n_state_words

    @property
    def total_units(self) -> int:
        return self.n_shards << self.tree.depth

    def empty_trees(self, device="cuda") -> torch.Tensor:
        return torch.zeros(
            (self.n_shards, self.n_state_words), dtype=I32, device=device
        )


def home_shard(pcfg: PoolConfig, lane_ids: torch.Tensor) -> torch.Tensor:
    """Deterministic home shard of each lane: (uint32(id) * FIB_HASH mod
    2^32) mod S.  The product is split in 16-bit halves so it stays
    exact in int64 for every 32-bit id."""
    x = lane_ids.to(torch.int64) & _U32
    h = (x * _FIB_LO + (((x * _FIB_HI) & 0xFFFF) << 16)) & _U32
    return (h % pcfg.n_shards).to(I32)


def probe_shard(pcfg: PoolConfig, home, attempt):
    """Shard probed on the given overflow attempt (fixed cyclic order)."""
    return (home + attempt) % pcfg.n_shards


def _lane_mask(pcfg: PoolConfig, shard: torch.Tensor) -> torch.Tensor:
    sh_ids = torch.arange(pcfg.n_shards, dtype=I32, device=shard.device)
    return shard[None, :] == sh_ids[:, None]  # [S, K]


def pool_alloc_round(pcfg, trees, levels, pending, shard, attempt, nodes):
    """One pool arbitration round: `alloc_round` on every shard (each
    lane on the shard it is routed to), then lanes whose shard is
    exhausted at their level move to the next shard.

    Returns (trees, nodes, pending, shard, attempt, merged, logical,
    won, fp_hits)."""
    S = pcfg.n_shards
    K = levels.shape[0]
    sh_pending = pending[None, :] & _lane_mask(pcfg, shard)
    zeros = torch.zeros((S, K), dtype=I32, device=trees.device)
    trees, nodes_s, pending_s, merged_s, logical_s, won_s = alloc_rounds(
        pcfg.tree, trees, levels, sh_pending, zeros
    )
    won = won_s.any(dim=0)   # a lane is pending on exactly one shard
    won_node = (nodes_s * won_s).sum(dim=0, dtype=I32)
    nodes = torch.where(won, won_node, nodes)
    # still pending after its shard's round = lost arbitration; pending
    # lanes that vanished without winning exhausted the shard
    pend_after = pending_s.any(dim=0)
    exhausted = pending & ~won & ~pend_after
    attempt = attempt + exhausted.to(I32)
    give_up = exhausted & (attempt >= S)
    shard = torch.where(exhausted & ~give_up, (shard + 1) % S, shard)
    pending = pending & ~won & ~give_up
    zero = torch.zeros((), dtype=I32, device=trees.device)
    return (
        trees, nodes, pending, shard, attempt,
        merged_s.sum(dtype=I32), logical_s.sum(dtype=I32), won, zero,
    )


def pool_wavefront_alloc(
    pcfg: PoolConfig, trees, levels, active, max_rounds: int = 64, lane_ids=None
):
    """Allocate a wavefront of requests across the pool.

    Returns (trees, nodes, shard, ok, stats): nodes int32[K] (0 where
    failed/inactive), shard int32[K] the serving shard, ok bool[K];
    stats 'rounds', 'merged_writes', 'logical_rmws', 'overflows' and the
    zero 'fastpath_hits'/'fastpath_spills'."""
    dev = trees.device
    K = levels.shape[0]
    if lane_ids is None:
        lane_ids = torch.arange(K, dtype=I32, device=dev)
    home = home_shard(pcfg, lane_ids)
    nodes = torch.zeros(K, dtype=I32, device=dev)
    pending = active.to(torch.bool).clone()
    shard, attempt = home.clone(), torch.zeros(K, dtype=I32, device=dev)
    rounds = 0
    merged = torch.zeros((), dtype=I32, device=dev)
    logical = torch.zeros((), dtype=I32, device=dev)
    while rounds < max_rounds and bool(pending.any()):
        trees, nodes, pending, shard, attempt, m, l, _, _ = pool_alloc_round(
            pcfg, trees, levels, pending, shard, attempt, nodes
        )
        rounds += 1
        merged, logical = merged + m, logical + l
    ok = nodes > 0
    zero = torch.zeros((), dtype=I32, device=dev)
    stats = _named({
        "rounds": torch.full((), rounds, dtype=I32, device=dev),
        "merged_writes": merged,
        "logical_rmws": logical,
        "overflows": (ok & (shard != home)).sum(dtype=I32),
        "fastpath_hits": zero,
        "fastpath_spills": zero,
    })
    return trees, nodes, shard, ok, stats


def pool_free_round(pcfg: PoolConfig, trees, nodes, shard, active):
    """Release a multi-shard burst: one merged `free_round` per shard,
    each handle on the shard it records.  Returns (trees,
    merged_writes, logical_rmws, freed)."""
    sh_active = active.to(torch.bool)[None, :] & _lane_mask(pcfg, shard.to(I32))
    trees, merged_s, logical_s, freed_s = free_rounds(
        pcfg.tree, trees, nodes, sh_active
    )
    return (
        trees, merged_s.sum(dtype=I32), logical_s.sum(dtype=I32),
        freed_s.any(dim=0),
    )


def pool_free_units(pcfg: PoolConfig, trees) -> torch.Tensor:
    """Free leaf units per shard, int32[S]: a leaf is free iff it is
    allocatable (word zero and no reserved ancestor)."""
    cfg = pcfg.tree
    lo = 1 << cfg.depth
    alloc = cfg.layout.allocatable(cfg, trees)
    return alloc[:, lo : 2 * lo].sum(dim=1, dtype=I32)


def pool_largest_run(pcfg: PoolConfig, trees) -> torch.Tensor:
    """Largest allocatable run (in units) across all shards, int32."""
    cfg = pcfg.tree
    alloc = cfg.layout.allocatable(cfg, trees)
    best = torch.zeros(trees.shape[0], dtype=I32, device=trees.device)
    for lev in range(cfg.depth, cfg.max_level - 1, -1):
        lo, hi = 1 << lev, 1 << (lev + 1)
        has = alloc[:, lo:hi].any(dim=1)
        best = torch.where(has, 1 << (cfg.depth - lev), best).to(I32)
    return best.max()


def pool_wavefront_free(pcfg: PoolConfig, trees, nodes, shard, active):
    """Pool release.  Returns (trees, freed, stats)."""
    trees, merged, logical, freed = pool_free_round(
        pcfg, trees, nodes, shard, active
    )
    return trees, freed, _named({"merged_writes": merged, "logical_rmws": logical})


def pool_wavefront_step(
    pcfg: PoolConfig,
    trees,
    free_nodes,
    free_shard,
    free_active,
    alloc_levels,
    alloc_active,
    max_rounds: int = 64,
    lane_ids=None,
) -> Tuple:
    """One pool scheduler round: the per-shard merged release first,
    then the pool allocation wavefront with overflow probing.

    Returns (trees, nodes, shard, ok, stats)."""
    trees, free_merged, free_logical, freed = pool_free_round(
        pcfg, trees, free_nodes, free_shard, free_active
    )
    trees, nodes, shard, ok, stats = pool_wavefront_alloc(
        pcfg, trees, alloc_levels, alloc_active, max_rounds, lane_ids
    )
    zero = torch.zeros((), dtype=I32, device=trees.device)
    stats = dict(stats)
    stats["free_writes"] = free_merged
    stats["free_merged_writes"] = free_merged
    stats["free_logical_rmws"] = free_logical
    stats["freed"] = freed.sum(dtype=I32)
    stats["magazine_hits"] = zero
    stats["magazine_spills"] = zero
    stats["magazine_refills"] = zero
    missing = set(POOL_STEP_SLOTS) - set(stats)
    if missing:  # pragma: no cover - drift guard
        raise KeyError(f"pool step stats missing schema slots {missing}")
    return trees, nodes, shard, ok, _named(stats)
