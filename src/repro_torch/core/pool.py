"""Sharded allocator pool: S replicated wavefront trees behind one API.

Counterpart of `repro/core/pool.py`.  The pool is one
`int32[S, n_state_words]` stack of tree state words in either layout of
`core/layout.py`; the rounds of `core/concurrent.py` already take that
stack, so the JAX package's `jax.vmap` over shards is the leading axis
here.

Routing: every requester lane has a home shard (Fibonacci hash of its
lane id, computed in exact uint32 arithmetic), lanes whose shard is
exhausted at their level re-route to the next shard in the fixed cyclic
probe order between rounds, and a lane fails after probing all S
shards.  Releases carry their serving shard.

Front ends (the JAX module's two halves):

  * `fastpath` (`core/fastpath.py`): the leftmost `slab_level` subtree
    of every shard is carved out for a bitmap slab of fast-octave
    blocks, whose words are appended to the shard's row.  In every
    round, lanes pending at the fast octave first claim from their
    current shard's slab; releases route by node range (slab, carved
    junk dropped, tree).
  * `magazines` (`core/magazine.py`): the `*_mag` entry points thread a
    `MagazineState`; freed leaf pages stash lane-locally and leaf
    allocations pop them first, with one merged spill-back and a retry
    when an allocation would otherwise fail.

These functions are the plain versions of the pooled step: their round
loops test `pending.any()` on the host.  On the card the engine runs the
same steps through kernel A (`kernels/nbbs_alloc.py`, slab phase
included) and the magazine path of `kernels/ops.py`, bit-identical to
this module.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import fastpath as fpmod
from repro_torch.core import magazine as magmod
from repro_torch.core.bits import FIB_HASH
from repro_torch.core.concurrent import I32, INF, TreeConfig, alloc_rounds, free_rounds
from repro_torch.core.fastpath import FastPathConfig
from repro_torch.core.magazine import MagazineConfig, MagazineState
from repro_torch.obs.schema import POOL_STEP_SLOTS, spec as metric_spec

_FIB_LO = FIB_HASH & 0xFFFF
_FIB_HI = FIB_HASH >> 16
_U32 = 0xFFFFFFFF


def _named(stats: dict) -> dict:
    """Every stats key must be a registered metric (obs/schema.py)."""
    for name in stats:
        metric_spec(name)
    return stats


def _check_slots(stats: dict) -> dict:
    missing = set(POOL_STEP_SLOTS) - set(stats)
    if missing:  # pragma: no cover - drift guard
        raise KeyError(f"pool step stats missing schema slots {missing}")
    return _named(stats)


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static geometry of the sharded pool: S replicas of one tree, with
    an optional fastpath slab (appended to each shard's row) and an
    optional magazine layer (its state lives beside the trees)."""

    tree: TreeConfig
    n_shards: int = 1
    fastpath: FastPathConfig | None = None
    magazines: MagazineConfig | None = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.fastpath is not None:
            self.fastpath.validate(self.tree)
        if self.magazines is not None:
            self.magazines.validate()

    @property
    def n_words(self) -> int:
        return self.tree.n_words

    @property
    def fp_state_words(self) -> int:
        """Slab bitmap words per shard (0 without a fastpath)."""
        if self.fastpath is None:
            return 0
        return fpmod.fp_state_words(self.tree, self.fastpath)

    @property
    def n_state_words(self) -> int:
        """Layout state words plus the appended slab words."""
        return self.tree.n_state_words + self.fp_state_words

    @property
    def total_units(self) -> int:
        return self.n_shards << self.tree.depth

    def empty_trees(self, device="cuda") -> torch.Tensor:
        if self.fastpath is None:
            return torch.zeros(
                (self.n_shards, self.n_state_words), dtype=I32, device=device
            )
        tree = fpmod.carved_empty_tree(self.tree, self.fastpath, device)
        row = torch.cat([tree, torch.zeros(self.fp_state_words, dtype=I32, device=device)])
        return row[None, :].repeat(self.n_shards, 1)


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


def _fast_total(pcfg: PoolConfig, levels, active) -> torch.Tensor:
    """Active lanes at the fast octave (0 without a fastpath)."""
    if pcfg.fastpath is None:
        return torch.zeros((), dtype=I32, device=levels.device)
    fast = levels == fpmod.fp_level(pcfg.tree, pcfg.fastpath)
    return (active & fast).sum(dtype=I32)


# ---------------------------------------------------------------------------
# Pool rounds
# ---------------------------------------------------------------------------


def pool_alloc_round(pcfg, trees, levels, pending, shard, attempt, nodes):
    """One pool arbitration round: with a fastpath, lanes pending at the
    fast octave first claim from their current shard's slab; then
    `alloc_round` on every shard (each lane on the shard it is routed
    to), and lanes whose shard is exhausted at their level move to the
    next shard.

    Returns (trees, nodes, pending, shard, attempt, merged, logical,
    won, fp_hits)."""
    S = pcfg.n_shards
    K = levels.shape[0]
    fp = pcfg.fastpath
    dev = trees.device
    TW = pcfg.tree.n_state_words
    lane_mask = _lane_mask(pcfg, shard)
    zero = torch.zeros((), dtype=I32, device=dev)
    fp_hits, fp_merged = zero, zero
    got_fp = torch.zeros(K, dtype=torch.bool, device=dev)
    tree_part, slab_part = trees[:, :TW], trees[:, TW:]
    if fp is not None:
        eligible = pending & (levels == fpmod.fp_level(pcfg.tree, fp))
        slab_part, nodes_fp_s, got_s, merged_fp_s, hits_s = fpmod.slab_claims(
            pcfg.tree, fp, slab_part, eligible[None, :] & lane_mask
        )
        got_fp = got_s.any(dim=0)
        nodes = torch.where(got_fp, (nodes_fp_s * got_s).sum(dim=0, dtype=I32), nodes)
        pending = pending & ~got_fp
        fp_hits = hits_s.sum(dtype=I32)
        fp_merged = merged_fp_s.sum(dtype=I32)
    sh_pending = pending[None, :] & lane_mask
    zeros = torch.zeros((S, K), dtype=I32, device=dev)
    tree_part, nodes_s, pending_s, merged_s, logical_s, won_s = alloc_rounds(
        pcfg.tree, tree_part, levels, sh_pending, zeros
    )
    trees = torch.cat([tree_part, slab_part], dim=1) if fp is not None else tree_part
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
    return (
        trees, nodes, pending, shard, attempt,
        merged_s.sum(dtype=I32) + fp_merged, logical_s.sum(dtype=I32) + fp_hits,
        won | got_fp, fp_hits,
    )


def pool_wavefront_alloc(
    pcfg: PoolConfig, trees, levels, active, max_rounds: int = 64, lane_ids=None
):
    """Allocate a wavefront of requests across the pool.

    Returns (trees, nodes, shard, ok, stats): nodes int32[K] (0 where
    failed/inactive), shard int32[K] the serving shard, ok bool[K];
    stats 'rounds', 'merged_writes', 'logical_rmws', 'overflows',
    'fastpath_hits' and 'fastpath_spills' (fast-octave lanes served by
    the slab and not; both zero without a fastpath)."""
    dev = trees.device
    K = levels.shape[0]
    if lane_ids is None:
        lane_ids = torch.arange(K, dtype=I32, device=dev)
    home = home_shard(pcfg, lane_ids)
    active = active.to(torch.bool)
    nodes = torch.zeros(K, dtype=I32, device=dev)
    pending = active.clone()
    shard, attempt = home.clone(), torch.zeros(K, dtype=I32, device=dev)
    rounds = 0
    merged = torch.zeros((), dtype=I32, device=dev)
    logical = torch.zeros((), dtype=I32, device=dev)
    hits = torch.zeros((), dtype=I32, device=dev)
    while rounds < max_rounds and bool(pending.any()):
        trees, nodes, pending, shard, attempt, m, l, _, h = pool_alloc_round(
            pcfg, trees, levels, pending, shard, attempt, nodes
        )
        rounds += 1
        merged, logical, hits = merged + m, logical + l, hits + h
    ok = nodes > 0
    stats = _named({
        "rounds": torch.full((), rounds, dtype=I32, device=dev),
        "merged_writes": merged,
        "logical_rmws": logical,
        "overflows": (ok & (shard != home)).sum(dtype=I32),
        "fastpath_hits": hits,
        "fastpath_spills": _fast_total(pcfg, levels, active) - hits,
    })
    return trees, nodes, shard, ok, stats


def pool_free_round(pcfg: PoolConfig, trees, nodes, shard, active):
    """Release a multi-shard burst: one merged `free_round` per shard,
    each handle on the shard it records.  With a fastpath, handles route
    by node range: slab slots clear their bit (`slab_release`), other
    nodes inside or on the path to the carve are dropped, the rest take
    the merged buddy release.  Returns (trees, merged_writes,
    logical_rmws, freed)."""
    fp = pcfg.fastpath
    active = active.to(torch.bool)
    lane_mask = _lane_mask(pcfg, shard.to(I32))
    TW = pcfg.tree.n_state_words
    tree_part = trees[:, :TW]
    tree_active = active
    if fp is not None:
        slab_leaf = fpmod.in_slab_leaf(pcfg.tree, fp, nodes)
        junk = fpmod.in_carved_junk(pcfg.tree, fp, nodes)
        tree_active = active & ~slab_leaf & ~junk
        slab_part, sl_freed_s, sl_merged_s, sl_logical_s = fpmod.slab_releases(
            pcfg.tree, fp, trees[:, TW:], nodes, (active & slab_leaf)[None, :] & lane_mask
        )
    tree_part, merged_s, logical_s, freed_s = free_rounds(
        pcfg.tree, tree_part, nodes, tree_active[None, :] & lane_mask
    )
    merged, logical = merged_s.sum(dtype=I32), logical_s.sum(dtype=I32)
    freed = freed_s.any(dim=0)
    if fp is None:
        return tree_part, merged, logical, freed
    return (
        torch.cat([tree_part, slab_part], dim=1),
        merged + sl_merged_s.sum(dtype=I32),
        logical + sl_logical_s.sum(dtype=I32),
        freed | sl_freed_s.any(dim=0),
    )


# ---------------------------------------------------------------------------
# Occupancy introspection
# ---------------------------------------------------------------------------


def pool_free_units(pcfg: PoolConfig, trees) -> torch.Tensor:
    """Free leaf units per shard, int32[S]: a leaf is free iff it is
    allocatable (word zero and no reserved ancestor); free slab slots
    count at their octave's width."""
    cfg = pcfg.tree
    lo = 1 << cfg.depth
    TW = cfg.n_state_words
    alloc = cfg.layout.allocatable(cfg, trees[:, :TW])
    n = alloc[:, lo : 2 * lo].sum(dim=1, dtype=I32)
    if pcfg.fastpath is not None:
        n = n + fpmod.slab_free_units(cfg, pcfg.fastpath, trees[:, TW:])
    return n


def pool_largest_run(pcfg: PoolConfig, trees) -> torch.Tensor:
    """Largest allocatable run (in units) across all shards, int32; a
    free slab slot is a run of its octave's width."""
    cfg = pcfg.tree
    TW = cfg.n_state_words
    alloc = cfg.layout.allocatable(cfg, trees[:, :TW])
    best = torch.zeros(trees.shape[0], dtype=I32, device=trees.device)
    for lev in range(cfg.depth, cfg.max_level - 1, -1):
        lo, hi = 1 << lev, 1 << (lev + 1)
        has = alloc[:, lo:hi].any(dim=1)
        best = torch.where(has, 1 << (cfg.depth - lev), best).to(I32)
    if pcfg.fastpath is not None:
        has = fpmod.slab_free_slots(cfg, pcfg.fastpath, trees[:, TW:]) > 0
        run = torch.where(has, fpmod.fp_units_per_slot(cfg, pcfg.fastpath), 0).to(I32)
        best = torch.maximum(best, run)
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
    return trees, nodes, shard, ok, _check_slots(stats)


# ---------------------------------------------------------------------------
# Magazine fusion: lane-local recycling in front of the slab/tree rounds
# ---------------------------------------------------------------------------


def pool_init_magazines(pcfg: PoolConfig, n_lanes: int, device="cuda") -> MagazineState:
    """Empty magazines for a pool with a `MagazineConfig` attached."""
    if pcfg.magazines is None:
        raise ValueError("pool has no MagazineConfig attached")
    return magmod.init_magazines(pcfg.magazines, n_lanes, device)


def _gid_of(pcfg: PoolConfig, shard, nodes) -> torch.Tensor:
    """Global leaf page id of a (shard, leaf-node) handle."""
    lo = 1 << pcfg.tree.depth
    return (shard.to(I32) * lo + (nodes.to(I32) - lo)).to(I32)


def _gid_parts(pcfg: PoolConfig, gid):
    """(shard, leaf node) of a global page id (clamped for gid < 0)."""
    lo = 1 << pcfg.tree.depth
    g = gid.to(I32).clamp(min=0)
    return (g // lo).to(I32), (lo + g % lo).to(I32)


def pool_mag_free_per_shard(pcfg: PoolConfig, mags: MagazineState) -> torch.Tensor:
    """int32[S]: stashed pages per shard (they stay allocated in their
    shard's tree, so occupancy gauges add this to `pool_free_units`)."""
    return magmod.mag_free_per_shard(mags, pcfg.n_shards, 1 << pcfg.tree.depth)


def _no_mag_lane(n: int, device) -> torch.Tensor:
    return torch.full((n,), -1, dtype=I32, device=device)


def pool_claim_mag(pcfg: PoolConfig, mags, levels, pending, mag_lane, mag_rank=None):
    """The magazine claim in front of a round: leaf-octave lanes pop
    their own magazine.  Returns (mags, got, shard, node) with the
    popped page's recorded shard and leaf node for the lanes it served."""
    want = pending & (levels == pcfg.tree.depth)
    mags, gids, got, _ = magmod.mag_claim(pcfg.magazines, mags, want, mag_lane, rank=mag_rank)
    g_shard, g_node = _gid_parts(pcfg, gids)
    return mags, got, g_shard, g_node


def pool_alloc_round_mag(pcfg: PoolConfig, trees, mags, levels, pending, shard,
                         attempt, nodes, mag_lane, mag_rank=None):
    """One pool round with the magazine claim fused in front: lanes a
    pop serves take the popped page's shard, the misses fall through
    into this same round's fastpath-then-tree wavefront.

    Returns (trees, mags, nodes, pending, shard, attempt, merged,
    logical, won, fp_hits, mag_got)."""
    mags, got, g_shard, g_node = pool_claim_mag(
        pcfg, mags, levels, pending, mag_lane, mag_rank
    )
    nodes = torch.where(got, g_node, nodes)
    shard = torch.where(got, g_shard, shard)
    pending = pending & ~got
    (trees, nodes, pending, shard, attempt,
     merged, logical, won, fp_hits) = pool_alloc_round(
        pcfg, trees, levels, pending, shard, attempt, nodes
    )
    return (
        trees, mags, nodes, pending, shard, attempt,
        merged, logical, won | got, fp_hits, got,
    )


def _mag_stash_phase(pcfg: PoolConfig, trees, mags, nodes, shard, active, mag_lane,
                     mag_rank=None, assume_owned: bool = False):
    """The stash pre-pass of a magazine-fused release burst.

    A handle stashes only if it is a leaf, its lane has a magazine, the
    pool marks it allocated (the release paths' own predicates: derived
    OCC for tree leaves, the bit for slab leaves, never carved junk) and
    it is the min-lane instance of its page in the burst; duplicates of
    a stashed page are dropped, everything else falls through to the
    merged release.  `assume_owned=True` skips the ownership and dedup
    predicates (the caller's handles are distinct pages the pool marks
    allocated, as the engine's block tables are); `mag_rank` skips the
    group-rank sort.  Returns (mags, active_out, stashed, spills)."""
    cfg = pcfg.tree
    S = pcfg.n_shards
    K = nodes.shape[0]
    TW = cfg.n_state_words
    lo = 1 << cfg.depth
    dev = trees.device
    nodes = nodes.to(I32)
    active = active.to(torch.bool)
    mag_lane = mag_lane.to(I32)
    in_leaf = active & (nodes >= lo) & (nodes < 2 * lo)
    safe_nodes = torch.where(in_leaf, nodes, lo).to(I32)
    safe_shard = shard.to(I32).clamp(0, S - 1)

    if assume_owned:
        gid = _gid_of(pcfg, safe_shard, safe_nodes)
        stash_cand = in_leaf & (mag_lane >= 0)
        mags, stashed = magmod.mag_stash(
            pcfg.magazines, mags, gid, stash_cand, mag_lane, rank=mag_rank
        )
        spills = (stash_cand & ~stashed).sum(dtype=I32)
        return mags, active & ~stashed, stashed, spills

    fp = pcfg.fastpath
    zeros = torch.zeros(K, dtype=torch.bool, device=dev)
    if fp is not None and fpmod.fp_level(cfg, fp) == cfg.depth:
        slab_mask = in_leaf & fpmod.in_slab_leaf(cfg, fp, safe_nodes)
        occ_s = fpmod._slab_occ(cfg, fp, trees[:, TW:])  # [S, n_slots]
        base = fpmod.fp_node_base(cfg, fp)
        slot = (safe_nodes - base).clamp(0, fpmod.fp_n_slots(cfg, fp) - 1)
        occ_fp = occ_s[safe_shard.long(), slot.long()]
    else:
        slab_mask, occ_fp = zeros, zeros
    junk = fpmod.in_carved_junk(cfg, fp, safe_nodes) if fp is not None else zeros
    occ_tree_s = cfg.layout.node_occ_at(
        cfg, trees[:, :TW], safe_nodes[None, :].expand(S, K)
    )  # [S, K]
    occ_tree = occ_tree_s[safe_shard.long(), torch.arange(K, device=dev)]
    owned = torch.where(slab_mask, occ_fp, occ_tree & ~junk)

    # burst-wide min-lane dedup over the global page space
    ids = torch.arange(K, dtype=I32, device=dev)
    key = torch.where(in_leaf, _gid_of(pcfg, safe_shard, safe_nodes), 0).long()
    own = torch.full((S * lo,), INF, dtype=I32, device=dev).scatter_reduce(
        0, key, torch.where(in_leaf, ids, INF), "amin", include_self=True
    )
    winner = in_leaf & (own[key] == ids)

    stash_cand = winner & (mag_lane >= 0) & owned
    mags, stashed = magmod.mag_stash(pcfg.magazines, mags, key, stash_cand, mag_lane)
    spills = (stash_cand & ~stashed).sum(dtype=I32)
    stash_mark = torch.zeros(S * lo, dtype=I32, device=dev).scatter_add(
        0, key, stashed.to(I32)) > 0
    active_out = active & ~(in_leaf & stash_mark[key])
    return mags, active_out, stashed, spills


def pool_free_round_mag(pcfg: PoolConfig, trees, mags, nodes, shard, active, mag_lane,
                        mag_rank=None, assume_owned: bool = False):
    """Magazine-fused release burst: the stash pre-pass, then the same
    round's merged slab/tree release of everything that dropped
    through.  Returns (trees, mags, merged, logical, freed, stashes,
    spills)."""
    mags, active2, stashed, spills = _mag_stash_phase(
        pcfg, trees, mags, nodes, shard, active, mag_lane,
        mag_rank=mag_rank, assume_owned=assume_owned,
    )
    trees, merged, logical, freed = pool_free_round(pcfg, trees, nodes, shard, active2)
    return (
        trees, mags, merged, logical, freed | stashed,
        stashed.sum(dtype=I32), spills,
    )


def _mag_spill_all(pcfg: PoolConfig, trees, mags):
    """Release every stashed page back to its shard's slab/tree in one
    merged burst.  Returns (trees, mags, merged, logical, n_spilled)."""
    gids, live = magmod.mag_contents(mags)
    sh, nd = _gid_parts(pcfg, gids)
    trees, merged, logical, _ = pool_free_round(pcfg, trees, nd, sh, live)
    done = torch.ones((), dtype=torch.bool, device=trees.device)
    return trees, magmod.mag_clear(mags, done), merged, logical, live.sum(dtype=I32)


def pool_wavefront_alloc_mag(pcfg: PoolConfig, trees, mags, levels, active,
                             max_rounds: int = 64, lane_ids=None, mag_lane=None,
                             mag_rank=None):
    """Allocate a wavefront with magazines fused in: (1) the pool
    wavefront with the magazine claim in front of every round (claims
    land only in the first round: nothing restocks mid-wavefront);
    (2) if a lane failed while magazines hold pages, one merged
    spill-back of every stashed page; (3) the failed lanes rerun from
    their home shard.  Returns (trees, mags, nodes, shard, ok, stats);
    stats adds the 'magazine_*' counters to `pool_wavefront_alloc`'s."""
    if pcfg.magazines is None:
        raise ValueError("pool_wavefront_alloc_mag needs pcfg.magazines")
    dev = trees.device
    K = levels.shape[0]
    if lane_ids is None:
        lane_ids = torch.arange(K, dtype=I32, device=dev)
    if mag_lane is None:
        mag_lane = _no_mag_lane(K, dev)
    home = home_shard(pcfg, lane_ids)
    zero = torch.zeros((), dtype=I32, device=dev)
    active = active.to(torch.bool)

    nodes = torch.zeros(K, dtype=I32, device=dev)
    pending, shard = active.clone(), home.clone()
    attempt = torch.zeros(K, dtype=I32, device=dev)
    magged = torch.zeros(K, dtype=torch.bool, device=dev)
    rounds, merged, logical, fph = 0, zero, zero, zero
    while rounds < max_rounds and bool(pending.any()):
        (trees, mags, nodes, pending, shard, attempt,
         m, l, _, h, got) = pool_alloc_round_mag(
            pcfg, trees, mags, levels, pending, shard, attempt, nodes,
            mag_lane, mag_rank=mag_rank,
        )
        magged = magged | got
        rounds += 1
        merged, logical, fph = merged + m, logical + l, fph + h
    magh = magged.sum(dtype=I32)
    failed = active & ~(nodes > 0)

    # phase 2: exhaustion spill-back (one merged burst, at most once)
    sp_merged = sp_logical = n_spill = zero
    do_spill = bool(failed.any()) and int(magmod.mag_total(mags)) > 0
    if do_spill:
        trees, mags, sp_merged, sp_logical, n_spill = _mag_spill_all(pcfg, trees, mags)

    # phase 3: failed lanes retry from home against the replenished trees
    retry = failed & do_spill
    shard = torch.where(retry, home, shard)
    pending = retry.clone()
    attempt = torch.zeros(K, dtype=I32, device=dev)
    rounds2, merged2, logical2, fph2 = 0, zero, zero, zero
    while rounds2 < max_rounds and bool(pending.any()):
        trees, nodes, pending, shard, attempt, m, l, _, h = pool_alloc_round(
            pcfg, trees, levels, pending, shard, attempt, nodes
        )
        rounds2 += 1
        merged2, logical2, fph2 = merged2 + m, logical2 + l, fph2 + h
    ok = nodes > 0

    fast_total = _fast_total(pcfg, levels, active)
    if pcfg.fastpath is not None and fpmod.fp_level(pcfg.tree, pcfg.fastpath) == pcfg.tree.depth:
        fast_total = fast_total - magh  # magazine-served lanes never reached the slab
    hits = fph + fph2
    stats = _named({
        "rounds": torch.full((), rounds + rounds2, dtype=I32, device=dev),
        "merged_writes": merged + merged2 + sp_merged,
        "logical_rmws": logical + logical2 + sp_logical,
        # a magazine pop serves a lane off the popped page's recorded
        # shard: recycling, not an overflow probe
        "overflows": (ok & ~magged & (shard != home)).sum(dtype=I32),
        "fastpath_hits": hits,
        "fastpath_spills": fast_total - hits,
        "magazine_hits": magh,
        "magazine_spills": n_spill,
        "magazine_refills": zero,
    })
    return trees, mags, nodes, shard, ok, stats


def pool_wavefront_free_mag(pcfg: PoolConfig, trees, mags, nodes, shard, active,
                            mag_lane=None, mag_rank=None, assume_owned: bool = False):
    """Magazine-fused pool release.  Returns (trees, mags, freed, stats)."""
    if pcfg.magazines is None:
        raise ValueError("pool_wavefront_free_mag needs pcfg.magazines")
    if mag_lane is None:
        mag_lane = _no_mag_lane(nodes.shape[0], trees.device)
    trees, mags, merged, logical, freed, _, spills = pool_free_round_mag(
        pcfg, trees, mags, nodes, shard, active, mag_lane,
        mag_rank=mag_rank, assume_owned=assume_owned,
    )
    return trees, mags, freed, _named({
        "merged_writes": merged,
        "logical_rmws": logical,
        "magazine_spills": spills,
    })


def pool_magazine_drain(pcfg: PoolConfig, trees, mags):
    """Release every stashed page back to the pool and empty the
    magazines.  Returns (trees, mags, stats)."""
    if pcfg.magazines is None:
        raise ValueError("pool_magazine_drain needs pcfg.magazines")
    trees, mags, merged, logical, n = _mag_spill_all(pcfg, trees, mags)
    return trees, mags, _named({
        "free_merged_writes": merged,
        "free_logical_rmws": logical,
        "magazine_spills": n,
    })


def pool_magazine_refill(pcfg: PoolConfig, trees, mags, want_lanes):
    """Batched refill: pre-claim up to `refill_batch` leaf pages for
    every selected lane through one pool wavefront and stash them.
    Returns (trees, mags, stats) with 'magazine_refills'."""
    mcfg = pcfg.magazines
    if mcfg is None or mcfg.refill_batch < 1:
        raise ValueError("pool_magazine_refill needs pcfg.magazines.refill_batch >= 1")
    B = mcfg.refill_batch
    L, C = mags.pages.shape
    dev = trees.device
    room = (C - mags.depth).clamp(0, B)
    r_ids = torch.arange(B, dtype=I32, device=dev)
    req = want_lanes.to(torch.bool)[:, None] & (r_ids[None, :] < room[:, None])
    lane_ids = torch.arange(L, dtype=I32, device=dev).repeat_interleave(B)
    levels = torch.full((L * B,), pcfg.tree.depth, dtype=I32, device=dev)
    trees, nodes, shard, ok, astats = pool_wavefront_alloc(
        pcfg, trees, levels, req.reshape(-1), 64, lane_ids
    )
    gids = _gid_of(pcfg, shard, nodes)
    mags, stashed = magmod.mag_stash(mcfg, mags, gids, ok, lane_ids)
    # room was reserved per lane, so every claim stashes; the release
    # is insurance against a leak if that ever changes
    trees, _, _, _ = pool_free_round(pcfg, trees, nodes, shard, ok & ~stashed)
    stats = dict(astats)
    stats["magazine_refills"] = stashed.sum(dtype=I32)
    return trees, mags, _named(stats)


def pool_wavefront_step_mag(
    pcfg: PoolConfig, trees, mags, free_nodes, free_shard, free_active,
    alloc_levels, alloc_active, max_rounds: int = 64, lane_ids=None,
    free_mag_lane=None, alloc_mag_lane=None, free_mag_rank=None,
    alloc_mag_rank=None, assume_owned_frees: bool = False,
):
    """Magazine-fused pool scheduler round: the stash-then-release pass,
    then the claim-then-wavefront allocation.  Same stats slots as
    `pool_wavefront_step` with the magazine counters live.

    Returns (trees, mags, nodes, shard, ok, stats)."""
    if pcfg.magazines is None:
        raise ValueError("pool_wavefront_step_mag needs pcfg.magazines")
    if free_mag_lane is None:
        free_mag_lane = _no_mag_lane(free_nodes.shape[0], trees.device)
    trees, mags, f_merged, f_logical, freed, _, f_spills = pool_free_round_mag(
        pcfg, trees, mags, free_nodes, free_shard, free_active, free_mag_lane,
        mag_rank=free_mag_rank, assume_owned=assume_owned_frees,
    )
    trees, mags, nodes, shard, ok, stats = pool_wavefront_alloc_mag(
        pcfg, trees, mags, alloc_levels, alloc_active, max_rounds,
        lane_ids, alloc_mag_lane, alloc_mag_rank,
    )
    stats = dict(stats)
    stats["free_writes"] = f_merged
    stats["free_merged_writes"] = f_merged
    stats["free_logical_rmws"] = f_logical
    stats["freed"] = freed.sum(dtype=I32)
    stats["magazine_spills"] = stats["magazine_spills"] + f_spills
    return trees, mags, nodes, shard, ok, _check_slots(stats)
