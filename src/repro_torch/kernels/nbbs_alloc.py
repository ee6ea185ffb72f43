"""The NBBS step kernels (`csrc/nbbs_pool_step.cu`), both tree layouts.

One CUDA source gives three launchers over one kernel body, each with
its own wrapper and launch counter here:

  * `pool_step` / `pool_free` launch kernel A, `nbbs_pool_step`, which
    replaces `repro/kernels/nbbs_alloc.py::_pool_step_kernel`: one pool
    scheduler step (merged release of F handles, then the lockstep alloc
    rounds of K lanes with overflow re-routing), bit-identical to the
    plain `core.pool.pool_wavefront_step`, stat slots included, even when
    lanes overflow.  With a fastpath (`pcfg.fastpath`) the launch also
    runs the slab phase: the release routes handles by node range and
    every round claims slab slots before the buddy round.  `pool_free`
    runs its release half alone and also returns which handles it
    applied (as `core.pool.pool_free_round`).
    Counter: `launches`; `slab_launches` counts those of them on a pool
    with a fastpath.
  * `wavefront_step` / `wavefront_free` launch kernel 3,
    `nbbs_wavefront_step`, which replaces `_wavefront_step_kernel`: one
    tree, release then alloc rounds, the 6-slot `WAVEFRONT_STEP_SLOTS`
    row; plain version `core.concurrent.wavefront_step`.  `wavefront_free`
    is its release half alone (K=0), plain version `wavefront_free`.
    Counter: `wavefront_step_launches`.
  * `wavefront_alloc` launches kernel 4, `nbbs_wavefront_alloc`, which
    replaces `_wavefront_kernel`: one tree, alloc rounds only, the
    3-slot `WAVEFRONT_ALLOC_SLOTS` row; plain version
    `core.concurrent.wavefront_alloc`.  Counter:
    `wavefront_alloc_launches`.

For CPU tensors each wrapper runs its plain version.  For CUDA tensors
it launches its kernel or raises; it never falls back.

Memory tiers.  A launch needs `workspace_bytes` for the state words
(slab words included) and the scratch: a flag byte and three bits per
node, a count table per warp of lanes, three words per slab word.  Up to
`SMEM_LIMIT` they live in one block's shared memory: every stack of up
to 2^15 nodes (one depth-14 tree, S=2 at depth 13) at K <= 256, in both
layouts.  Above it the wrapper allocates a device-memory workspace and
the same kernel runs from it.  `tier_launches` counts the launches of
each tier.  Limits (ValueError): at most `MAX_NODES` = 2^19 tree nodes
in the whole stack (one depth-18 tree, the size the Pallas kernel is
documented for) and `MAX_LANES` alloc lanes: the kernel keeps each lane
in registers, at most two per thread of its 1024-thread block.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import fastpath as fpmod
from repro_torch.core.concurrent import (
    I32,
    TreeConfig,
    wavefront_alloc as wavefront_alloc_plain,
    wavefront_free as wavefront_free_plain,
    wavefront_step as wavefront_step_plain,
)
from repro_torch.core.layout import BunchPacked
from repro_torch.core.pool import PoolConfig, pool_free_round, pool_wavefront_step
from repro_torch.kernels import _build
from repro_torch.obs.schema import WAVEFRONT_ALLOC_SLOTS, WAVEFRONT_STEP_SLOTS, pack_slots

SMEM_LIMIT = 230_400   # dynamic shared memory of one H100 block, static arrays set aside
MAX_LANES = 2048
MAX_NODES = 1 << 19
N_STATS = 8            # rounds, merged, logical, free merged/logical, freed, overflows,
                       # fastpath hits

launches = 0                  # kernel A (nbbs_pool_step)
slab_launches = 0             # kernel A on a pool with a fastpath slab
wavefront_step_launches = 0   # kernel 3 (nbbs_wavefront_step)
wavefront_alloc_launches = 0  # kernel 4 (nbbs_wavefront_alloc)
tier_launches = {"shared": 0, "device": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "nbbs_pool_step": [
        _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P,
        _P, _I, _I, _P, _P, _P, _P, _P, _I, _P,
    ],
    "nbbs_wavefront_step": [
        _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P,
        _P, _I, _P,
    ],
    "nbbs_wavefront_alloc": [
        _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P,
    ],
}


def _align16(n: int) -> int:
    return (n + 15) & ~15


def workspace_bytes(cfg: TreeConfig, n_trees: int, n_lanes: int, slab_words: int = 0) -> int:
    """Bytes of one launch, as the kernel lays them out (`sizes_of` in
    the source): the tree state words and per slab word three int32
    words (the word, its copy before a phase, the free-slot prefix) plus
    one, 16-byte aligned; one flag byte per node, 16-byte aligned; per 32
    nodes three words (allocatable bits, their prefix (+1), commit
    marks); a count and a mask per warp of lanes and (shard, level) key,
    plus a row of totals; with a slab, a count per warp of lanes (+1) and
    shard."""
    S, T = n_trees, n_trees * cfg.n_words
    nwd, nlw, nk = (T + 31) // 32, (n_lanes + 31) // 32, n_trees * (cfg.depth + 1)
    words = S * cfg.n_state_words + 3 * S * slab_words + 1
    ints = (3 * nwd + 1 + (nlw + 1) * nk + nlw * nk
            + ((nlw + 1) * S if slab_words else 0))
    return _align16(4 * words) + _align16(T) + 4 * ints


def smem_bytes(pcfg: PoolConfig, n_lanes: int) -> int:
    """`workspace_bytes` of a pool step."""
    return workspace_bytes(pcfg.tree, pcfg.n_shards, n_lanes, pcfg.fp_state_words)


def tier(cfg: TreeConfig, n_trees: int, n_lanes: int, slab_words: int = 0) -> str:
    """Where a launch keeps its state and scratch: "shared" or "device"."""
    fits = workspace_bytes(cfg, n_trees, n_lanes, slab_words) <= SMEM_LIMIT
    return "shared" if fits else "device"


def _fn(name: str):
    fn = getattr(_build.load("nbbs_pool_step"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _i32(x: torch.Tensor, device) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"tensor on {x.device}, trees on {device}")
    return x.to(I32).contiguous()


def _prepare(what, cfg: TreeConfig, n_trees: int, trees: torch.Tensor, shape, K: int,
             slab_words: int = 0):
    """Check a launch and give its (workspace tensor or None: shared
    memory, workspace bytes, tier)."""
    dev = trees.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    if trees.dtype != I32 or tuple(trees.shape) != shape:
        raise ValueError(f"{what}: state must be int32{list(shape)}, got "
                         f"{trees.dtype}{list(trees.shape)}")
    if K > MAX_LANES:
        raise ValueError(f"{what}: {K} alloc lanes > {MAX_LANES} the kernel takes")
    T = n_trees * cfg.n_words
    if T > MAX_NODES:
        raise ValueError(
            f"{what}: {n_trees} x 2^{cfg.depth + 1} = {T} tree nodes > "
            f"{MAX_NODES} (one depth-18 tree) the kernel takes"
        )
    nbytes = workspace_bytes(cfg, n_trees, K, slab_words)
    where = tier(cfg, n_trees, K, slab_words)
    if where == "shared":
        return None, nbytes, where
    # dropped when the wrapper returns: the caching allocator hands the
    # block out again only in the order of the current stream
    return torch.empty(nbytes, dtype=torch.uint8, device=dev), nbytes, where


def _launched(name: str, err: int, where: str) -> None:
    """Raise on a failed launch, else count it in its tier."""
    _build.check(err, name)
    tier_launches[where] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _packed(cfg: TreeConfig) -> int:
    return int(isinstance(cfg.layout, BunchPacked))


# ---------------------------------------------------------------------------
# Kernel A: the pooled step
# ---------------------------------------------------------------------------


def pool_step(
    pcfg: PoolConfig,
    trees: torch.Tensor,
    free_nodes: torch.Tensor,
    free_shard: torch.Tensor,
    free_active: torch.Tensor,
    levels: torch.Tensor,
    active: torch.Tensor,
    lane_ids: torch.Tensor | None = None,
    max_rounds: int = 64,
):
    """One pooled step.  Returns (trees, nodes, shard, ok, stats) with
    the stats dict of `core.pool.pool_wavefront_step`."""
    dev = trees.device
    if lane_ids is None:
        lane_ids = torch.arange(levels.shape[0], dtype=I32, device=dev)
    if dev.type == "cpu":
        return pool_wavefront_step(
            pcfg, trees, free_nodes, free_shard, free_active, levels,
            active, max_rounds, lane_ids,
        )
    out, nodes, shard, _, stats = _launch_pool(
        pcfg, trees, free_nodes, free_shard, free_active, levels, active,
        lane_ids, max_rounds,
    )
    return out, nodes, shard, nodes > 0, stats


def pool_free(
    pcfg: PoolConfig,
    trees: torch.Tensor,
    free_nodes: torch.Tensor,
    free_shard: torch.Tensor,
    free_active: torch.Tensor,
):
    """The release half alone (no alloc lanes): one merged pass per
    shard, as `core.pool.pool_free_round`.  Returns (trees, freed
    bool[F], stats) with `free_merged_writes`, `free_logical_rmws` and
    `freed`; `freed` marks the handles the release applied."""
    dev = trees.device
    if dev.type == "cpu":
        trees, merged, logical, freed = pool_free_round(
            pcfg, trees, free_nodes, free_shard, free_active
        )
        return trees, freed, {
            "free_merged_writes": merged,
            "free_logical_rmws": logical,
            "freed": freed.sum(dtype=I32),
        }
    none = torch.zeros(0, dtype=I32, device=dev)
    out, _, _, freed, stats = _launch_pool(
        pcfg, trees, free_nodes, free_shard, free_active, none, none, none, 0
    )
    return out, freed != 0, {
        k: stats[k] for k in ("free_merged_writes", "free_logical_rmws", "freed")
    }


def _launch_pool(pcfg, trees, free_nodes, free_shard, free_active, levels,
                 active, lane_ids, max_rounds):
    """One launch of kernel A.  Returns (trees, nodes, shard, freed
    int32[F], stats)."""
    global launches, slab_launches
    cfg, S, SW = pcfg.tree, pcfg.n_shards, pcfg.fp_state_words
    K, F = levels.shape[0], free_nodes.shape[0]
    ws, nbytes, where = _prepare("nbbs_pool_step", cfg, S, trees, (S, pcfg.n_state_words),
                               K, SW)
    dev = trees.device
    trees = trees.contiguous()
    fn, fs, fa = (_i32(t, dev) for t in (free_nodes, free_shard, free_active))
    lv, act, ids = (_i32(t, dev) for t in (levels, active, lane_ids))
    out = torch.empty_like(trees)
    nodes = torch.empty(K, dtype=I32, device=dev)
    shard = torch.empty(K, dtype=I32, device=dev)
    freed = torch.empty(F, dtype=I32, device=dev)
    stats = torch.zeros(N_STATS + 1, dtype=I32, device=dev)  # last slot stays 0
    fp = pcfg.fastpath
    fp_geom = (0, 0, 0) if fp is None else (
        fpmod.fp_level(cfg, fp), fp.slab_level, fpmod.fp_n_slots(cfg, fp))
    err = _fn("nbbs_pool_step")(
        trees.data_ptr(), out.data_ptr(), S, cfg.depth, cfg.max_level,
        _packed(cfg), pcfg.n_state_words, SW, *fp_geom, fn.data_ptr(), fs.data_ptr(),
        fa.data_ptr(), F, lv.data_ptr(), act.data_ptr(), ids.data_ptr(), K,
        max_rounds, nodes.data_ptr(), shard.data_ptr(), freed.data_ptr(),
        stats.data_ptr(), _ptr(ws), nbytes, torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("nbbs_pool_step", err, where)
    launches += 1
    slab_launches += fp is not None
    zero = stats[N_STATS]
    fast = zero if fp is None else (
        (act != 0) & (lv == fp_geom[0])).sum(dtype=I32)
    named = {
        "rounds": stats[0],
        "merged_writes": stats[1],
        "logical_rmws": stats[2],
        "overflows": stats[6],
        "fastpath_hits": stats[7],
        "fastpath_spills": fast - stats[7],
        "free_writes": stats[3],
        "free_merged_writes": stats[3],
        "free_logical_rmws": stats[4],
        "freed": stats[5],
        "magazine_hits": zero,
        "magazine_spills": zero,
        "magazine_refills": zero,
    }
    return out, nodes, shard, freed, named


# ---------------------------------------------------------------------------
# Kernels 3 and 4: one tree
# ---------------------------------------------------------------------------


def wavefront_step(
    cfg: TreeConfig,
    tree: torch.Tensor,
    free_nodes: torch.Tensor,
    free_active: torch.Tensor,
    levels: torch.Tensor,
    active: torch.Tensor,
    max_rounds: int = 64,
):
    """Kernel 3: the merged release of F handles, then the alloc rounds
    of K lanes, on one tree.  Returns (tree, nodes, ok, stats int32[6])
    with the row in `WAVEFRONT_STEP_SLOTS` order."""
    if tree.device.type == "cpu":
        tree, nodes, ok, stats = wavefront_step_plain(
            cfg, tree, free_nodes, free_active, levels, active, max_rounds
        )
        return tree, nodes, ok, pack_slots(WAVEFRONT_STEP_SLOTS, stats)
    out, nodes, _, stats = _launch_step(
        cfg, tree, free_nodes, free_active, levels, active, max_rounds
    )
    return out, nodes, nodes > 0, stats


def wavefront_free(
    cfg: TreeConfig, tree: torch.Tensor, nodes: torch.Tensor, active: torch.Tensor
):
    """Kernel 3's release half alone (no alloc lanes): one merged pass,
    as `core.concurrent.wavefront_free`.  Returns (tree, freed bool[F],
    stats) with `merged_writes` and `logical_rmws`."""
    if tree.device.type == "cpu":
        return wavefront_free_plain(cfg, tree, nodes, active)
    none = torch.zeros(0, dtype=I32, device=tree.device)
    out, _, freed, stats = _launch_step(cfg, tree, nodes, active, none, none, 0)
    return out, freed != 0, {"merged_writes": stats[3], "logical_rmws": stats[4]}


def wavefront_alloc(
    cfg: TreeConfig,
    tree: torch.Tensor,
    levels: torch.Tensor,
    active: torch.Tensor,
    max_rounds: int = 64,
):
    """Kernel 4: the alloc rounds of K lanes on one tree, no release.
    Returns (tree, nodes, ok, stats int32[3]) with the row in
    `WAVEFRONT_ALLOC_SLOTS` order."""
    if tree.device.type == "cpu":
        tree, nodes, ok, stats = wavefront_alloc_plain(
            cfg, tree, levels, active, max_rounds
        )
        return tree, nodes, ok, pack_slots(WAVEFRONT_ALLOC_SLOTS, stats)
    global wavefront_alloc_launches
    K = levels.shape[0]
    ws, nbytes, where = _prepare("nbbs_wavefront_alloc", cfg, 1, tree, (cfg.n_state_words,), K)
    dev = tree.device
    tree = tree.contiguous()
    lv, act = _i32(levels, dev), _i32(active, dev)
    out = torch.empty_like(tree)
    nodes = torch.empty(K, dtype=I32, device=dev)
    stats = torch.empty(len(WAVEFRONT_ALLOC_SLOTS), dtype=I32, device=dev)
    err = _fn("nbbs_wavefront_alloc")(
        tree.data_ptr(), out.data_ptr(), cfg.depth, cfg.max_level, _packed(cfg),
        cfg.n_state_words, lv.data_ptr(), act.data_ptr(), K, max_rounds,
        nodes.data_ptr(), stats.data_ptr(), _ptr(ws), nbytes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("nbbs_wavefront_alloc", err, where)
    wavefront_alloc_launches += 1
    return out, nodes, nodes > 0, stats


def _launch_step(cfg, tree, free_nodes, free_active, levels, active, max_rounds):
    """One launch of kernel 3.  Returns (tree, nodes, freed int32[F],
    stats int32[6])."""
    global wavefront_step_launches
    K, F = levels.shape[0], free_nodes.shape[0]
    ws, nbytes, where = _prepare("nbbs_wavefront_step", cfg, 1, tree, (cfg.n_state_words,), K)
    dev = tree.device
    tree = tree.contiguous()
    fn, fa = _i32(free_nodes, dev), _i32(free_active, dev)
    lv, act = _i32(levels, dev), _i32(active, dev)
    out = torch.empty_like(tree)
    nodes = torch.empty(K, dtype=I32, device=dev)
    freed = torch.empty(F, dtype=I32, device=dev)
    stats = torch.empty(len(WAVEFRONT_STEP_SLOTS), dtype=I32, device=dev)
    err = _fn("nbbs_wavefront_step")(
        tree.data_ptr(), out.data_ptr(), cfg.depth, cfg.max_level, _packed(cfg),
        cfg.n_state_words, fn.data_ptr(), fa.data_ptr(), F, lv.data_ptr(),
        act.data_ptr(), K, max_rounds, nodes.data_ptr(), freed.data_ptr(),
        stats.data_ptr(), _ptr(ws), nbytes, torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("nbbs_wavefront_step", err, where)
    wavefront_step_launches += 1
    return out, nodes, freed, stats
