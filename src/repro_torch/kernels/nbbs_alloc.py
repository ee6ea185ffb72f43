"""The pooled NBBS step as one CUDA kernel (`csrc/nbbs_pool_step.cu`).

Replaces the TPU kernel `repro/kernels/nbbs_alloc.py::_pool_step_kernel`
(entry `pool_wavefront_step_pallas`).  `pool_step` runs one pool
scheduler step, the merged release of F handles and then the lockstep
alloc rounds of K lanes with overflow re-routing, and is bit-identical
to the plain `core.pool.pool_wavefront_step` (the lockstep router), stat
slots included, even when lanes overflow.

`pool_free` runs the release half alone and also returns which handles
it applied (the counterpart of `core.pool.pool_free_round`).

For CPU tensors both run their plain version.  For CUDA tensors they
launch the kernel or raise; `launches` counts the launches.

Limits (checked here, raised as ValueError): the Unpacked layout only;
the whole stack of trees and its scratch must fit one block's shared
memory, 17 bytes per node (S * 2^(depth+1) nodes) plus 28 bytes per
alloc lane, at most 227 KB: 4096 pages in all (S=1 at depth 12, S=4 at
depth 10) with up to 2048 lanes.  Alloc lanes are at most 2048 because
each lane counts its rank among the lanes before it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.concurrent import I32
from repro_torch.core.layout import Unpacked
from repro_torch.core.pool import PoolConfig, pool_free_round, pool_wavefront_step
from repro_torch.kernels import _build

SMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may use
MAX_LANES = 2048
N_STATS = 7            # rounds, merged, logical, free merged/logical, freed, overflows

launches = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]


def smem_bytes(pcfg: PoolConfig, n_lanes: int) -> int:
    """Dynamic shared memory of one launch: tree, prefix (+1), own and
    desc words plus one flag byte per node, seven words per lane."""
    T = pcfg.n_shards * pcfg.n_words
    return 17 * T + 4 + 28 * n_lanes


def _lib():
    lib = _build.load("nbbs_pool_step")
    if lib.nbbs_pool_step.argtypes is None:
        lib.nbbs_pool_step.argtypes = _ARGTYPES
        lib.nbbs_pool_step.restype = ctypes.c_int
    return lib


def _i32(x: torch.Tensor, device) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"tensor on {x.device}, trees on {device}")
    return x.to(I32).contiguous()


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
    out, nodes, shard, _, stats = _launch(
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
    out, _, _, freed, stats = _launch(
        pcfg, trees, free_nodes, free_shard, free_active, none, none, none, 0
    )
    return out, freed != 0, {
        k: stats[k] for k in ("free_merged_writes", "free_logical_rmws", "freed")
    }


def _launch(pcfg, trees, free_nodes, free_shard, free_active, levels, active,
            lane_ids, max_rounds):
    """One kernel launch.  Returns (trees, nodes, shard, freed int32[F],
    stats)."""
    global launches
    dev = trees.device
    if dev.type != "cuda":
        raise ValueError(f"the pooled kernel runs on cpu or cuda, not {dev}")
    if not isinstance(pcfg.tree.layout, Unpacked):
        raise ValueError("the pooled kernel takes the Unpacked layout only")
    S, N = pcfg.n_shards, pcfg.n_words
    if trees.dtype != I32 or tuple(trees.shape) != (S, N):
        raise ValueError(f"trees must be int32[{S}, {N}], got "
                         f"{trees.dtype}{tuple(trees.shape)}")
    K = levels.shape[0]
    if K > MAX_LANES:
        raise ValueError(f"{K} alloc lanes > {MAX_LANES} the kernel takes")
    smem = smem_bytes(pcfg, K)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"pool of {S} x 2^{pcfg.tree.depth + 1} nodes with {K} lanes "
            f"needs {smem} B of shared memory > {SMEM_LIMIT} B: the kernel "
            "takes at most 4096 pages in all"
        )
    F = free_nodes.shape[0]
    trees = trees.contiguous()
    fn, fs, fa = (_i32(t, dev) for t in (free_nodes, free_shard, free_active))
    lv, act, ids = (_i32(t, dev) for t in (levels, active, lane_ids))
    out = torch.empty_like(trees)
    nodes = torch.empty(K, dtype=I32, device=dev)
    shard = torch.empty(K, dtype=I32, device=dev)
    freed = torch.empty(F, dtype=I32, device=dev)
    stats = torch.zeros(N_STATS + 1, dtype=I32, device=dev)  # last slot stays 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().nbbs_pool_step(
        trees.data_ptr(), out.data_ptr(), S, pcfg.tree.depth,
        pcfg.tree.max_level, fn.data_ptr(), fs.data_ptr(), fa.data_ptr(), F,
        lv.data_ptr(), act.data_ptr(), ids.data_ptr(), K, max_rounds,
        nodes.data_ptr(), shard.data_ptr(), freed.data_ptr(), stats.data_ptr(),
        smem, stream,
    )
    _build.check(err, "nbbs_pool_step")
    launches += 1
    zero = stats[N_STATS]
    named = {
        "rounds": stats[0],
        "merged_writes": stats[1],
        "logical_rmws": stats[2],
        "overflows": stats[6],
        "fastpath_hits": zero,
        "fastpath_spills": zero,
        "free_writes": stats[3],
        "free_merged_writes": stats[3],
        "free_logical_rmws": stats[4],
        "freed": stats[5],
        "magazine_hits": zero,
        "magazine_spills": zero,
        "magazine_refills": zero,
    }
    return out, nodes, shard, freed, named
