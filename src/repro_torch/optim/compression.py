"""Gradient compression: int8 block quantization with error feedback.

Counterpart of `repro/optim/compression.py` (`compress`, `decompress`,
`ef_roundtrip`, `init_error_buf`, `compressed_psum`), bit for bit:
per-block float32 scales (max |x| / 127 over blocks of 256), round half
to even, clip to [-127, 127].  The quantization residual is carried to
the next step's gradient.

  * `ef_roundtrip` — the wire simulated on each leaf.  A sharded leaf
    (DTensor) is gathered first: its blocks run over the global
    flattened order, as JAX's do, and the results are sharded back.
  * `compressed_psum` — the int8 all-reduce over a mesh axis: the ranks
    agree on a shared per-block scale (`all_reduce(MAX)` of the block
    maxima), quantize, sum the int8 payload as int32 (`all_reduce(SUM)`,
    exact) and dequantize.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import active_mesh, replicated
from repro_torch.tree_util import flatten, leaves, tree_map

BLOCK = 256  # per-block scaling granularity


def _blocks(x: torch.Tensor):
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), x.shape


def _unblocks(blocks: torch.Tensor, shape) -> torch.Tensor:
    return blocks.reshape(-1)[: math.prod(shape)].reshape(shape)


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 tensor -> (int8 payload [Nb, BLOCK], float32 scales [Nb])."""
    blocks, _ = _blocks(g)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127)
    return q.to(torch.int8), scale


def decompress(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return _unblocks(q.float() * scale[:, None], shape)


def ef_roundtrip(grads, error_buf):
    """Error-feedback compression round trip.

    Returns (grads as they survive the wire, new error buffer)."""

    def one(g, e):
        ge = g.float() + e
        if isinstance(ge, DTensor):
            # the global blocks, then each rank keeps its shards
            mesh, placed = ge.device_mesh, ge.placements
            rec, err = one(g.full_tensor(), e.full_tensor())
            return tuple(replicated(t, mesh).redistribute(mesh, placed)
                         for t in (rec, err))
        q, s = compress(ge)
        rec = decompress(q, s, g.shape)
        return rec.to(g.dtype), ge - rec

    flat, treedef = flatten(grads)
    out = [one(g, e) for g, e in zip(flat, leaves(error_buf))]
    return treedef.unflatten([r for r, _ in out]), treedef.unflatten([e for _, e in out])


def init_error_buf(grads_like):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32,
                                               memory_format=torch.contiguous_format),
                    grads_like)


def _axis_group(axis_name):
    """The process group of a mesh axis of the current mesh; a tuple of
    axis names is one group over those mesh dims flattened."""
    mesh = active_mesh()
    if isinstance(axis_name, tuple):
        if len(axis_name) > 1:
            return mesh[axis_name]._flatten().get_group()
        axis_name = axis_name[0]
    return mesh.get_group(axis_name)


def compressed_psum(g: torch.Tensor, axis_name) -> torch.Tensor:
    """int8-on-the-wire sum of each rank's `g` (a plain tensor) over the
    ranks of mesh axis `axis_name` of the current mesh."""
    group = _axis_group(axis_name)
    blocks, shape = _blocks(g)
    bmax = blocks.abs().amax(dim=1)
    dist.all_reduce(bmax, op=dist.ReduceOp.MAX, group=group)
    scale = bmax / 127.0  # shared scale
    safe = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    return _unblocks(qsum.float() * scale[:, None], shape)
