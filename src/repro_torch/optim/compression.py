"""Gradient compression: int8 block quantization with error feedback.

Counterpart of `repro/optim/compression.py` (`compress`, `decompress`,
`ef_roundtrip`, `init_error_buf`), bit for bit: per-block float32
scales (max |x| / 127 over blocks of 256), round half to even, clip to
[-127, 127].  The quantization residual is carried to the next step's
gradient.  The int8 all-reduce (`compressed_psum`) comes with the
distribution slice.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

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
        q, s = compress(ge)
        rec = decompress(q, s, g.shape)
        return rec.to(g.dtype), ge - rec

    flat, treedef = flatten(grads)
    out = [one(g, e) for g, e in zip(flat, leaves(error_buf))]
    return treedef.unflatten([r for r, _ in out]), treedef.unflatten([e for _, e in out])


def init_error_buf(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_like)
