"""Paged decode attention as a CUDA kernel (`csrc/paged_attention.cu`).

Replaces the TPU kernel
`repro/kernels/paged_attention.py::_paged_decode_kernel`.  One new token
per sequence attends over a page pool [P, page, Hkv, D] through block
tables [B, max_pages] (-1 padded) and context lengths [B]; GQA, optional
softcap, fp32 online softmax, each output element rounded once to q's
dtype.  Pages with id < 0 or starting past the context are skipped, and
a row with no live position gives zeros, as the Pallas kernel does.

The kernel is built for the H100's memory: one CTA per (sequence, tile
of q heads sharing adjacent kv heads), so each K/V row is read once per
kv head; the block-table row compacted into shared memory once per
CTA; the live pages dealt to four warps, each streaming its share
through a ring of shared-memory stages filled by 16-byte `cp.async`
and keeping its own fp32 (m, l, acc); the warps merged at the end.

`paged_attention` runs `paged_attention_plain` for CPU tensors and the
kernel for CUDA tensors (or raises); `launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_reference

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]


def paged_attention_plain(
    q, k_pages, v_pages, block_tables, context_lens, *, softcap=None, scale=None
):
    """The kernel's plain version: the reference math, with zeros for a
    row that has no live position (the Pallas kernel's semantics)."""
    out = paged_attention_reference(
        q, k_pages, v_pages, block_tables, context_lens,
        softcap=softcap, scale=scale,
    )
    page = k_pages.shape[1]
    pos = torch.arange(block_tables.shape[1] * page, device=q.device)
    live_page = (block_tables >= 0).repeat_interleave(page, dim=1)
    live = (live_page & (pos[None, :] < context_lens[:, None])).any(dim=1)
    return torch.where(live[:, None, None], out, 0).to(q.dtype)


def _lib():
    lib = _build.load("paged_attention")
    if lib.paged_attention_fwd.argtypes is None:
        lib.paged_attention_fwd.argtypes = _ARGTYPES
        lib.paged_attention_fwd.restype = ctypes.c_int
    return lib


def tile_plan(Hq: int, Hkv: int, D: int, max_pages: int, dtype) -> dict:
    """The kernel's tiling for these widths (builds the kernel): q-head
    slots per kv head, kv heads per CTA, elements of a row per lane, CTAs
    per sequence and bytes of dynamic shared memory per CTA."""
    plan = (ctypes.c_int * 5)()
    _lib().paged_attention_plan(Hq, Hkv, D, max_pages, _DTYPES[dtype], plan)
    return dict(q_slots=plan[0], kv_heads=plan[1], lane_elems=plan[2],
                ctas_per_seq=plan[3], smem_bytes=plan[4])


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [B, Hq, D]; k/v_pages: [P, page, Hkv, D]; tables: [B,
    max_pages] int32; lens: [B] int32.  Returns [B, Hq, D] in q's dtype.
    fp32 and bf16; D a multiple of 8 up to 128.

    The kernel reads K/V in place when they are contiguous and start on a
    16-byte boundary, as the engine's layer views do.  Any other view is
    copied on every call: the whole pool, 2 * P * page * Hkv * D
    elements (168 MB for one of stablelm-3b's bf16 layers of 4096 pages
    of 4), far more than the launch itself reads."""
    global launches
    dev = q.device
    if dev.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, block_tables, context_lens,
            softcap=softcap, scale=scale,
        )
    if dev.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {dev}")
    B, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if Dk != D or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError("k/v pages must be [P, page, Hkv, D] with q's D")
    if D % 8 or D > 128:
        raise ValueError(f"head_dim {D} must be a multiple of 8, at most 128")
    if Hq % Hkv:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hkv} kv heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("block_tables must be [B, max_pages]")
    for t in (k_pages, v_pages, block_tables, context_lens):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, q on {dev}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), v_pages.contiguous()
    # the kernel copies K/V in 16-byte pieces; a view that starts off a
    # 16-byte boundary is copied to a fresh allocation (see the docstring)
    k_pages = k_pages if k_pages.data_ptr() % 16 == 0 else k_pages.clone()
    v_pages = v_pages if v_pages.data_ptr() % 16 == 0 else v_pages.clone()
    tables = block_tables.to(torch.int32).contiguous()
    lens = context_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _lib().paged_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, D, P, page, tables.shape[1], float(scale),
        float(softcap or 0.0), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "paged_attention_fwd")
    launches += 1
    return out
