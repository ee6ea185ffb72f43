"""Plain PyTorch references for the port's kernels.

`nbbs_wavefront_reference` is the counterpart of `repro/kernels/ref.py:21`:
the NBBS wavefront kernels' oracle is `core.concurrent.wavefront_alloc`,
re-exported here.

`mha_reference` is the counterpart of `repro/kernels/ref.py:28-68`, the
dense attention that defines flash attention's semantics (and computes
`ops.flash_attention`'s backward by autograd): fp32 logits, GQA by
`repeat_interleave`, softcap before the mask, causal and window masks
with rows and columns both counted from 0, the finite -1e30, and zeros
for a fully masked row.

`paged_attention_reference` is the counterpart of
`repro/kernels/ref.py:71-117`, the same math: it masks with a finite
-1e30, so a row with no live page gets uniform weights over the gathered
pages (the Pallas kernel and the port's kernel give zeros there; see
`kernels/paged_attention.py::paged_attention_plain`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.concurrent import wavefront_alloc as nbbs_wavefront_reference  # noqa: F401

NEG_INF = -1e30


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense reference attention. q: [B,Hq,S,D]; k,v: [B,Hkv,Sk,D]."""
    B, Hq, S, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = torch.where(mask, s, NEG_INF)
    # a fully masked row (a degenerate window) would softmax to uniform
    # weights: it gives zeros instead
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.float())
    return out.to(q.dtype)


def paged_attention_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention through a page table.

    q:            [B, Hq, D]        — one new token per sequence
    k/v_pages:    [P, page, Hkv, D] — global page pool
    block_tables: [B, max_pages]    — page ids per sequence, -1 padded
    context_lens: [B]               — valid kv length per sequence
    returns       [B, Hq, D]
    """
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    max_pages = block_tables.shape[1]
    L = max_pages * page

    safe = block_tables.clamp(min=0).long()
    k = k_pages[safe].reshape(B, L, Hkv, D).float()
    v = v_pages[safe].reshape(B, L, Hkv, D).float()
    qg = q.float().reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,blhd->bhgl", qg, k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(L, device=q.device)[None, :]
    valid = (block_tables >= 0)[:, :, None].expand(B, max_pages, page)
    valid = valid.reshape(B, L) & (pos < context_lens[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)
