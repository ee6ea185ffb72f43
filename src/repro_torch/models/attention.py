"""Attention: GQA projections and the chunked online-softmax attention
that prefill runs.

Counterpart of `repro/models/attention.py:37-133`.  `chunked_attention`
is plain tensor code in the JAX package too (a `lax.scan` over KV
chunks); here the scan is a Python loop.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import _normal

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, device="cuda") -> dict:
    s = d ** -0.5
    so = (n_heads * head_dim) ** -0.5
    return {
        "wq": _normal(gen, (d, n_heads * head_dim), device) * s,
        "wk": _normal(gen, (d, n_kv_heads * head_dim), device) * s,
        "wv": _normal(gen, (d, n_kv_heads * head_dim), device) * s,
        "wo": _normal(gen, (n_heads * head_dim, d), device) * so,
    }


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D].  `window` <= 0 or None
    means no window.  Returns [B, Sq, Hq, D] in q's dtype."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, group, D).float()
    rows = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, Hkv, group, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, group, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, group, Sq, D), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kch = k[:, ci * chunk : (ci + 1) * chunk].float()
        vch = v[:, ci * chunk : (ci + 1) * chunk].float()
        cols = ci * chunk + torch.arange(kch.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kch) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = torch.ones((Sq, cols.shape[0]), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (cols[None, :] <= rows[:, None])
        if window is not None and window > 0:
            mask = mask & (cols[None, :] > rows[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.where(m_new == NEG_INF, 1.0, torch.exp(m - m_new))
        p = torch.exp(s - m_new[..., None])
        p = torch.where((m_new == NEG_INF)[..., None], 0.0, p)
        l = l * alpha + p.sum(dim=-1)
        # p is rounded to the KV dtype before the PV product, as in JAX
        p = p.to(v.dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vch)
        m = m_new
    norm = torch.where(l == 0.0, 1.0, l)
    out = acc / norm[..., None]                      # [B, Hkv, G, Sq, D]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out.to(q.dtype)
