"""Attention: GQA projections, the chunked online-softmax attention that
prefill and training run, the full attention block, and one-token
decode over a dense cache.

Counterpart of `repro/models/attention.py`.  These are
plain tensor code in the JAX package too (`chunked_attention` is a
`lax.scan` over KV chunks; here the scan is a Python loop).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.layers import _normal, apply_rope

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
    means no window.  Returns [B, Sq, Hq, D] in q's dtype.  DTensor
    inputs run on each rank's local shards (`_local_heads`)."""
    if isinstance(q, DTensor):
        return _local_heads(chunked_attention, q, k, v, causal=causal, window=window,
                            softcap=softcap, scale=scale, chunk=chunk, q_offset=q_offset)
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


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: `to_local`'s backward
    wraps the local gradient with the DTensor's contiguous strides, and
    a later view then fails on a strided one (the GQA einsum's)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local_heads(fn, q, k, v, **kw):
    """`fn(q, k, v, **kw)` on DTensors, run on local tensors: attention is
    independent across batch rows and heads, so each rank computes its
    own.  Per mesh dim the batch shard stays; the first other dim that
    divides both head counts shards the heads (a q head's kv head then
    lies in the same shard); the rest is replicated.  A local region:
    DTensor (torch 2.11) has no rule for the einsum's flattening of a
    head-sharded operand."""
    mesh = q.device_mesh
    place, heads = [], False
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p == Shard(0):
            place.append(Shard(0))
        elif not heads and q.shape[2] % n == 0 and k.shape[2] % n == 0:
            place.append(Shard(2))
            heads = True
        else:
            place.append(Replicate())
    out = fn(*(_ContiguousGrad.apply(t.redistribute(mesh, place).to_local())
               for t in (q, k, v)), **kw)
    shape = q.shape[:3] + out.shape[3:]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out.contiguous(), mesh, place, run_check=False, shape=shape,
                              stride=stride)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    context_len: int,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode over a dense cache.

    q: [B, 1, Hq, D]; k_cache, v_cache: [B, S, Hkv, D]; the first
    `context_len` positions are live.  Products run in float32 on the
    cache's values, as JAX's `preferred_element_type=float32`; the
    probabilities are rounded to the cache dtype before the PV product.
    Returns [B, 1, Hq, D] in q's dtype."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, -1, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    mask = pos < context_len
    if window is not None and window > 0:
        mask = mask & (pos > context_len - 1 - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(B, -1, Hq, D).to(q.dtype)


def attention_block(
    p: dict,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    positions: Optional[torch.Tensor] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Full GQA block (projections + RoPE + chunked attention), the
    weights in x's dtype.  x: [B, S, d] -> [B, S, d]."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = chunked_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                            chunk=chunk)
    return out.reshape(B, S, n_heads * head_dim) @ p["wo"]


def attention_decode_block(
    p: dict,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
):
    """Decode step: x [B, 1, d], cache [B, S, Hkv, D], pos an int.  The
    new token's K/V is written into the caches at `pos` in place (JAX's
    dynamic-update-slice).  Returns (out [B, 1, d], k_cache, v_cache)."""
    B = x.shape[0]
    q = (x @ p["wq"]).reshape(B, 1, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, 1, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(B, 1, n_kv_heads, head_dim)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    k_cache[:, pos] = k[:, 0]
    v_cache[:, pos] = v[:, 0]
    out = decode_attention(q, k_cache, v_cache, pos + 1, window=window, softcap=softcap)
    return out.reshape(B, 1, n_heads * head_dim) @ p["wo"], k_cache, v_cache


def attention_decode_stacked(
    p: dict,
    x: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    layer: int,
    pos: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Decode step of layer `layer` against a stacked cache
    [L, B, S, Hkv, D]: x [B, 1, d] -> out [B, 1, d].  The new token's K/V
    is written into `k_all` / `v_all` at position `pos` in place, then
    the layer's cache is read up to `pos` + 1."""
    out, _, _ = attention_decode_block(
        p, x, k_all[layer], v_all[layer], pos, n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim=head_dim, rope_theta=rope_theta, window=window, softcap=softcap)
    return out
