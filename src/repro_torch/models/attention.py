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
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.layers import _normal, apply_rope
from repro_torch.models.sharding import (like, merge_heads, on_rows_and_heads, shard_range,
                                         split_heads, sum_partials)

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


def _local_heads(fn, q, k, v, **kw):
    """`fn(q, k, v, **kw)` on DTensors, run on local tensors: attention is
    independent across batch rows and heads, so each rank computes its
    own (`models.sharding.on_rows_and_heads`; a mesh dim that divides
    the kv heads splits q's heads too, so a q head's kv head lies in the
    same shard).  A local region: DTensor (torch 2.11) has no rule for
    the einsum's flattening of a head-sharded operand."""
    out, = on_rows_and_heads(lambda *a: (fn(*a, **kw),), (q, k, v), [(0, 2)] * 3, [(0, 2)],
                             k.shape[2])
    return out


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
    s = _decode_scores(q, k_cache, torch.arange(k_cache.shape[1], device=q.device),
                       context_len, window, softcap, scale)
    p = torch.softmax(s, dim=-1)
    return _decode_out(p, v_cache, q)


def _decode_scores(q, k_cache, pos, context_len, window, softcap, scale):
    """Masked float32 scores [B, Hkv, group, 1, S] of q [B, 1, Hq, D]
    against cache rows [B, S, Hkv, D] at global positions `pos` [S]."""
    B, _, Hkv, D = k_cache.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, -1, Hkv, q.shape[2] // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = pos < context_len
    if window is not None and window > 0:
        mask = mask & (pos > context_len - 1 - window)
    return torch.where(mask, s, NEG_INF)


def _decode_out(p, v_cache, q, reduce=None):
    """The probabilities, rounded to the cache dtype, against the value
    rows: [B, 1, Hq, D] in float32 (summed over shards by `reduce`), then
    cast to q's dtype."""
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype).float(), v_cache.float())
    if reduce is not None:
        out = reduce(out.contiguous())
    return out.reshape(q.shape).to(q.dtype)


def _all_reduce(t: torch.Tensor, groups, op) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(t, op=op, group=g)
    return t


def _decode_on_shards(q, k, v, k_all: DTensor, v_all: DTensor, layer: int, pos: int, *,
                      window, softcap) -> DTensor:
    """Write the new K/V row at `pos` and attend, on a cache sharded as
    `models.sharding.cache_pspecs` places it: B over the dp group, S over
    the model axis (or S over every axis).  q, k, v: [B, 1, H, D]
    DTensors.  A local region: each rank takes its batch rows of q, k, v
    (gathered over the other mesh dims: [B, 1, H, D] activations), writes
    the row only if its S shard holds `pos`, and scores its own cache
    rows at their global positions; the softmax over the split S
    combines the shards' max and sum, and the partial outputs are summed,
    over the mesh dims that split S (three all-reduces of [B, H] and
    [B, H, D] floats: the flash-decode partial softmax that JAX's SPMD
    gives).  The cache is never gathered."""
    mesh, place = k_all.device_mesh, k_all.placements
    rows = [Shard(0) if p == Shard(1) else Replicate() for p in place]
    start, n = shard_range(k_all.shape[2], mesh, place, 2)
    kc, vc = k_all.to_local()[layer], v_all.to_local()[layer]     # [B_l, S_l, Hkv, D]
    if kc.shape[1] != n:
        raise RuntimeError(f"cache shard holds {kc.shape[1]} rows, expected {n}")
    ql, kl, vl = (t.redistribute(mesh, rows).to_local() for t in (q, k, v))
    if start <= pos < start + n:
        kc[:, pos - start] = kl[:, 0]
        vc[:, pos - start] = vl[:, 0]
    s = _decode_scores(ql, kc, torch.arange(start, start + n, device=kc.device), pos + 1,
                       window, softcap, None)
    groups = [mesh.get_group(i) for i, p in enumerate(place)
              if p == Shard(2) and mesh.size(i) > 1]
    if groups:
        m = (s.amax(dim=-1, keepdim=True) if n else
             torch.full(s.shape[:-1] + (1,), NEG_INF, device=s.device))
        e = torch.exp(s - _all_reduce(m, groups, dist.ReduceOp.MAX))
        p = e / _all_reduce(e.sum(dim=-1, keepdim=True), groups, dist.ReduceOp.SUM)
        out = _decode_out(p, vc, ql, lambda t: _all_reduce(t, groups, dist.ReduceOp.SUM))
    else:  # S whole on this rank: the unsharded path's softmax
        out = _decode_out(torch.softmax(s, dim=-1), vc, ql)
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=q.shape,
                              stride=torch.empty(q.shape, device="meta").stride())


def write_prompt_kv(k_all: torch.Tensor, layer: int, k: torch.Tensor) -> None:
    """`k_all[layer, :, :S] = k` for a prompt's K (or V) [B, S, Hkv, D],
    in place.  On a cache sharded by `models.sharding.cache_pspecs`, a
    local region: each rank copies the rows of its batch rows and of its
    S shard that the prompt covers (k gathered over the other mesh dims:
    an activation; the cache is never gathered)."""
    S = k.shape[1]
    if not isinstance(k_all, DTensor):
        k_all[layer, :, :S] = k
        return
    mesh, place = k_all.device_mesh, k_all.placements
    rows = [Shard(0) if p == Shard(1) else Replicate() for p in place]
    kl = like(k, k_all).redistribute(mesh, rows).to_local()   # every rank: a collective
    start, n = shard_range(k_all.shape[2], mesh, place, 2)
    stop = min(start + n, S)
    if stop > start:
        k_all.to_local()[layer, :, : stop - start] = kl[:, start:stop]


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
    S = x.shape[1]
    q = split_heads(x @ p["wq"], n_heads, head_dim)
    k = split_heads(x @ p["wk"], n_kv_heads, head_dim)
    v = split_heads(x @ p["wv"], n_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = chunked_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                            chunk=chunk)
    return sum_partials(merge_heads(out) @ p["wo"])


def _decode_qkv(p, x, pos, n_heads, n_kv_heads, head_dim, rope_theta):
    """The new token's q, k, v [B, 1, H, D] at position `pos`, RoPE'd."""
    B = x.shape[0]
    q = split_heads(x @ p["wq"], n_heads, head_dim)
    k = split_heads(x @ p["wk"], n_kv_heads, head_dim)
    v = split_heads(x @ p["wv"], n_kv_heads, head_dim)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    return apply_rope(q, positions, rope_theta), apply_rope(k, positions, rope_theta), v


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
    q, k, v = _decode_qkv(p, x, pos, n_heads, n_kv_heads, head_dim, rope_theta)
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
    the layer's cache is read up to `pos` + 1.  A sharded cache (DTensors
    placed by `models.sharding.cache_pspecs`) is written and read on its
    shards (`_decode_on_shards`)."""
    if not isinstance(k_all, DTensor):
        out, _, _ = attention_decode_block(
            p, x, k_all[layer], v_all[layer], pos, n_heads=n_heads, n_kv_heads=n_kv_heads,
            head_dim=head_dim, rope_theta=rope_theta, window=window, softcap=softcap)
        return out
    B = x.shape[0]
    q, k, v = _decode_qkv(p, x, pos, n_heads, n_kv_heads, head_dim, rope_theta)
    out = _decode_on_shards(q, k, v, k_all, v_all, layer, pos, window=window, softcap=softcap)
    return sum_partials(out.reshape(B, 1, n_heads * head_dim) @ p["wo"])
