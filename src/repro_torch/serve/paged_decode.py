"""Paged decode step: the full-model consumer of the NBBS page pool.

Counterpart of `repro/serve/paged_decode.py`, for the attention
families (dense, moe, vlm, audio); it refuses the hybrid and ssm
families, as JAX's step does.  The KV cache lives in a global page
pool [L, P+1, page, Hkv, D] addressed through per-sequence block tables.  Each step computes this token's K/V
per layer, writes them into the page/slot the table gives, and attends
over the pages with `kernels.ops.paged_attention`.

The pool carries one extra *sink page* at index P.  The JAX step sends
the writes of inactive lanes to page P and drops them with
`mode="drop"`; torch indexing has no drop mode, so those writes land in
the sink page instead, which no block table maps.  `init_pool` builds
the sink page; compare `pool[:, :P]` with the JAX pool.

The step writes the pool in place (the torch form of the donated JAX
buffers) and synchronises nothing with the host.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    apply_rope,
    apply_swiglu,
    embed,
    logits as lm_logits,
    rms_norm,
)
from repro_torch.models.transformer import (
    ATTENTION_FAMILIES,
    layer_params,
    prefill,
    window_array,
)


def serve_prefill(cfg: ArchConfig, params, batch, *, max_len, dtype):
    """Prefill for the serving engine (prompts padded to power-of-two
    buckets by the caller)."""
    return prefill(cfg, params, batch, max_len, dtype=dtype)


def init_pool(cfg: ArchConfig, num_pages: int, page_tokens: int,
              dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero KV pool of `num_pages` pages plus the sink page."""
    shape = (cfg.n_layers, num_pages + 1, page_tokens, cfg.n_kv_heads,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def paged_decode_step(
    cfg: ArchConfig,
    params: dict,
    pool: dict,
    block_tables: torch.Tensor,   # int32[B, max_pages], -1 padded
    context_lens: torch.Tensor,   # int32[B], tokens already in cache
    tokens: torch.Tensor,         # int32[B], the new token per sequence
    *,
    page_tokens: int,
    dtype=torch.bfloat16,
    active: torch.Tensor | None = None,  # bool[B]; None = all lanes live
):
    """Returns logits [B, V] (float32); `pool` is updated in place.  MoE
    layers run drop-free (capacity factor n_experts) with the scatter
    dispatch in one block, as JAX's paged step calls them."""
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError("paged decode covers attention families; SSM/hybrid use "
                         "fixed-size state slots (see docs/design.md §5)")
    B = tokens.shape[0]
    P = pool["k"].shape[1] - 1          # the last page is the sink
    MP = block_tables.shape[1]
    dev = tokens.device
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
    x = embed(params["embed"], tokens[:, None], dtype, scale=cfg.embed_scale)
    positions = context_lens[:, None]

    # page/slot of the new token per sequence; inactive lanes and lanes
    # with no page mapped at this position write to the sink page.  The
    # column is clamped the way an out-of-range JAX gather clamps it.
    col = (context_lens // page_tokens).clamp(0, MP - 1).long()
    page_raw = block_tables[torch.arange(B, device=dev), col]
    page_idx = torch.where(active & (page_raw >= 0), page_raw, P).long()
    slot = (context_lens % page_tokens).long()
    ctx_att = torch.where(active, context_lens + 1, 0).to(torch.int32)
    softcap = cfg.attn_softcap or None

    for li, window in enumerate(window_array(cfg)):
        lp = layer_params(params, li)
        kp, vp = pool["k"][li], pool["v"][li]   # [P+1, page, Hkv, D] views
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = (h @ lp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        k = (h @ lp["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lp["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kp[page_idx, slot] = k[:, 0]
        vp[page_idx, slot] = v[:, 0]
        o = ops.paged_attention(
            q[:, 0], kp, vp, block_tables, ctx_att, softcap=softcap,
        )
        # As in the JAX step, the sliding window is not applied here
        # (window-limited layers would need the context clamped).
        del window
        h = o.reshape(B, 1, -1) @ lp["attn"]["wo"]
        if cfg.post_norm:
            h = rms_norm(h, lp["ln1_post"], cfg.norm_eps)
        x = x + h
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.n_experts:
            h, _ = moe_lib.apply_moe(
                lp["moe"], h, top_k=cfg.top_k,
                capacity_factor=float(cfg.n_experts), dtype=dtype,
            )
        else:
            h = apply_swiglu(lp["mlp"], h)
        if cfg.post_norm:
            h = rms_norm(h, lp["ln2_post"], cfg.norm_eps)
        x = x + h
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return lm_logits(h[:, 0], table, cfg.final_softcap or None)
