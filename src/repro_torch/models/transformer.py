"""Dense decoder backbone: parameters, window array and prefill.

Counterpart of `repro/models/transformer.py:68-141, 469-546` for the
dense family (the other families come with later slices).  Layer
parameters are stacked on a leading [n_layers] axis as in the JAX
package, and the scan over layers is a Python loop over views.

Parameter dtypes: the matmul weights (attention and MLP projections) are
held in the working dtype; embeddings, the LM head and the norm scales
stay float32, as the JAX layers read them (`embed` casts the gathered
rows, `logits` works in float32).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import chunked_attention, init_attention
from repro_torch.models.layers import (
    apply_rope,
    apply_swiglu,
    embed,
    init_embedding,
    init_rms_norm,
    init_swiglu,
    logits as lm_logits,
    rms_norm,
)

_MATMUL = {"wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out"}


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "vlm", "audio") or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the port has the dense family only; MoE and the "
            "other families come with a later slice"
        )


def init_params(cfg: ArchConfig, gen: torch.Generator, device="cuda",
                dtype=torch.float32) -> dict:
    """Random parameters from `gen` (float32 draws; matmul weights then
    cast to `dtype`), built one layer at a time so the float32 copy of
    the whole model never exists at once."""
    _check_dense(cfg)
    L, d = cfg.n_layers, cfg.d_model
    params: Dict = {
        "embed": init_embedding(gen, cfg.vocab_size, d, device),
        "final_norm": init_rms_norm(d, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_size, d, device)
    layers: Dict = {
        "ln1": torch.zeros((L, d), dtype=torch.float32, device=device),
        "ln2": torch.zeros((L, d), dtype=torch.float32, device=device),
        "attn": {},
        "mlp": {},
    }
    if cfg.post_norm:
        layers["ln1_post"] = torch.zeros((L, d), dtype=torch.float32, device=device)
        layers["ln2_post"] = torch.zeros((L, d), dtype=torch.float32, device=device)
    for li in range(L):
        blocks = {
            "attn": init_attention(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, device
            ),
            "mlp": init_swiglu(gen, d, cfg.d_ff, device),
        }
        for group, ws in blocks.items():
            for name, w in ws.items():
                if li == 0:
                    layers[group][name] = torch.empty(
                        (L,) + tuple(w.shape), dtype=dtype, device=device
                    )
                layers[group][name][li] = w.to(dtype)
    params["layers"] = layers
    return params


def params_from_numpy(cfg: ArchConfig, tree, device="cuda",
                      dtype=torch.float32) -> dict:
    """The JAX parameter pytree (leaves moved through `np.asarray`) as the
    port's parameters: matmul weights in `dtype`, the rest float32."""
    _check_dense(cfg)

    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        return t.to(device=device, dtype=dtype if name in _MATMUL else torch.float32)

    return conv(dict(tree))


def layer_params(params: dict, li: int) -> dict:
    """Views of layer `li` of the stacked layer parameters."""
    def pick(node):
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        return node[li]

    return pick(params["layers"])


def window_array(cfg: ArchConfig) -> list:
    """Per-layer sliding window sizes (0 = global), cycled pattern."""
    if not cfg.window_pattern:
        return [0] * cfg.n_layers
    pat = list(cfg.window_pattern)
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def prefill(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    max_len: int,
    *,
    dtype=torch.bfloat16,
):
    """Process the prompt; returns (last-token logits [B, V] float32,
    cache {"k", "v": [L, B, max_len, Hkv, D] in `dtype`, "pos"})."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = embed(params["embed"], tokens, dtype, scale=cfg.embed_scale)
    positions = torch.arange(S, device=dev)[None, :]
    kv_shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache_k = torch.zeros(kv_shape, dtype=dtype, device=dev)
    cache_v = torch.zeros(kv_shape, dtype=dtype, device=dev)
    softcap = cfg.attn_softcap or None
    for li, window in enumerate(window_array(cfg)):
        lp = layer_params(params, li)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = (h @ lp["attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = (h @ lp["attn"]["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lp["attn"]["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = chunked_attention(q, k, v, causal=True, window=window, softcap=softcap)
        h = o.reshape(B, S, -1) @ lp["attn"]["wo"]
        if cfg.post_norm:
            h = rms_norm(h, lp["ln1_post"], cfg.norm_eps)
        x = x + h
        h = apply_swiglu(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        if cfg.post_norm:
            h = rms_norm(h, lp["ln2_post"], cfg.norm_eps)
        x = x + h
        cache_k[li, :, :S] = k
        cache_v[li, :, :S] = v
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    lg = lm_logits(h[:, -1], table, cfg.final_softcap or None)
    return lg, {"k": cache_k, "v": cache_v, "pos": S}
