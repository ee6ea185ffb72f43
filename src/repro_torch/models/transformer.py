"""Decoder backbone of the attention families: parameters, window
array, the training forward and loss, prefill, the dense KV cache and
its decode step.

Counterpart of `repro/models/transformer.py` for the families whose
layers are GQA attention followed by SwiGLU or MoE (dense, moe, vlm,
audio); hybrid and ssm come with a later slice.  Layer parameters are
stacked on a leading [n_layers] axis as in the JAX package, and the scan
over layers is a Python loop over views; `remat` (JAX's
`jax.checkpoint` on the scan body) checkpoints each layer with
`torch.utils.checkpoint`.

Parameter dtypes: for serving, the matmul weights (attention, MLP and
expert projections) are held in the working dtype; embeddings, the LM
head, the norm scales and the MoE router stay float32, as the JAX layers
read them (`embed` casts the gathered rows, `logits` works in float32,
the router multiplies float32 activations).  Training holds every leaf
in float32 (master weights) and each layer body casts its matmul
weights (`cast_matmul`), inside the checkpoint, so the cast copies are
recomputed in the backward and not kept.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (
    attention_block,
    attention_decode_stacked,
    chunked_attention,
    init_attention,
)
from repro_torch.models.layers import (
    apply_rope,
    apply_swiglu,
    cross_entropy,
    embed,
    init_embedding,
    init_rms_norm,
    init_swiglu,
    logits as lm_logits,
    rms_norm,
)

_MATMUL = {"wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out"}


ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")


def check_family(cfg: ArchConfig) -> None:
    """Refuse the families the port does not have yet."""
    if cfg.family not in ATTENTION_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port has the attention families "
            f"({', '.join(ATTENTION_FAMILIES)}) only; the {cfg.family} family "
            "comes with a later slice"
        )


def _attn_kwargs(cfg: ArchConfig) -> dict:
    return dict(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        softcap=cfg.attn_softcap or None,
    )


def cast_matmul(lp: dict, dtype) -> dict:
    """A layer's parameters with the matmul weights in `dtype` (an
    autograd-tracked cast; a no-op where they are in it already)."""
    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return node.to(dtype) if name in _MATMUL else node

    return conv(lp)


def _ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor, dispatch: str) -> torch.Tensor:
    """The layer's SwiGLU, or its MoE as prefill and `decode_step` call it:
    drop-free (capacity factor n_experts) unless the config sets a
    serving capacity, `n_blocks` and `group_size` from the config, the
    aux loss dropped."""
    if not cfg.n_experts:
        return apply_swiglu(lp["mlp"], h)
    y, _ = moe_lib.apply_moe(
        lp["moe"], h, top_k=cfg.top_k,
        capacity_factor=cfg.serve_capacity_factor or float(cfg.n_experts),
        dtype=h.dtype, n_blocks=cfg.dispatch_blocks, dispatch=dispatch,
        group_size=cfg.dispatch_group,
    )
    return y


def init_params(cfg: ArchConfig, gen: torch.Generator, device="cuda",
                dtype=torch.float32) -> dict:
    """Random parameters from `gen` (float32 draws; matmul weights then
    cast to `dtype`), built one layer at a time so the float32 copy of
    the whole model never exists at once."""
    check_family(cfg)
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
        "moe" if cfg.n_experts else "mlp": {},
    }
    if cfg.post_norm:
        layers["ln1_post"] = torch.zeros((L, d), dtype=torch.float32, device=device)
        layers["ln2_post"] = torch.zeros((L, d), dtype=torch.float32, device=device)
    for li in range(L):
        blocks = {
            "attn": init_attention(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, device
            ),
        }
        if cfg.n_experts:
            blocks["moe"] = moe_lib.init_moe(gen, d, cfg.d_ff, cfg.n_experts, device)
        else:
            blocks["mlp"] = init_swiglu(gen, d, cfg.d_ff, device)
        for group, ws in blocks.items():
            for name, w in ws.items():
                if li == 0:
                    layers[group][name] = torch.empty(
                        (L,) + tuple(w.shape), device=device,
                        dtype=dtype if name in _MATMUL else torch.float32,
                    )
                layers[group][name][li] = w
        del blocks   # this layer's float32 draws, before the next layer's
    params["layers"] = layers
    return params


def params_from_numpy(cfg: ArchConfig, tree, device="cuda",
                      dtype=torch.float32) -> dict:
    """The JAX parameter pytree (leaves moved through `np.asarray`) as the
    port's parameters: matmul weights in `dtype`, the rest float32."""
    check_family(cfg)

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


def _unstack(tree, n: int) -> list:
    """Per-layer views of stacked parameters, by one `unbind` per leaf:
    its backward stacks the layers' gradients once, where indexing each
    layer would add a zero-filled gradient of the whole stack per layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def _dense_body(cfg: ArchConfig, carry, xs):
    """One training layer: (x, aux) -> (x, aux).  MoE layers run at the
    training capacity factor and add their aux loss."""
    x, aux = carry
    lp, window = xs
    lp = cast_matmul(lp, x.dtype)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h = attention_block(lp["attn"], h, window=window, **_attn_kwargs(cfg))
    if cfg.post_norm:
        h = rms_norm(h, lp["ln1_post"], cfg.norm_eps)
    x = x + h
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        h, a = moe_lib.apply_moe(
            lp["moe"], h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            dtype=h.dtype, n_blocks=cfg.dispatch_blocks, dispatch=cfg.dispatch_mode,
            group_size=cfg.dispatch_group,
        )
        aux = aux + a
    else:
        h = apply_swiglu(lp["mlp"], h)
    if cfg.post_norm:
        h = rms_norm(h, lp["ln2_post"], cfg.norm_eps)
    return x + h, aux


def forward(cfg: ArchConfig, params: dict, x: torch.Tensor, *, remat: bool = False):
    """x: [B, S, d] embedded inputs -> (hidden [B, S, d], aux loss)."""
    check_family(cfg)
    carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
    for lp, window in zip(_unstack(params["layers"], cfg.n_layers), window_array(cfg)):
        if remat:
            carry = checkpoint(_dense_body, cfg, carry, (lp, window),
                               use_reentrant=False, preserve_rng_state=False)
        else:
            carry = _dense_body(cfg, carry, (lp, window))
    x, aux = carry
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _embed_inputs(cfg: ArchConfig, params: dict, batch: dict, dtype) -> torch.Tensor:
    if cfg.frontend != "none" and "embeds" in batch:
        # Modality frontend is a stub: precomputed frame/patch embeddings.
        return batch["embeds"].to(dtype)
    return embed(params["embed"], batch["tokens"], dtype, scale=cfg.embed_scale)


def train_loss(cfg: ArchConfig, params: dict, batch: dict, *, dtype=torch.bfloat16,
               remat: bool = True) -> torch.Tensor:
    """Mean token cross-entropy (z-loss 1e-4) plus 0.01 x the MoE aux
    loss; `batch` holds "labels" [B, S] and "tokens" [B, S] or, for the
    stub frontends, "embeds" [B, S, d]."""
    check_family(cfg)
    x = _embed_inputs(cfg, params, batch, dtype)
    h, aux = forward(cfg, params, x, remat=remat)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    lg = lm_logits(h, table, cfg.final_softcap or None)
    return cross_entropy(lg, batch["labels"]) + 0.01 * aux


def prefill(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    max_len: int,
    *,
    dtype=torch.bfloat16,
):
    """Process the prompt; returns (last-token logits [B, V] float32,
    cache {"k", "v": [L, B, max_len, Hkv, D] in `dtype`, "pos": S}).  The
    stub frontends take `batch["embeds"]` [B, S, d] where it is given."""
    check_family(cfg)
    x = _embed_inputs(cfg, params, batch, dtype)
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, device=dev)[None, :]
    cache = init_cache(cfg, B, max_len, dtype, dev)
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
        h = _ffn(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg.dispatch_mode)
        if cfg.post_norm:
            h = rms_norm(h, lp["ln2_post"], cfg.norm_eps)
        x = x + h
        cache["k"][li, :, :S] = k
        cache["v"][li, :, :S] = v
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    lg = lm_logits(h[:, -1], table, cfg.final_softcap or None)
    return lg, dict(cache, pos=S)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """Dense decode cache {"k", "v": [L, batch, max_len, Hkv, D] zeros,
    "pos": 0}; "pos" (a Python int) is the current context length."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "pos": 0,
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor, *,
                dtype=torch.bfloat16):
    """One decode step over the dense cache.  tokens: [B] -> (logits [B, V]
    float32, cache with "pos" + 1).  The new token's K/V is written into
    `cache["k"]` / `cache["v"]` in place (the torch form of the JAX scan's
    carried cache).  MoE layers take the scatter dispatch always."""
    check_family(cfg)
    pos = cache["pos"]
    x = embed(params["embed"], tokens[:, None], dtype, scale=cfg.embed_scale)
    for li, window in enumerate(window_array(cfg)):
        lp = layer_params(params, li)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        h = attention_decode_stacked(lp["attn"], h, cache["k"], cache["v"], li, pos,
                                     window=window, **_attn_kwargs(cfg))
        if cfg.post_norm:
            h = rms_norm(h, lp["ln1_post"], cfg.norm_eps)
        x = x + h
        h = _ffn(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps), "scatter")
        if cfg.post_norm:
            h = rms_norm(h, lp["ln2_post"], cfg.norm_eps)
        x = x + h
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    lg = lm_logits(h[:, 0], table, cfg.final_softcap or None)
    return lg, dict(cache, pos=pos + 1)
