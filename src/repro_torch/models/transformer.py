"""Decoder backbone for all six families: parameters, window array, the
training forward and loss, prefill, the dense cache and its decode step.

Counterpart of `repro/models/transformer.py`.  One backbone, three
family bodies:

  dense/moe/vlm/audio  GQA attention + SwiGLU or MoE, a sliding window
                       per layer (gemma2's local/global alternation).
  hybrid (zamba2)      groups of `attn_every` Mamba2 mixers followed by
                       one *shared* attention block (shared parameters,
                       one KV cache site per group).
  ssm (rwkv6)          RWKV6 time-mix/channel-mix blocks.

Layer parameters are stacked as in the JAX package: on a leading
[n_layers] axis, and the hybrid's Mamba2 layers on [G, attn_every].  The
scan over layers is a Python loop over views; `remat` (JAX's
`jax.checkpoint` on the scan body) checkpoints each scan step with
`torch.utils.checkpoint`: one layer, or one hybrid group (its Mamba2
layers and the shared block, whose parameters enter every group's
checkpoint and collect the sum of the G sites' gradients).

Parameter dtypes: for serving, the matmul weights (`_MATMUL`: attention,
MLP, expert, Mamba2 and RWKV projections) are held in the working dtype;
everything else (embeddings, the LM head, norm scales, the MoE router,
the Mamba2 conv and per-head leaves, the RWKV mixes, decay LoRA and
bonus) stays float32, as the JAX layers read them (`embed` casts the
gathered rows, `logits` works in float32, the router and the decay LoRA
multiply float32 activations, the mixes and decode's conv cast at use).
Training holds every leaf in float32 (master weights) and each layer
body casts its matmul weights (`cast_matmul`), inside the checkpoint,
so the cast copies are recomputed in the backward and not kept.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (
    attention_block,
    attention_decode_stacked,
    chunked_attention,
    init_attention,
    write_prompt_kv,
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
from repro_torch.models.sharding import (
    MeshAxes,
    P,
    act_spec,
    active_mesh,
    batch_divisible,
    cache_pspecs,
    constrain,
    dp_spec,
    like,
    site,
    split_heads,
    sum_partials,
    zeros_on_mesh,
)
from repro_torch.obs.spans import layer_span

# the weights JAX casts to the compute dtype (`.astype(dtype)`) at their matmul
_MATMUL = {"wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out",
           "w_r", "w_k", "w_v", "w_g", "w_o", "cm_k", "cm_v", "cm_r"}


ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")


def _attn_kwargs(cfg: ArchConfig) -> dict:
    return dict(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        softcap=cfg.attn_softcap or None,
    )


def _mamba_kwargs(cfg: ArchConfig) -> dict:
    return dict(d_inner=cfg.d_inner, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)


def cast_matmul(lp: dict, dtype) -> dict:
    """A layer's parameters with the matmul weights in `dtype` (an
    autograd-tracked cast; a no-op where they are in it already)."""
    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return node.to(dtype) if name in _MATMUL else node

    return conv(lp)


def _ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor, dispatch: str,
         axes: Optional[MeshAxes]) -> torch.Tensor:
    """The layer's SwiGLU, or its MoE as prefill and `decode_step` call it:
    drop-free (capacity factor n_experts) unless the config sets a
    serving capacity, `n_blocks` and `group_size` from the config, the
    aux loss dropped."""
    if not cfg.n_experts:
        return apply_swiglu(lp["mlp"], h)
    y, _ = moe_lib.apply_moe(
        lp["moe"], h, top_k=cfg.top_k,
        capacity_factor=cfg.serve_capacity_factor or float(cfg.n_experts),
        dtype=h.dtype, n_blocks=cfg.dispatch_blocks, axes=axes, dispatch=dispatch,
        group_size=cfg.dispatch_group,
    )
    return y


def _stack_into(dst: dict, idx, tree: dict, lead: tuple, device, dtype) -> None:
    """Write one layer's parameters `tree` at `idx` of the stacked leaves
    in `dst`, allocated at the first layer as [*lead, ...]: matmul
    weights in `dtype`, the rest float32."""
    for name, w in tree.items():
        if isinstance(w, dict):
            _stack_into(dst.setdefault(name, {}), idx, w, lead, device, dtype)
            continue
        if name not in dst:
            dst[name] = torch.empty(lead + tuple(w.shape), device=device,
                                    dtype=dtype if name in _MATMUL else torch.float32)
        dst[name][idx] = w


def init_params(cfg: ArchConfig, gen: torch.Generator, device="cuda",
                dtype=torch.float32) -> dict:
    """Random parameters from `gen` (float32 draws; matmul weights then
    cast to `dtype`), built one layer at a time so the float32 copy of
    the whole model never exists at once."""
    d = cfg.d_model
    params: Dict = {
        "embed": init_embedding(gen, cfg.vocab_size, d, device),
        "final_norm": init_rms_norm(d, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_size, d, device)
    if cfg.family in ATTENTION_FAMILIES:
        key, lead = "layers", (cfg.n_layers,)

        def layer():
            p = {"ln1": init_rms_norm(d, device), "ln2": init_rms_norm(d, device),
                 "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, device)}
            if cfg.post_norm:
                p["ln1_post"] = init_rms_norm(d, device)
                p["ln2_post"] = init_rms_norm(d, device)
            if cfg.n_experts:
                p["moe"] = moe_lib.init_moe(gen, d, cfg.d_ff, cfg.n_experts, device)
            else:
                p["mlp"] = init_swiglu(gen, d, cfg.d_ff, device)
            return p
    elif cfg.family == "hybrid":
        key, lead = "groups", (cfg.n_layers // cfg.attn_every, cfg.attn_every)

        def layer():
            return {"ln": init_rms_norm(d, device),
                    "mamba": ssm_lib.init_mamba2(gen, d, cfg.d_inner, cfg.ssm_state,
                                                 cfg.ssm_head_dim, device=device)}
    elif cfg.family == "ssm":
        key, lead = "layers", (cfg.n_layers,)

        def layer():
            return rwkv_lib.init_rwkv6(gen, d, cfg.d_ff, cfg.rwkv_head_dim, device=device)
    else:
        raise ValueError(cfg.family)
    stack: Dict = {}
    for idx in itertools.product(*map(range, lead)):
        # one layer's float32 draws at a time
        _stack_into(stack, idx, layer(), lead, device, dtype)
    params[key] = stack
    if cfg.family == "hybrid":
        params["shared_attn"] = cast_matmul({
            "ln": init_rms_norm(d, device),
            "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                   device),
        }, dtype)
    return params


def params_from_numpy(cfg: ArchConfig, tree, device="cuda",
                      dtype=torch.float32) -> dict:
    """The JAX parameter pytree (leaves moved through `np.asarray`) as the
    port's parameters: matmul weights in `dtype`, the rest float32."""
    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        return t.to(device=device, dtype=dtype if name in _MATMUL else torch.float32)

    return conv(dict(tree))


def layer_params(params: dict, index, key: str = "layers") -> dict:
    """Views of one layer of stacked parameters: `index` an int into
    `params["layers"]`, or a (group, layer) pair with `key="groups"`."""
    def pick(node):
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        return node[index]

    return pick(params[key])


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


def _dense_body(cfg: ArchConfig, axes, carry, xs):
    """One training layer: (x, aux) -> (x, aux).  MoE layers run at the
    training capacity factor and add their aux loss."""
    x, aux = carry
    lp, window = xs
    x = constrain(x, axes, act_spec(axes, "dp", None, None))
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
            dtype=h.dtype, n_blocks=cfg.dispatch_blocks, axes=axes,
            dispatch=cfg.dispatch_mode, group_size=cfg.dispatch_group,
        )
        aux = aux + a
    else:
        h = apply_swiglu(lp["mlp"], h)
    if cfg.post_norm:
        h = rms_norm(h, lp["ln2_post"], cfg.norm_eps)
    return x + h, aux


def _hybrid_body(cfg: ArchConfig, axes, shared: dict, carry, gp):
    """One training group: `attn_every` Mamba2 layers (`gp`'s leaves
    [attn_every, ...]), then the shared attention block."""
    x, aux = carry
    x = constrain(x, axes, act_spec(axes, "dp", None, None))
    gp = cast_matmul(gp, x.dtype)
    shared = cast_matmul(shared, x.dtype)
    for lp in _unstack(gp, cfg.attn_every):
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        x = x + ssm_lib.apply_mamba2(lp["mamba"], h, **_mamba_kwargs(cfg))
    h = rms_norm(x, shared["ln"], cfg.norm_eps)
    h = attention_block(shared["attn"], h, window=None, **_attn_kwargs(cfg))
    return x + h, aux


def _ssm_body(cfg: ArchConfig, axes, carry, lp):
    x, aux = carry
    x = constrain(x, axes, act_spec(axes, "dp", None, None))
    x, _ = rwkv_lib.apply_rwkv6(cast_matmul(lp, x.dtype), x, head_dim=cfg.rwkv_head_dim)
    return x, aux


def forward(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
            axes: Optional[MeshAxes] = None, remat: bool = False):
    """x: [B, S, d] embedded inputs -> (hidden [B, S, d], aux loss).
    With `axes`, parameters and `x` are DTensors on the current mesh."""
    if cfg.family in ATTENTION_FAMILIES:
        body = functools.partial(_dense_body, cfg, axes)
        steps = zip(_unstack(params["layers"], cfg.n_layers), window_array(cfg))
    elif cfg.family == "hybrid":
        body = functools.partial(_hybrid_body, cfg, axes, params["shared_attn"])
        steps = _unstack(params["groups"], cfg.n_layers // cfg.attn_every)
    elif cfg.family == "ssm":
        body = functools.partial(_ssm_body, cfg, axes)
        steps = _unstack(params["layers"], cfg.n_layers)
    else:
        raise ValueError(cfg.family)
    carry = (x, like(torch.zeros((), dtype=torch.float32, device=x.device), x))
    for xs in steps:
        if remat:
            carry = checkpoint(body, carry, xs, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            carry = body(carry, xs)
    x, aux = carry
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _embed_inputs(cfg: ArchConfig, params: dict, batch: dict, dtype) -> torch.Tensor:
    if cfg.frontend != "none" and "embeds" in batch:
        # Modality frontend is a stub: precomputed frame/patch embeddings.
        return batch["embeds"].to(dtype)
    return embed(params["embed"], batch["tokens"], dtype, scale=cfg.embed_scale)


def train_loss(cfg: ArchConfig, params: dict, batch: dict, *,
               axes: Optional[MeshAxes] = None, dtype=torch.bfloat16,
               remat: bool = True) -> torch.Tensor:
    """Mean token cross-entropy (z-loss 1e-4) plus 0.01 x the MoE aux
    loss; `batch` holds "labels" [B, S] and "tokens" [B, S] or, for the
    stub frontends, "embeds" [B, S, d].  With `axes`, the parameters and
    the batch are DTensors on the current mesh (`models.sharding`,
    `data.pipeline.place_on_mesh`) and so is the loss."""
    x = _embed_inputs(cfg, params, batch, dtype)
    x = constrain(x, axes, act_spec(axes, "dp", None, None))
    h, aux = forward(cfg, params, x, axes=axes, remat=remat)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    lg = lm_logits(h, table, cfg.final_softcap or None)
    lg = constrain(lg, axes, act_spec(axes, "dp", None, "tp"))
    return cross_entropy(lg, batch["labels"]) + 0.01 * aux


def _attention_prefill(cfg: ArchConfig, ap: dict, h: torch.Tensor,
                       positions: torch.Tensor, window):
    """One attention site over the prompt: h [B, S, d] -> (out [B, S, d],
    k, v [B, S, Hkv, D] for the cache)."""
    B, S, _ = h.shape
    q = split_heads(h @ ap["wq"], cfg.n_heads, cfg.head_dim)
    k = split_heads(h @ ap["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(h @ ap["wv"], cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap or None)
    return sum_partials(o.reshape(B, S, -1) @ ap["wo"]), k, v


def _write(slots: dict, new: dict) -> None:
    """Copy a layer's new state into its cache slots, in place.  A slot
    on a sharded cache (`models.sharding.site`) is written on its local
    shard, the new state first placed as the slot is: a local region,
    since DTensor's `copy_` need not write through a view."""
    for k, a in slots.items():
        if isinstance(a, DTensor):
            b = like(new[k], a).redistribute(a.device_mesh, a.placements)
            a.to_local().copy_(b.to_local())
        else:
            a.copy_(new[k])


def _slots(tree: dict, index) -> dict:
    """One site's views of the stacked state leaves in `tree`."""
    return {k: site(a, index) for k, a in tree.items()}


def _logits_spec(axes: MeshAxes, batch: int) -> tuple:
    """Where the serving logits [B, V] go: B on dp when it divides, V on
    tp (JAX dryrun's prefill and decode `out_shardings`)."""
    div = batch_divisible(batch, active_mesh(), axes)
    return P(dp_spec(axes) if div else None, axes.tp)


def prefill(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    max_len: int,
    *,
    axes: Optional[MeshAxes] = None,
    dtype=torch.bfloat16,
):
    """Process the prompt; returns (last-token logits [B, V] float32,
    the `init_cache` tree filled: K/V in `dtype` up to S, the hybrid's
    Mamba2 states and the RWKV states exact at the last token, "pos": S).
    The stub frontends take `batch["embeds"]` [B, S, d] where it is given.

    With `axes`, the parameters are DTensors on the current mesh
    (`param_specs` + `shard_tree`) and the batch is plain or placed by
    `batch_specs`; the inputs are constrained as JAX's (`:492`), the MoE
    layers take `axes`, the cache is made placed by `cache_pspecs`
    (`init_cache(axes=...)`) and written on its shards, and the logits
    come out placed as JAX's dry run places prefill's: B on dp (when it
    divides), V on tp.  Their values are the unsharded ones."""
    x = _embed_inputs(cfg, params, batch, dtype)
    x = constrain(x, axes, act_spec(axes, "dp", None, None))
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, device=dev)[None, :]
    cache = init_cache(cfg, B, max_len, dtype, dev, axes=axes)
    if cfg.family in ATTENTION_FAMILIES:
        for li, window in enumerate(window_array(cfg)):
            lp = layer_params(params, li)
            with layer_span("attention"):
                h, k, v = _attention_prefill(cfg, lp["attn"],
                                             rms_norm(x, lp["ln1"], cfg.norm_eps), positions,
                                             window)
                if cfg.post_norm:
                    h = rms_norm(h, lp["ln1_post"], cfg.norm_eps)
                x = x + h
            with layer_span("ffn"):
                h = _ffn(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg.dispatch_mode, axes)
                if cfg.post_norm:
                    h = rms_norm(h, lp["ln2_post"], cfg.norm_eps)
                x = x + h
            write_prompt_kv(cache["k"], li, k)
            write_prompt_kv(cache["v"], li, v)
    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        for g in range(cfg.n_layers // cfg.attn_every):
            # Mamba2 layers: chunked forward, exact final state captured
            for i in range(cfg.attn_every):
                lp = layer_params(params, (g, i), "groups")
                h, st = ssm_lib.apply_mamba2(lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps),
                                             return_state=True, **_mamba_kwargs(cfg))
                x = x + h
                _write(_slots(cache["mamba"], (g, i)), st)
            h, k, v = _attention_prefill(cfg, shared["attn"],
                                         rms_norm(x, shared["ln"], cfg.norm_eps), positions,
                                         None)
            x = x + h
            write_prompt_kv(cache["k"], g, k)
            write_prompt_kv(cache["v"], g, v)
    elif cfg.family == "ssm":
        for li in range(cfg.n_layers):
            x, st = rwkv_lib.apply_rwkv6(layer_params(params, li), x,
                                         head_dim=cfg.rwkv_head_dim)
            _write(_slots(cache["rwkv"], li), st)
    else:
        raise ValueError(cfg.family)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    lg = lm_logits(h[:, -1], table, cfg.final_softcap or None)
    if axes is not None:
        lg = constrain(lg, axes, _logits_spec(axes, B))
    return lg, dict(cache, pos=S)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", *, axes: Optional[MeshAxes] = None) -> dict:
    """Dense decode cache, zeros; "pos" (a Python int) is the current
    context length.  Attention families: "k", "v" [L, batch, max_len, Hkv,
    D] in `dtype`.  Hybrid: "k", "v" with one site per group [G, ...] and
    "mamba" {"ssm" [G, attn_every, batch, H, N, P] float32, "conv" [G,
    attn_every, batch, d_conv - 1, conv_dim] in `dtype`}.  Ssm: "rwkv"
    {"tm_x", "cm_x" [L, batch, d], "wkv" [L, batch, H, P, P]}, float32.
    Every site has its own memory (JAX broadcasts one zero state; the
    port writes states in place).  With `axes`, every leaf is a DTensor
    on the current mesh placed by `models.sharding.cache_pspecs` (`B`
    divisible over dp or not, as the mesh says), each rank holding only
    its shard (`device` is then the mesh's)."""
    if axes is not None:
        mesh = active_mesh()
        shapes = init_cache(cfg, batch, max_len, dtype, "meta")
        specs = cache_pspecs(cfg, shapes, dp_spec(axes), axes.tp,
                             batch_divisible(batch, mesh, axes))
        return zeros_on_mesh(shapes, specs, mesh)

    def kv(sites):
        shape = (sites, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return torch.zeros(shape, dtype=dtype, device=device)

    def stacked(lead, state):
        return {k: a.new_zeros(lead + tuple(a.shape)) for k, a in state.items()}

    cache: Dict = {"pos": 0}
    if cfg.family in ATTENTION_FAMILIES:
        cache["k"], cache["v"] = kv(cfg.n_layers), kv(cfg.n_layers)
    elif cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        cache["k"], cache["v"] = kv(G), kv(G)
        cache["mamba"] = stacked((G, cfg.attn_every), ssm_lib.init_mamba2_state(
            batch, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim, dtype=dtype,
            device=device))
    elif cfg.family == "ssm":
        cache["rwkv"] = stacked((cfg.n_layers,), rwkv_lib.init_rwkv6_state(
            batch, cfg.d_model, cfg.rwkv_head_dim, device=device))
    else:
        raise ValueError(cfg.family)
    return cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor, *,
                axes: Optional[MeshAxes] = None, dtype=torch.bfloat16):
    """One decode step over the dense cache.  tokens: [B] -> (logits [B, V]
    float32, cache with "pos" + 1).  The new token's K/V and every layer's
    new Mamba2 / RWKV state are written into the cache in place (the torch
    form of the JAX scan's carried cache).  MoE layers take the scatter
    dispatch always.

    With `axes`, the parameters are DTensors on the current mesh and the
    cache is placed by `models.sharding.cache_pspecs` (as `prefill` or
    `init_cache(axes=...)` give it; JAX's `in_shardings`).  The token's
    embedding and the logits are constrained as JAX's (`:328`, `:459`,
    the logits then placed as the dry run's `out_shardings`), the MoE
    layers take `axes`, and every cache leaf is written on its local
    shard, so it leaves the step in the placements it came in with (JAX's
    donated cache).  "pos" stays a Python int."""
    pos = cache["pos"]
    x = embed(params["embed"], tokens[:, None], dtype, scale=cfg.embed_scale)
    x = constrain(x, axes, act_spec(axes, "dp", None, None))
    if cfg.family in ATTENTION_FAMILIES:
        for li, window in enumerate(window_array(cfg)):
            lp = layer_params(params, li)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            h = attention_decode_stacked(lp["attn"], h, cache["k"], cache["v"], li, pos,
                                         window=window, **_attn_kwargs(cfg))
            if cfg.post_norm:
                h = rms_norm(h, lp["ln1_post"], cfg.norm_eps)
            x = x + h
            h = _ffn(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps), "scatter", axes)
            if cfg.post_norm:
                h = rms_norm(h, lp["ln2_post"], cfg.norm_eps)
            x = x + h
    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        for g in range(cfg.n_layers // cfg.attn_every):
            for i in range(cfg.attn_every):
                lp = layer_params(params, (g, i), "groups")
                slots = _slots(cache["mamba"], (g, i))
                h, st = ssm_lib.apply_mamba2_decode(
                    lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), slots,
                    **_mamba_kwargs(cfg))
                x = x + h
                _write(slots, st)
            h = rms_norm(x, shared["ln"], cfg.norm_eps)
            x = x + attention_decode_stacked(shared["attn"], h, cache["k"], cache["v"], g,
                                             pos, window=None, **_attn_kwargs(cfg))
    elif cfg.family == "ssm":
        for li in range(cfg.n_layers):
            slots = _slots(cache["rwkv"], li)
            x, st = rwkv_lib.apply_rwkv6(layer_params(params, li), x,
                                         head_dim=cfg.rwkv_head_dim, state=slots)
            _write(slots, st)
    else:
        raise ValueError(cfg.family)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    lg = lm_logits(h[:, 0], table, cfg.final_softcap or None)
    if axes is not None:
        lg = constrain(lg, axes, _logits_spec(axes, tokens.shape[0]))
    return lg, dict(cache, pos=pos + 1)
