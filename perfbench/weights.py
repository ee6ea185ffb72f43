"""Weights from the seed, made on the device in two large draws.

The engine takes its parameters as a dict of stacked leaves
([n_layers, ...] per leaf): the matmul weights (attention projections,
MLP or expert FFNs) in the serving dtype, the rest (embedding, LM head,
norm scales, router) in float32.  Both draws are one `randn` each over
a flat buffer; every leaf is a view of it, scaled in place as the
model's initialisation scales it (fan-in^-1/2).  Norm scales are drawn
too (x 0.1 around the (1 + scale) identity), so that the comparison
with the reference sees them.

The harness makes these; the program and the reference both read them.
"""

from __future__ import annotations

import torch


def leaf_shapes(arch: dict):
    """(path, shape, scale, matmul?) of every leaf, in draw order."""
    d, V, L = arch["d_model"], arch["vocab_size"], arch["n_layers"]
    Hq, Hkv = arch["n_heads"], arch["n_kv_heads"]
    D = arch.get("head_dim") or d // Hq
    ff, E = arch["d_ff"], arch.get("n_experts", 0)
    out = [
        (("embed",), (V, d), d ** -0.5, False),
        (("final_norm",), (d,), 0.1, False),
        (("layers", "ln1"), (L, d), 0.1, False),
        (("layers", "ln2"), (L, d), 0.1, False),
        (("layers", "attn", "wq"), (L, d, Hq * D), d ** -0.5, True),
        (("layers", "attn", "wk"), (L, d, Hkv * D), d ** -0.5, True),
        (("layers", "attn", "wv"), (L, d, Hkv * D), d ** -0.5, True),
        (("layers", "attn", "wo"), (L, Hq * D, d), (Hq * D) ** -0.5, True),
    ]
    if not arch.get("tie_embeddings", True):
        out.append((("lm_head",), (V, d), d ** -0.5, False))
    if E:
        out += [
            (("layers", "moe", "router"), (L, d, E), d ** -0.5, False),
            (("layers", "moe", "w_gate"), (L, E, d, ff), d ** -0.5, True),
            (("layers", "moe", "w_in"), (L, E, d, ff), d ** -0.5, True),
            (("layers", "moe", "w_out"), (L, E, ff, d), ff ** -0.5, True),
        ]
    else:
        out += [
            (("layers", "mlp", "w_gate"), (L, d, ff), d ** -0.5, True),
            (("layers", "mlp", "w_in"), (L, d, ff), d ** -0.5, True),
            (("layers", "mlp", "w_out"), (L, ff, d), ff ** -0.5, True),
        ]
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_params(arch: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameter dict from `seed`: matmul leaves drawn in `dtype`,
    the rest in float32, by one generator on `device`."""
    leaves = leaf_shapes(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    flats = {}
    for matmul, dt in ((True, dtype), (False, torch.float32)):
        total = sum(_numel(s) for _, s, _, m in leaves if m == matmul)
        flats[matmul] = torch.randn(total, generator=gen, device=device, dtype=dt)
    params: dict = {}
    offs = {True: 0, False: 0}
    for path, shape, scale, matmul in leaves:
        n = _numel(shape)
        leaf = flats[matmul][offs[matmul]: offs[matmul] + n].view(shape)
        leaf.mul_(scale)
        offs[matmul] += n
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params


def param_bytes(params: dict) -> int:
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
