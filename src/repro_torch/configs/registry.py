"""Architecture registry + dry-run input specs.

`get_config(name)` resolves any assigned architecture (`--arch <id>`);
`input_specs(cfg, shape)` and `cache_specs(cfg, shape)` build the
stand-ins for every model input of an (arch x shape) dry-run cell, the
counterparts of JAX's `jax.ShapeDtypeStruct` trees: tensors on the
"meta" device (shape and dtype, no storage), or, under a
`FakeTensorMode`, fake tensors of the device the caller names.  Nothing
is allocated either way.
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec

_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a66b",
    "zamba2-1.2b": "zamba2_1p2b",
    "phi3-medium-14b": "phi3_medium_14b",
    "minitron-4b": "minitron_4b",
    "gemma2-27b": "gemma2_27b",
    "stablelm-3b": "stablelm_3b",
    "llava-next-34b": "llava_next_34b",
    "musicgen-large": "musicgen_large",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


# ---------------------------------------------------------------------------
# Dry-run input specs (meta or fake tensors only: nothing is allocated)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeSpec, dtype=torch.bfloat16,
                device="meta") -> dict:
    """Model inputs for one dry-run cell.

    train:   {tokens|embeds, labels}
    prefill: {tokens|embeds}
    decode:  {tokens [B]} (the KV cache is built by cache_specs below)
    """
    B, S = shape.global_batch, shape.seq_len

    def f(dims, dt):
        return torch.empty(dims, dtype=dt, device=device)

    if shape.kind == "train":
        batch = {"labels": f((B, S), torch.int32)}
        if cfg.frontend != "none":
            batch["embeds"] = f((B, S, cfg.d_model), dtype)
        else:
            batch["tokens"] = f((B, S), torch.int32)
        return batch
    if shape.kind == "prefill":
        if cfg.frontend != "none":
            return {"embeds": f((B, S, cfg.d_model), dtype)}
        return {"tokens": f((B, S), torch.int32)}
    if shape.kind == "decode":
        return {"tokens": f((B,), torch.int32)}
    raise ValueError(shape.kind)


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, dtype=torch.bfloat16,
                device="meta") -> dict:
    """The decode cache of a shape cell, as `models.transformer.init_cache`
    builds it, on `device` ("pos" is the Python int 0, where JAX's is an
    int32 scalar)."""
    from repro_torch.models.transformer import init_cache

    return init_cache(cfg, shape.global_batch, shape.seq_len, dtype, device)
