"""Architecture registry: `get_config(name)` resolves any assigned
architecture.  The JAX package's dry-run input specs are not part of the
port (they build `jax.ShapeDtypeStruct`s)."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig

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
