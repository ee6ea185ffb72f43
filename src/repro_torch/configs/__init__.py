"""Assigned-architecture configs (one module per arch) + registry."""

from repro_torch.configs.base import ArchConfig, ShapeSpec, lm_shapes  # noqa: F401
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_NAMES,
    all_configs,
    cache_specs,
    get_config,
    input_specs,
)
