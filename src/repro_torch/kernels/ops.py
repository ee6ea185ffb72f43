"""Public kernel ops of the port.

Counterpart of `repro/kernels/ops.py:137-168, 240-297`.  There is no
`impl` switch: each op dispatches on the device of its tensors.  CPU
tensors take the plain PyTorch version; CUDA tensors launch the
hand-written kernel or raise.  No path falls back from the card to the
plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.pool import PoolConfig
from repro_torch.kernels import nbbs_alloc
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401


def nbbs_pool_wavefront_step(
    pcfg: PoolConfig,
    trees: torch.Tensor,
    free_nodes: torch.Tensor,
    free_shard: torch.Tensor,
    free_active: torch.Tensor,
    levels: torch.Tensor,
    *,
    lane_ids: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
    max_rounds: int = 64,
):
    """Pooled mixed release + allocation step across S sharded trees
    (the lockstep router's semantics; one kernel launch on the card).
    Returns (trees, nodes, shard, ok, stats)."""
    if active is None:
        active = torch.ones(levels.shape[0], dtype=torch.bool, device=levels.device)
    return nbbs_alloc.pool_step(
        pcfg, trees, free_nodes, free_shard, free_active, levels, active,
        lane_ids, max_rounds,
    )
