"""Public kernel ops of the port.

Counterpart of `repro/kernels/ops.py:137-297`.  There is no
`impl` switch: each op dispatches on the device of its tensors.  CPU
tensors take the plain PyTorch version; CUDA tensors launch the
hand-written kernel or raise.  No path falls back from the card to the
plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.concurrent import TreeConfig
from repro_torch.core.pool import PoolConfig
from repro_torch.kernels import nbbs_alloc
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.obs.schema import WAVEFRONT_ALLOC_SLOTS, WAVEFRONT_STEP_SLOTS, unpack_slots


def _all_active(levels: torch.Tensor, active: torch.Tensor | None) -> torch.Tensor:
    if active is None:
        return torch.ones(levels.shape[0], dtype=torch.bool, device=levels.device)
    return active


def nbbs_wavefront_alloc(
    cfg: TreeConfig,
    tree: torch.Tensor,
    levels: torch.Tensor,
    *,
    active: torch.Tensor | None = None,
    max_rounds: int = 64,
):
    """Allocation wavefront on one tree (kernel 4 on the card).
    Returns (tree, nodes, ok, stats-dict)."""
    tree, nodes, ok, row = nbbs_alloc.wavefront_alloc(
        cfg, tree, levels, _all_active(levels, active), max_rounds
    )
    return tree, nodes, ok, unpack_slots(WAVEFRONT_ALLOC_SLOTS, row)


def nbbs_wavefront_step(
    cfg: TreeConfig,
    tree: torch.Tensor,
    free_nodes: torch.Tensor,
    free_active: torch.Tensor,
    levels: torch.Tensor,
    *,
    active: torch.Tensor | None = None,
    max_rounds: int = 64,
):
    """Mixed release+allocation round on one tree (kernel 3 on the
    card): the merged release, then the alloc wavefront.  Returns
    (tree, nodes, ok, stats)."""
    tree, nodes, ok, row = nbbs_alloc.wavefront_step(
        cfg, tree, free_nodes, free_active, levels,
        _all_active(levels, active), max_rounds,
    )
    out = unpack_slots(WAVEFRONT_STEP_SLOTS, row)
    out["free_writes"] = out["free_merged_writes"]  # legacy alias
    return tree, nodes, ok, out


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
    return nbbs_alloc.pool_step(
        pcfg, trees, free_nodes, free_shard, free_active, levels,
        _all_active(levels, active), lane_ids, max_rounds,
    )
