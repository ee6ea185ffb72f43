"""AdamW with global-norm clipping and warmup-cosine schedule.

Counterpart of `repro/optim/adamw.py`.  The state is tree-shaped like
the parameters.  Where JAX builds new trees (and donates the old ones),
`update` works in place, one leaf at a time, under `torch.no_grad()`:
at stablelm-3b's full width one float32 copy of the parameters is 11.2
GB, and new parameters, m and v for the whole tree beside the old would
not fit the card beside its gradients.  The arithmetic is JAX's, in
float32 and in its order: the schedule and the bias corrections are
float32 tensors, the clip is min(1, clip / (norm + 1e-9)), and the decay
joins the update before the learning rate scales it.

Sharded leaves (DTensors, each gradient in its parameter's placement):
the global norm is one reduction over the mesh, and every other step
is elementwise, so each rank updates its local shards in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from torch.distributed.tensor import DTensor

from repro_torch.tree_util import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, []
    m: object            # tree like params
    v: object


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at `step` (an int32 tensor or an int), float32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = (step / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    t = ((step - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * warm * frac


def init(params) -> AdamWState:
    dev = leaves(params)[0].device
    zeros = lambda: tree_map(
        lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format), params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage: in-place updates land in
    the DTensor), a plain tensor itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def global_norm(tree) -> torch.Tensor:
    """The norm over every leaf; a plain tensor, the same on every rank."""
    norm = torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))
    return norm.full_tensor() if isinstance(norm, DTensor) else norm


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (params, state, metrics).  `params`, `state.m` and
    `state.v` are updated in place and returned; `grads` is consumed
    (its float32 leaves are overwritten)."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = (cfg.clip_norm / (gnorm + 1e-9)).clamp(max=1.0)
    step = state.step + 1
    lr = schedule(cfg, _local(step))
    b1c = 1 - cfg.b1 ** _local(step).float()
    b2c = 1 - cfg.b2 ** _local(step).float()
    for p, g, m, v in zip(*(map(_local, leaves(t))
                            for t in (params, grads, state.m, state.v))):
        g = g.float()
        if scale is not None:
            g.mul_(scale)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        # decay matrices only, by JAX's rule: the stacked [L, d] norm
        # scales and [L, d, E] routers have ndim >= 2 and are decayed too
        if p.ndim >= 2:
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - delta.mul_(lr))
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
