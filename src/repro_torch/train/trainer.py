"""Training step + driver loop.

Counterpart of `repro/train/trainer.py`.  `make_train_step` builds the
step for any config of the six families: gradient accumulation
over microbatches (the float32 gradient sum over them, then divided by
their count, as JAX's scan does), per-layer remat
(`torch.utils.checkpoint` inside the model's loop), optional
error-feedback int8 gradient compression and `cast_params_once`.  The
train state holds float32 master weights; autograd accumulates each
microbatch's gradients into the leaves' `.grad`, and AdamW updates the
state in place (where JAX donates it), so one step needs the parameters,
their gradients and the two moments, with no second copy.

`Trainer` is the host-side driver: data, periodic async checkpoints,
step timing and metrics.

Sharded training (`axes`, a `models.sharding.MeshAxes`): the state's
leaves are DTensors on the current mesh (`launch.mesh.use_mesh`;
`models.sharding.shard_tree` with `param_specs`), each microbatch is
placed on the mesh's dp axes (`data.pipeline.place_on_mesh`) and the
model runs on DTensors.  A parameter's gradient leaves the backward in
whatever placement DTensor gave it (often a `Partial` sum over dp); it
reaches AdamW in its parameter's placement, by `constrain_grads`
(JAX's constraint to the parameter specs) or, when that flag is off,
by the step itself, since AdamW updates each leaf's local shard in
place.  The metrics are plain tensors, the same on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import place_on_mesh, to_device
from repro_torch.models.sharding import (
    MeshAxes,
    active_mesh,
    constrain,
    param_specs,
    spec_leaves,
)
from repro_torch.models.transformer import init_params, train_loss
from repro_torch.optim import adamw
from repro_torch.optim.compression import ef_roundtrip, init_error_buf
from repro_torch.tree_util import block_until_ready, flatten, leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    error_buf: Any  # compression error feedback ({} if off)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    dtype: Any = torch.bfloat16
    compress_grads: bool = False
    # cast the float32 master weights to the compute dtype ONCE before
    # the layer stack (JAX's rule: every float32 leaf with ndim >= 2)
    cast_params_once: bool = False
    # constrain gradients to the parameter shardings (a reduce-scatter
    # of a Partial gradient into the FSDP shard); with it off the step
    # moves them to the parameters' placements before AdamW all the same
    constrain_grads: bool = False
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig
    )


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig, gen: torch.Generator,
                     device="cuda") -> TrainState:
    """Float32 parameters drawn from `gen` (a generator on `device`)."""
    params = init_params(cfg, gen, device, dtype=torch.float32)
    opt = adamw.init(params)
    ebuf = init_error_buf(params) if tcfg.compress_grads else {}
    return TrainState(params, opt, ebuf)


def _full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor as the whole tensor on every rank (a collective)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(
    cfg: ArchConfig,
    tcfg: TrainConfig,
    axes: Optional[MeshAxes] = None,
) -> Callable[[TrainState, dict], tuple]:
    """Returns step(state, batch) -> (state, metrics).  `batch` holds the
    global batch as numpy arrays or tensors, moved to the parameters'
    device (with `axes`: each microbatch placed on the current mesh); the
    state's tensors are updated in place and returned."""
    if axes is not None and not isinstance(axes, MeshAxes):
        raise TypeError(f"axes must be a MeshAxes, not {type(axes).__name__}")

    def loss_fn(params, batch):
        if tcfg.cast_params_once:
            params = tree_map(
                lambda p: p.to(tcfg.dtype)
                if p.dtype == torch.float32 and p.ndim >= 2
                else p,
                params,
            )
        return train_loss(cfg, params, batch, axes=axes, dtype=tcfg.dtype,
                          remat=tcfg.remat)

    def step(state: TrainState, batch: dict):
        flat = leaves(state.params)
        if axes is None:
            batch = to_device(batch, flat[0].device)
        else:
            mesh = active_mesh()
            batch = {k: _full(torch.as_tensor(v)) for k, v in batch.items()}
        for p in flat:
            p.requires_grad_(True)
        n_micro = tcfg.microbatches
        loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for i in range(n_micro):
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])[i]
                  for k, v in batch.items()}
            if axes is not None:
                mb = place_on_mesh(mb, mesh, axes.dp)
            mloss = loss_fn(state.params, mb)
            mloss.backward()
            loss = loss + _full(mloss.detach())
        grads = tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad, state.params)
        for p in flat:
            p.grad = None
        if axes is not None:
            gl, treedef = flatten(grads)
            if tcfg.constrain_grads:
                gl = [constrain(g, axes, s)
                      for g, s in zip(gl, spec_leaves(param_specs(axes, grads)))]
            grads = treedef.unflatten([g.redistribute(p.device_mesh, p.placements)
                                       for g, p in zip(gl, flat)])
        if n_micro > 1:
            loss = loss / n_micro
            for g in leaves(grads):
                g.div_(n_micro)

        ebuf = state.error_buf
        if tcfg.compress_grads:
            grads, ebuf = ef_roundtrip(grads, ebuf)

        params, opt, om = adamw.update(tcfg.optimizer, grads, state.opt, state.params)
        metrics = {"loss": loss, **om}
        return TrainState(params, opt, ebuf), metrics

    return step


class Trainer:
    """Host driver: data, checkpoints, timing, failure hooks."""

    def __init__(
        self,
        cfg: ArchConfig,
        tcfg: TrainConfig,
        data_iter,
        step_fn: Callable,
        state: TrainState,
        ckpt_manager=None,
        ckpt_every: int = 100,
        hooks: Optional[Dict[str, Callable]] = None,
    ) -> None:
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = iter(data_iter)
        self.step_fn = step_fn
        self.state = state
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.step_idx = 0
        self.step_times: list = []
        self.metrics_log: list = []
        self.hooks = hooks or {}

    def run(self, n_steps: int) -> Dict[str, float]:
        last = {}
        for _ in range(n_steps):
            batch = next(self.data)
            if "pre_step" in self.hooks:
                self.hooks["pre_step"](self.step_idx)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            block_until_ready(metrics)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            last = {k: float(v) for k, v in metrics.items()}
            last["step_time_s"] = dt
            self.metrics_log.append({"step": self.step_idx, **last})
            self.step_idx += 1
            if self.ckpt is not None and self.step_idx % self.ckpt_every == 0:
                self.ckpt.save(self.step_idx, self.state)
        return last
