"""Pipeline parallelism: GPipe fill-drain over a 'pipe' mesh axis.

Counterpart of `repro/train/pp.py`.  It works on the shape the backbone
already has, a per-layer body over stacked parameters.  The L layers
are split into `n_stages` contiguous stages (the stacked leaves sharded
on their leading layer dim over the 'pipe' axis), and microbatches
stream through the stages, each rank handing its activations to the
next stage by a ring permute.

Each rank runs `steps = n_micro + n_stages - 1` iterations (fill,
steady state, drain); stage s computes on iteration t the microbatch
m = t - s when 0 <= m < n_micro.  At the end the last stage's outputs
reach every rank by a masked sum.  Both collectives are autograd
functions, so the backward runs through them (the permute's backward is
the reverse permute, as `ppermute`'s transpose is).

Every rank sends and receives on every iteration, active or not, and in
the backward every rank runs every permute's backward in the same
order (the last iteration first): a permute whose output the rank does
not use still joins the loss through `_Join`, which passes zero
gradients, so no rank skips a transfer its neighbours wait for.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch.models.sharding import replicated
from repro_torch.tree_util import flatten


def _ring(group, x: torch.Tensor, shift: int) -> torch.Tensor:
    """Every rank of `group` sends `x` to the rank `shift` places after
    it and returns what the rank `shift` places before it sent."""
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    n = len(ranks)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Permute(torch.autograd.Function):
    """Hand `x` to the next stage; the backward hands the gradient back.
    `anchor` (a tensor that requires grad) keeps every permute in the
    graph, also one whose input needs no gradient."""

    @staticmethod
    def forward(ctx, x, anchor, group):
        ctx.group = group
        return _ring(group, x, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring(ctx.group, g, -1), None, None


class _SumAll(torch.autograd.Function):
    """The sum over the group of each rank's `x`.  What follows is the
    same on every rank, so each rank's output gradient is the whole
    gradient of its input: the backward passes it through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Join(torch.autograd.Function):
    """`x` unchanged, with `rest` joined to it in the graph: their
    gradients are zeros."""

    @staticmethod
    def forward(ctx, x, *rest):
        ctx.shapes = [(r.shape, r.dtype, r.device) for r in rest]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dv) for s, dt, dv in ctx.shapes))


def _stage_layers(stacked_params, mesh, axis: str) -> list:
    """This stage's layers, each a tree of local tensors whose gradients
    reach the stacked leaves: a DTensor leaf is moved to Shard(0) over
    `axis`, a plain one is taken as the same on every rank."""
    dim = mesh.mesh_dim_names.index(axis)

    def local(w):
        w = replicated(w, mesh)
        want = [Shard(0) if i == dim else q for i, q in enumerate(w.placements)]
        return w.redistribute(mesh, want).to_local()

    flat, treedef = flatten(stacked_params)
    stage = [local(w) for w in flat]
    return [treedef.unflatten([w[i] for w in stage]) for i in range(stage[0].shape[0])]


def pipeline_apply(
    body: Callable,  # (layer_params, x) -> x, one layer
    stacked_params,  # leaves [L, ...]
    x: torch.Tensor,  # [n_micro, mb, ...] microbatched activations
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run L = n_stages * layers_per_stage layers over microbatches; `x`
    and the result are the same on every rank."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    flat = flatten(stacked_params)[0]
    L = flat[0].shape[0]
    assert L % n_stages == 0, (L, n_stages)
    n_micro = x.shape[0]
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    layers = _stage_layers(stacked_params, mesh, axis)

    def apply_stage(h):
        for lp in layers:
            h = body(lp, h)
        return h

    if n_stages == 1:
        return torch.stack([apply_stage(x[m]) for m in range(n_micro)])

    anchor = torch.zeros((), device=x.device, requires_grad=True)
    cur = torch.zeros_like(x[0])
    buf = [torch.zeros_like(x[0]) for _ in range(n_micro)]  # last stage's outputs
    received = []
    for t in range(n_micro + n_stages - 1):
        m = t - idx  # microbatch index at this stage
        x_in = x[t if t < n_micro else 0] if idx == 0 else cur
        y = apply_stage(x_in) if 0 <= m < n_micro else x_in
        if idx == n_stages - 1 and 0 <= m < n_micro:
            buf[m] = y
        cur = _Permute.apply(y, anchor, group)
        received.append(cur)
    out = torch.stack(buf) if idx == n_stages - 1 else torch.zeros_like(x)
    return _SumAll.apply(_Join.apply(out, *received), group)


def make_pp_loss(body, n_micro: int):
    """Loss over the pipelined stack (for tests / PP training demos)."""

    def loss_fn(stacked_params, x, targets, mesh):
        y = pipeline_apply(body, stacked_params, x, mesh)
        return torch.mean(torch.square(y - targets))

    return loss_fn
