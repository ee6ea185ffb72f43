"""Mixture-of-Experts layer with capacity-based dispatch.

Counterpart of `repro/models/moe.py`: top-k routing, per-expert
capacity buffers, positions in expert from cumulative sums of one-hots,
then either the scatter dispatch / gather combine (`apply_moe`) or the
GShard one-hot matmul dispatch (`_apply_moe_einsum`).  `n_blocks` > 1
computes positions per token block (block-local capacity); `n_blocks` =
1 is the global formulation.  Aux loss: Switch load balancing plus 1e-3
x the router z-loss.

`axes` (a `models.sharding.MeshAxes`, or None on one device) shards the
expert buffers as JAX's constraints do: the scatter path's [E, capacity,
d] buffer on the expert dim over the model axis, the einsum path's
[G, E, C, d] buffer on G over dp and E over model.  With `axes` the
input and the parameters are DTensors.  The scatter path then routes,
places and combines on local tensors (`_apply_moe_sharded`: each rank
fills its own experts' buffer shard) and runs the expert FFN on
DTensors.  The einsum path is a local region throughout
(`_apply_moe_einsum_sharded`: each rank routes its own groups and runs
its own experts).

Everything here is plain tensor code with shapes fixed by the inputs: no
host sync and no data-dependent shape, so the layer runs inside a
captured CUDA graph.  Three places differ from a literal translation:

- top-k is taken by repeated `argmax`, which returns the first maximal
  index, so equal probabilities pick the lower expert first as
  `jax.lax.top_k` does (`torch.topk` promises no order among ties);
- one-hots are comparisons with an `arange`, so an out-of-range index
  gives an all-zero row as `jax.nn.one_hot` does (the einsum path relies
  on it for dropped tokens; `torch.nn.functional.one_hot` raises);
- the scatter writes every dropped token into the overflow slot
  `capacity`, in no fixed order on the card: that slot is cut off before
  the expert FFN and never read.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import _normal
from repro_torch.models.sharding import MeshAxes, act_spec, constrain, like

F32 = torch.float32


def init_moe(gen: torch.Generator, d: int, ff: int, n_experts: int, device="cuda") -> dict:
    s_in = d ** -0.5
    s_out = ff ** -0.5
    return {
        "router": _normal(gen, (d, n_experts), device) * s_in,
        "w_gate": _normal(gen, (n_experts, d, ff), device) * s_in,
        "w_in": _normal(gen, (n_experts, d, ff), device) * s_in,
        "w_out": _normal(gen, (n_experts, ff, d), device) * s_out,
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == like(torch.arange(n, device=idx.device), idx)).to(dtype)


def _gates(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """Router logits, probabilities, renormalised top-k gates and experts
    (descending, lower index first among equal probabilities) of the
    tokens of `x` [..., d]."""
    logits = x.float() @ router.float()                   # [..., E]
    probs = torch.softmax(logits, dim=-1)
    left = probs
    idx = []
    for _ in range(top_k):
        i = left.argmax(dim=-1)
        idx.append(i)
        left = left.scatter(-1, i[..., None], -1.0)       # probs are >= 0
    expert_idx = torch.stack(idx, dim=-1)                 # [..., K]
    gate_vals = probs.gather(-1, expert_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, expert_idx


def _route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """`_gates`' gates and experts, and the aux loss over every token of
    `x` [..., d]."""
    E = router.shape[1]
    logits, probs, gate_vals, expert_idx = _gates(router, x, top_k)
    T = probs.numel() // E
    me = probs.reshape(T, E).mean(dim=0)
    first = expert_idx[..., 0].reshape(T)
    ce = like(torch.zeros(E, dtype=F32, device=x.device), x).index_add(
        0, first, like(torch.ones(T, dtype=F32, device=x.device), x)) / T
    aux = E * (me * ce).sum()
    aux = aux + 1e-3 * torch.logsumexp(logits, dim=-1).square().mean()
    return gate_vals, expert_idx, aux


def _swiglu_experts(p: dict, buf: torch.Tensor, dtype) -> torch.Tensor:
    """The expert FFN over capacity buffers [..., E, C, d] (the weights
    are in `dtype` already)."""
    g = torch.matmul(buf, p["w_gate"])
    h = torch.matmul(buf, p["w_in"])
    act = torch.nn.functional.silu(g.float()).to(dtype) * h
    return torch.matmul(act, p["w_out"])


def _slots(expert_idx: torch.Tensor, E: int, top_k: int, capacity_factor: float,
           n_blocks: int):
    """Capacity slots of the routed (token, slot) pairs, slot-major [K, T]:
    (keep, slot in the expert's buffer, expert, capacity).  Positions come
    from per-block cumsums; a dropped pair gets the overflow slot
    `capacity`."""
    T = expert_idx.shape[0]
    Tb = T // n_blocks
    cap_b = max(int(capacity_factor * Tb * top_k / E), 1)
    capacity = cap_b * n_blocks  # per-expert total slots
    # slot-major positions within each token block, then the expert's
    # global slot range block * cap_b + pos
    e_blk = expert_idx.reshape(n_blocks, Tb, top_k).transpose(1, 2)  # [NB, K, Tb]
    onehot = _one_hot(e_blk.reshape(n_blocks, top_k * Tb), E, torch.int32)
    pos_flat = (torch.cumsum(onehot, dim=1) - 1) * onehot
    pos_b = pos_flat.sum(-1).reshape(n_blocks, top_k, Tb)
    keep_b = pos_b < cap_b
    blk = torch.arange(n_blocks, device=expert_idx.device)[:, None, None]
    slot_b = torch.where(keep_b, pos_b + blk * cap_b, capacity)
    keep = keep_b.transpose(0, 1).reshape(top_k, T)
    slot = slot_b.transpose(0, 1).reshape(top_k, T)
    e_kt = e_blk.transpose(0, 1).reshape(top_k, T)
    return keep, slot, e_kt, capacity


def apply_moe(
    p: dict,
    x: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    dtype=torch.bfloat16,
    n_blocks: int = 1,
    axes: Optional[MeshAxes] = None,
    dispatch: str = "scatter",
    group_size: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y: [B, S, d] in x's dtype, aux_loss: scalar).

    `p["router"]` is float32 and the expert weights are in `dtype`, as
    `models.transformer.params_from_numpy` and `init_params` hold them.
    `dispatch="einsum"` selects the one-hot matmul dispatch."""
    if dispatch == "einsum":
        return _apply_moe_einsum(p, x, top_k=top_k, capacity_factor=capacity_factor,
                                 dtype=dtype, axes=axes, group_size=group_size)
    B, S, d = x.shape
    T = B * S
    if T % n_blocks != 0:
        n_blocks = 1
    if axes is not None:
        return _apply_moe_sharded(p, x, top_k=top_k, capacity_factor=capacity_factor,
                                  dtype=dtype, n_blocks=n_blocks, axes=axes)
    E = p["router"].shape[1]
    xf = x.reshape(T, d)
    gate_vals, expert_idx, aux = _route(p["router"], xf, top_k)      # [T, K]
    keep, slot, e_kt, capacity = _slots(expert_idx, E, top_k, capacity_factor, n_blocks)

    # dispatch: scatter into [E, capacity + 1 overflow, d], drop overflow
    buf = torch.zeros((E, capacity + 1, d), dtype=dtype, device=x.device)
    buf[e_kt, slot] = xf.to(dtype).expand(top_k, T, d)
    out_e = _swiglu_experts(p, buf[:, :capacity], dtype)
    out_e = torch.nn.functional.pad(out_e, (0, 0, 0, 1))

    # combine: gather each (token, slot) result, weight by its gate
    gathered = out_e[e_kt, slot]                                     # [K, T, d]
    w = (gate_vals.transpose(0, 1) * keep)[..., None].float()
    y = (gathered.float() * w).sum(0)
    return y.reshape(B, S, d).to(x.dtype), aux


def _apply_moe_sharded(p: dict, x: DTensor, *, top_k: int, capacity_factor: float,
                       dtype, n_blocks: int, axes: MeshAxes) -> Tuple[DTensor, DTensor]:
    """The scatter path on DTensors.  Routing, slots and the combine run on
    local tensors, the same on every rank, over the whole batch; each rank
    scatters the tokens of its own experts into its shard of the
    [E, capacity, d] buffer (the experts over tp, JAX's constraint); the
    expert FFN runs on DTensors against the sharded expert weights.  A
    local region: DTensor (torch 2.11) gives the index ops of the
    dispatch and the combine malformed placements."""
    mesh = x.device_mesh
    B, S, d = x.shape
    T, E = B * S, p["router"].shape[1]
    tp = mesh.mesh_dim_names.index(axes.tp)
    split = E % mesh.size(tp) == 0      # the experts over tp, else replicated
    E_l = E // mesh.size(tp) if split else E
    e0 = mesh.get_local_rank(axes.tp) * E_l if split else 0
    whole = [Replicate()] * mesh.ndim
    on_tp = lambda p: [p if i == tp and split else Replicate()  # noqa: E731
                       for i in range(mesh.ndim)]
    x_all = x.redistribute(mesh, whole)
    # every rank routes every token, so each holds whole gradients here
    gate_vals, expert_idx, aux = _route(p["router"].redistribute(mesh, whole).to_local(),
                                        x_all.to_local().reshape(T, d), top_k)
    keep, slot, e_kt, capacity = _slots(expert_idx, E, top_k, capacity_factor, n_blocks)

    # dispatch: this rank's experts' pairs into its buffer shard, the rest
    # into the overflow slot; its gradient is a partial sum over tp
    mine = (e_kt >= e0) & (e_kt < e0 + E_l)
    buf = torch.zeros((E_l, capacity + 1, d), dtype=dtype, device=x.device)
    xd = x_all.to_local(grad_placements=on_tp(Partial())).reshape(T, d)
    buf[torch.where(mine, e_kt - e0, 0), torch.where(mine, slot, capacity)] = (
        xd.to(dtype).expand(top_k, T, d))
    buf = DTensor.from_local(buf[:, :capacity].contiguous(), mesh, on_tp(Shard(0)),
                             run_check=False, shape=(E, capacity, d),
                             stride=(capacity * d, d, 1))
    out_e = _swiglu_experts(p, buf, dtype).redistribute(mesh, whole).to_local()
    out_e = torch.nn.functional.pad(out_e, (0, 0, 0, 1))

    # combine, as the plain path
    gathered = out_e[e_kt, slot]                                     # [K, T, d]
    w = (gate_vals.transpose(0, 1) * keep)[..., None].float()
    y = (gathered.float() * w).sum(0).reshape(B, S, d).to(x.dtype)
    y = DTensor.from_local(y, mesh, whole, run_check=False)
    return (constrain(y, axes, act_spec(axes, "dp", None, None)),
            DTensor.from_local(aux, mesh, whole, run_check=False))


def _apply_moe_einsum(
    p: dict,
    x: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float,
    dtype,
    axes: Optional[MeshAxes],
    group_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style dispatch: one-hot (token -> expert, slot) tensors
    contracted with matmuls, capacity per (group, expert); G groups of
    Sg tokens.  group_size = T gives the scatter path's global
    capacity."""
    B, S, d = x.shape
    E = p["router"].shape[1]
    T = B * S
    G = max(T // group_size, 1)
    while T % G:
        G -= 1
    Sg = T // G
    if axes is not None:
        return _apply_moe_einsum_sharded(p, x, top_k=top_k, capacity_factor=capacity_factor,
                                         dtype=dtype, axes=axes, G=G)
    xg = x.reshape(G, Sg, d)
    gate_vals, expert_idx, aux = _route(p["router"], xg, top_k)      # [G, Sg, K]
    oh, pos_oh, keep = _einsum_slots(expert_idx, E, top_k, capacity_factor, dtype)
    disp = torch.einsum("gkse,gksc->gsec", oh.to(dtype), pos_oh)     # [G, Sg, E, C]
    buf = torch.einsum("gsec,gsd->gecd", disp, xg.to(dtype))
    out_e = _swiglu_experts(p, buf, dtype)                           # [G, E, C, d]
    comb = torch.einsum("gkse,gksc,gks->gsec", oh.float(), pos_oh.float(),
                        gate_vals.transpose(1, 2) * keep).to(dtype)
    y = torch.einsum("gsec,gecd->gsd", comb, out_e)
    return y.reshape(B, S, d).to(x.dtype), aux


def _einsum_slots(expert_idx: torch.Tensor, E: int, top_k: int, capacity_factor: float,
                  dtype):
    """Slot-major one-hots of the routed pairs of each group, from
    `expert_idx` [G, Sg, K]: (experts [G, K, Sg, E] int32, slots
    [G, K, Sg, C] in `dtype`, keep [G, K, Sg])."""
    Gl, Sg = expert_idx.shape[:2]
    C = max(int(capacity_factor * Sg * top_k / E), 1)
    e_sm = expert_idx.transpose(1, 2)                                # [G, K, Sg]
    oh = _one_hot(e_sm, E, torch.int32)                              # [G, K, Sg, E]
    ohf = oh.reshape(Gl, top_k * Sg, E)
    pos = ((torch.cumsum(ohf, dim=1) - 1) * ohf).sum(-1).reshape(Gl, top_k, Sg)
    keep = pos < C
    # slot C is out of range: dropped tokens get all-zero rows
    return oh, _one_hot(torch.where(keep, pos, C), C, dtype), keep


def _apply_moe_einsum_sharded(p: dict, x: DTensor, *, top_k: int, capacity_factor: float,
                              dtype, axes: MeshAxes, G: int) -> Tuple[DTensor, DTensor]:
    """The einsum path on DTensors, as JAX's constraint places its buffer:
    the G groups over dp (when each dp shard's batch rows are whole
    groups: G and B divide over dp; else every rank takes all G), the
    experts over tp.  A local region: with fewer groups than dp shards,
    DTensor's sharding propagation of the combine einsum `gsec,gecd->gsd`
    on the multi-pod mesh did not end (torch 2.13, a (2, 1, 2) mesh).

    Each rank routes its groups' tokens, builds the one-hots of its own
    experts and their buffer shard, runs its experts' FFN over it with
    their weights gathered over dp (FSDP's gather; DTensor's propagation
    of the 4-D by 3-D matmul on a 3-D mesh did not end either), and
    combines its experts' outputs, a partial sum over tp.  Gradients:
    routing's are whole on each tp rank (the gates' gradient, a partial
    sum over the experts, is summed over tp first), the dispatch's input
    gradient is a partial sum over tp; over dp each rank's rows are its
    own, and the weights' and the router's gradients are partial sums
    when the groups are split.  The aux loss sums its per-expert sums
    over dp."""
    mesh = x.device_mesh
    B, S, d = x.shape
    T, E = B * S, p["router"].shape[1]
    names = mesh.mesh_dim_names
    dp = [names.index(a) for a in axes.dp]
    tp = names.index(axes.tp)
    dp_size = math.prod(mesh.size(i) for i in dp)
    split = G % dp_size == 0 and B % dp_size == 0   # each rank's rows are whole groups
    e_split = E % mesh.size(tp) == 0
    Gl, Bl = (G // dp_size, B // dp_size) if split else (G, B)
    El = E // mesh.size(tp) if e_split else E
    e0 = mesh.get_local_rank(axes.tp) * El if e_split else 0

    def place(on_dp, on_tp):
        return [on_dp if i in dp else on_tp if i == tp else Replicate()
                for i in range(mesh.ndim)]

    rows = Shard(0) if split else Replicate()        # this rank's groups
    own = Partial() if split else Replicate()        # a sum over this rank's rows
    experts = (lambda s: s) if e_split else (lambda s: Replicate())  # noqa: E731
    whole = [Replicate()] * mesh.ndim
    xr = x.redistribute(mesh, place(rows, Replicate()))
    router = p["router"].redistribute(mesh, whole).to_local(
        grad_placements=place(own, Replicate()))
    xg = xr.to_local().reshape(Gl, T // G, d)
    Sg = xg.shape[1]
    logits, probs, gate_vals, expert_idx = _gates(router, xg, top_k)   # [Gl, Sg, K]
    # the aux loss: per-expert sums over this rank's tokens, summed over dp
    sums = [DTensor.from_local(t, mesh, place(own, Replicate()), run_check=False)
            .redistribute(mesh, whole)
            for t in (probs.reshape(-1, E).sum(0),
                      _one_hot(expert_idx[..., 0], E, F32).reshape(-1, E).sum(0),
                      torch.logsumexp(logits, dim=-1).square().sum())]
    aux = E * (sums[0] / T * (sums[1] / T)).sum() + 1e-3 * (sums[2] / T)

    oh, pos_oh, keep = _einsum_slots(expert_idx, E, top_k, capacity_factor, dtype)
    oh = oh[..., e0:e0 + El]                                          # this rank's experts
    xd = xr.to_local(grad_placements=place(rows, experts(Partial()))).reshape(Gl, Sg, d)
    disp = torch.einsum("gkse,gksc->gsec", oh.to(dtype), pos_oh)     # [Gl, Sg, El, C]
    buf = torch.einsum("gsec,gsd->gecd", disp, xd.to(dtype))
    # the expert weights gathered over dp (FSDP), this rank's experts
    mine = place(Replicate(), experts(Shard(0)))
    w = {k: p[k].redistribute(mesh, mine).to_local(grad_placements=place(own, experts(Shard(0))))
         for k in ("w_gate", "w_in", "w_out")}
    out_e = _swiglu_experts(w, buf, dtype)                          # [Gl, El, C, d]

    # the gates' gradient from this rank's experts, summed over tp
    gates = DTensor.from_local(gate_vals, mesh, whole, run_check=False).to_local(
        grad_placements=place(Replicate(), experts(Partial())))
    comb = torch.einsum("gkse,gksc,gks->gsec", oh.float(), pos_oh.float(),
                        gates.transpose(1, 2) * keep).to(dtype)
    y = torch.einsum("gsec,gecd->gsd", comb, out_e).reshape(Bl, S, d)
    y = DTensor.from_local(y, mesh, place(rows, experts(Partial())), run_check=False,
                           shape=(B, S, d), stride=(S * d, d, 1))
    return constrain(y, axes, act_spec(axes, "dp", None, None)).to(x.dtype), aux
