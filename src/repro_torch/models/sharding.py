"""Parameter / activation partitioning rules (DP x TP x EP x SP).

Counterpart of `repro/models/sharding.py` on DTensor.  `MeshAxes` names
the logical axes of the active mesh (('pod', 'data') fused as the DP
group on the multi-pod mesh).  Model code calls `constrain` with
logical specs; when `axes` is None (one device) it returns its input,
so the model code stays mesh-agnostic.

A spec is written as JAX's `PartitionSpec` is: a tuple with one entry
per tensor dim, each a mesh axis name, a tuple of names (the dim split
over those mesh dims, the first major) or None (not split); `()` is
replicated.  `placements` turns a spec into the DTensor placements of
a mesh, one per mesh dim.  `shard_tree` takes the place of
`jax.device_put(tree, NamedSharding(mesh, specs))`, and `constrain` of
`with_sharding_constraint`: it redistributes a DTensor to the spec on
the current mesh (`launch.mesh.use_mesh` sets it).

Parameter rules (FSDP x TP, MaxText-style): every matmul weight shards
its TP-parallel dimension on 'model' (attention heads / ffn hidden /
vocab / experts) and its other large dimension on the DP group
(ZeRO-3-style weight sharding); DTensor inserts the gathers.
`_RULES` and `_MOE_3D` are JAX's tables as they are.

Serving placements (`batch_specs`, `cache_pspecs`) are JAX's
`repro/launch/dryrun.py` rules (`:51-57`, `:60-87`), copied here
because the port has no `jit` with `out_shardings`: `prefill` itself
places the cache it builds (`models.transformer.init_cache(axes=...)`),
and `decode_step` keeps each leaf where it came in.  The decode cache's
K/V [sites, B, S, Hkv, D] put B on the dp group and S on the model axis
(S over every axis when B does not divide over dp: `batch_divisible`,
JAX's `build_cell`); the Mamba2 and RWKV states put their heads (or
`d`) on the model axis.  `shard_range` says which rows of a sharded
dim a rank holds, and `site` views one site of a stacked leaf, for the
local regions that write the cache in place.  `on_rows_and_heads` runs
work that is independent across batch rows and heads on each rank's
local tensors (a local region, where DTensor of torch 2.11 has no
working rule: attention, the Mamba2 scan and step, the wkv scan).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.tree_util import flatten

_MESH = [None]


def current_mesh():
    return _MESH[0]


def set_current_mesh(mesh) -> None:
    _MESH[0] = mesh


def active_mesh():
    """The current mesh; raises outside `launch.mesh.use_mesh`."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("sharded code needs a current mesh: run it inside "
                           "launch.mesh.use_mesh(mesh)")
    return mesh


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...] = ("data",)  # ('pod','data') on the multi-pod mesh
    tp: str = "model"
    # FSDP weight sharding over the dp group (ZeRO-3). Disable to keep
    # weights replicated across DP (small models).
    fsdp: bool = True


class P(tuple):
    """A spec, as JAX's `PartitionSpec(*dims)`: a tuple of its entries
    (a subclass, so that a tree of specs keeps each spec whole)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`: Shard(d) on each mesh
    dim that a tensor dim d is split over, Replicate elsewhere."""
    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(name)] = Shard(d)
    return tuple(out)


def replicated(x: torch.Tensor, mesh=None) -> DTensor:
    """A tensor that every rank holds whole, as a replicated DTensor
    (differentiable; no communication)."""
    if isinstance(x, DTensor):
        return x
    mesh = active_mesh() if mesh is None else mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A constant `x` made where `ref` lives: replicated on `ref`'s mesh
    when `ref` is a DTensor, `x` itself otherwise."""
    if isinstance(ref, DTensor) and not isinstance(x, DTensor):
        return replicated(x, ref.device_mesh)
    return x


def constrain(x: torch.Tensor, axes: Optional[MeshAxes], spec: tuple) -> torch.Tensor:
    """`x` placed by `spec` on the current mesh.  A dim of size 1, or one
    that does not divide over the mesh dims of its entry, stays whole:
    XLA pads such a dim, while DTensor cannot view or flatten an
    unevenly split one, nor drop a split dim of size 1 (a batch of 1 on
    the dp group of serving)."""
    if axes is None:
        return x
    mesh = active_mesh()
    place = list(placements(spec, mesh))
    for d in {p.dim for p in place if isinstance(p, Shard)}:
        split = [i for i, p in enumerate(place) if p == Shard(d)]
        if x.shape[d] == 1 or x.shape[d] % math.prod(mesh.size(i) for i in split):
            for i in split:
                place[i] = Replicate()
    return replicated(x, mesh).redistribute(mesh, place)


def sum_partials(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial sums reduced (Replicate on each mesh dim
    where it was Partial), other tensors as they are.  An output
    projection over a split contraction leaves partial sums, which
    DTensor would carry on into later ops: there torch 2.11 fails to
    mix them with a split operand ("redistribute from S(2) to P(sum) not
    supported"), and a matmul takes its weight whole to keep them (XLA
    reduces a dot's partial output at once)."""
    if not isinstance(x, DTensor) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                          for p in x.placements])


def split_heads(x: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    """`x` [..., n * head_dim] viewed as [..., n, head_dim].  Where a DTensor
    splits the last dim over mesh dims whose size does not divide `n`
    (40 heads, or 8 kv heads, on a model axis of 16), the dim is gathered
    whole over them first: DTensor cannot unflatten an uneven split,
    while XLA pads the heads.  The values are the same."""
    out = (*x.shape[:-1], n, head_dim)
    if isinstance(x, DTensor):
        last = Shard(x.ndim - 1)
        split = [i for i, p in enumerate(x.placements) if p == last]
        if n % math.prod(x.device_mesh.size(i) for i in split):
            x = x.redistribute(x.device_mesh, [Replicate() if p == last else p
                                               for p in x.placements])
    return x.reshape(out)


class _MergeHeads(torch.autograd.Function):
    """[..., n, head_dim] -> [..., n * head_dim], whose backward views the
    gradient back through `split_heads`: the output projection's backward
    hands back a gradient split over tp whatever the head count."""

    @staticmethod
    def forward(ctx, x):
        ctx.n, ctx.head_dim = x.shape[-2:]
        return x.reshape(*x.shape[:-2], ctx.n * ctx.head_dim)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.n, ctx.head_dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """`x` [..., n, head_dim] as [..., n * head_dim]; a DTensor's gradient
    comes back through `split_heads`."""
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _MergeHeads.apply(x)


def dp_spec(axes: MeshAxes):
    """The dp group as one spec entry: its one axis name, or the tuple
    of names (JAX dryrun's `_dp`)."""
    return axes.dp if len(axes.dp) > 1 else axes.dp[0]


def act_spec(axes: Optional[MeshAxes], *dims) -> tuple:
    """Build a spec from logical dim tags:
    'dp' -> dp group, 'tp' -> model axis, None -> replicated."""
    if axes is None:
        return P()
    out = []
    for d in dims:
        if d == "dp":
            out.append(dp_spec(axes))
        elif d == "tp":
            out.append(axes.tp)
        else:
            out.append(None)
    return P(*out)


# ---------------------------------------------------------------------------
# Parameter specs by path-name rules
# ---------------------------------------------------------------------------

# (substring match on the flattened path, spec-tags per dimension)
# Order matters: first match wins.
_RULES = [
    # attention
    ("wq", ("fsdp", "tp")),
    ("wk", ("fsdp", "tp")),
    ("wv", ("fsdp", "tp")),
    ("wo", ("tp", "fsdp")),
    # dense MLP
    ("w_gate", ("fsdp", "tp")),
    ("w_in", ("fsdp", "tp")),
    ("w_out", ("tp", "fsdp")),
    # MoE (leading expert dim) — matched before generic by dim count below
    ("router", (None, None)),
    # embeddings / head
    ("embed", ("tp", "fsdp")),
    ("lm_head", ("tp", "fsdp")),
    # rwkv
    ("w_r", ("fsdp", "tp")),
    ("w_k", ("fsdp", "tp")),
    ("w_v", ("fsdp", "tp")),
    ("w_g", ("fsdp", "tp")),
    ("w_o", ("tp", "fsdp")),
    ("cm_k", ("fsdp", "tp")),
    ("cm_v", ("tp", "fsdp")),
    ("cm_r", ("fsdp", "tp")),
    ("wl_a", ("fsdp", None)),
    ("wl_b", (None, "fsdp")),
    # mamba conv
    ("conv_w", (None, "tp")),
    ("conv_b", ("tp",)),
]

_MOE_3D = {"w_gate": ("tp", None, "fsdp"), "w_in": ("tp", None, "fsdp"),
           "w_out": ("tp", "fsdp", None)}


def _tags_to_spec(axes: MeshAxes, tags, stacked: int) -> tuple:
    dims = []
    for t in tags:
        if t == "tp":
            dims.append(axes.tp)
        elif t == "fsdp":
            dims.append((axes.dp if len(axes.dp) > 1 else axes.dp[0])
                        if axes.fsdp else None)
        else:
            dims.append(None)
    # account for leading stacked layer/group dims
    return P(*([None] * stacked + dims))


def _map_with_names(fn, node, names=()):
    """`fn(dict-key path, leaf)` over a tree of dicts, tuples, lists and
    NamedTuples (only dict keys enter the path, as JAX's `DictKey`s)."""
    if isinstance(node, dict):
        return {k: _map_with_names(fn, v, names + (k,)) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        kids = [_map_with_names(fn, c, names) for c in node]
        return type(node)(*kids) if hasattr(node, "_fields") else type(node)(kids)
    if node is None:
        return None
    return fn(names, node)


def param_specs(axes: Optional[MeshAxes], params) -> object:
    """Tree of specs matching `params` (by path rules); leaves need only
    `.ndim`.

    Leaves under 'layers'/'groups' carry 1 (or 2: hybrid groups) leading
    stacked dims which are never sharded.
    """
    if axes is None:
        return _map_with_names(lambda names, leaf: P(), params)

    def spec_for(names, leaf) -> tuple:
        stacked = 0
        if "layers" in names or "groups" in names:
            stacked = 1
            if "groups" in names:  # hybrid: [G, A, ...]
                stacked = 2
        eff_ndim = leaf.ndim - stacked
        last = names[-1] if names else ""
        # MoE expert tensors: leading E dim (3D after stacking)
        if eff_ndim == 3 and last in _MOE_3D:
            return _tags_to_spec(axes, _MOE_3D[last], stacked)
        for key, tags in _RULES:
            if last == key and len(tags) == eff_ndim:
                return _tags_to_spec(axes, tags, stacked)
        # default: replicate (norms, scalars, biases, mu/u vectors)
        return P()

    return _map_with_names(spec_for, params)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """JAX's `NamedSharding`: where a leaf goes (a tree leaf itself)."""
    mesh: object
    spec: P


def named_shardings(specs, mesh):
    """A tree of specs as the matching tree of `NamedSharding`s."""
    return _map_specs(lambda s: NamedSharding(mesh, s), specs)


def _map_specs(fn, specs):
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (tuple, list)):
        kids = [_map_specs(fn, c) for c in specs]
        return type(specs)(*kids) if hasattr(specs, "_fields") else type(specs)(kids)
    return specs


def shard_tree(tree, specs, mesh):
    """Each tensor leaf of `tree` (the same on every rank) as a DTensor
    on `mesh`, placed by the matching spec of `specs`; each rank keeps
    only its shard.  A leaf that requires grad stays a leaf that does."""
    def place(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        out = distribute_tensor(x.detach().to(mesh.device_type), mesh,
                                placements(spec, mesh))
        return out.requires_grad_(x.requires_grad)

    flat, treedef = flatten(tree)
    return treedef.unflatten([place(x, s) for x, s in zip(flat, spec_leaves(specs))])


def spec_leaves(specs) -> list:
    """The specs of a spec tree in the tree's flattening order (a spec is
    a tuple, which `flatten` would take apart)."""
    return [sh.spec for sh in flatten(named_shardings(specs, None))[0]]


# ---------------------------------------------------------------------------
# Serving placements (JAX `launch/dryrun.py`) and the cache's shards
# ---------------------------------------------------------------------------


def batch_divisible(batch: int, mesh, axes: MeshAxes) -> bool:
    """Whether `batch` rows split evenly over the dp group of `mesh`
    (JAX `launch/dryrun.py::build_cell`, `:101-105`)."""
    dp_size = 1
    for name in axes.dp:
        dp_size *= mesh.size(mesh.mesh_dim_names.index(name))
    return batch % dp_size == 0


def batch_specs(batch_tree, dp, batch_divisible: bool):
    """JAX `launch/dryrun.py::batch_specs` (`:51-57`): every input's
    leading (batch) dim on `dp`, or replicated when it does not divide."""
    def one(names, leaf):
        if not batch_divisible:
            return P()
        return P(dp, *([None] * (leaf.ndim - 1)))

    return _map_with_names(one, batch_tree)


def cache_pspecs(cfg, cache_tree, dp, tp, batch_divisible: bool):
    """JAX `launch/dryrun.py::cache_pspecs` (`:60-87`), rule for rule.
    KV caches: [sites, B, S, Hkv, D] -> B on dp, S on tp (the
    flash-decode partial softmax, `models.attention`); batch-1 cells
    shard S over everything instead.  States (mamba/rwkv): heads on tp.
    Leaves need only `.ndim`; "pos" (a Python int here) is replicated."""
    def one(names, leaf):
        last = names[-1] if names else ""
        ndim = getattr(leaf, "ndim", 0)
        if last in ("k", "v") and ndim == 5:
            if batch_divisible:
                return P(None, dp, tp, None, None)
            allaxes = (dp if isinstance(dp, tuple) else (dp,)) + (tp,)
            return P(None, None, allaxes, None, None)
        if last == "ssm" and ndim >= 4:  # [G,A,B,H,N,P]
            lead = ndim - 4
            return P(*([None] * lead), None if not batch_divisible else dp, tp, None, None)
        if last == "conv" and ndim >= 3:  # [G,A,B,K-1,convdim]
            lead = ndim - 3
            return P(*([None] * lead), None if not batch_divisible else dp, None, tp)
        if last == "wkv" and ndim == 5:  # [L,B,H,P,P]
            return P(None, dp if batch_divisible else None, tp, None, None)
        if last in ("tm_x", "cm_x") and ndim == 3:  # [L,B,d]
            return P(None, dp if batch_divisible else None, tp)
        return P()

    return _map_with_names(one, cache_tree)


def zeros_on_mesh(tree, specs, mesh):
    """Zeros in the shape and dtype of each tensor leaf of `tree` (a tree
    on the "meta" device will do), as DTensors on `mesh` placed by the
    matching spec; each rank allocates only its own shard."""
    def make(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return dtensor_zeros(tuple(x.shape), dtype=x.dtype, device_mesh=mesh,
                             placements=placements(spec, mesh))

    flat, treedef = flatten(tree)
    return treedef.unflatten([make(x, s) for x, s in zip(flat, spec_leaves(specs))])


def shard_range(size: int, mesh, place, dim: int) -> Tuple[int, int]:
    """(start, length) of this rank's rows of a tensor dim of `size` that
    `place` splits (Shard(dim) on one or more mesh dims, the first
    major), in the sizes DTensor gives its shards: `torch.chunk`'s, the
    last ones shorter or empty when the dim does not divide."""
    start = 0
    for i, p in enumerate(place):
        if p == Shard(dim):
            step = -(-size // mesh.size(i))
            lo = min(mesh.get_local_rank(i) * step, size)
            start, size = start + lo, min(lo + step, size) - lo
    return start, size


def site(x: torch.Tensor, index) -> torch.Tensor:
    """`x[index]` as a view that writes reach: `index` an int or a tuple of
    ints into the leading dims of a stacked cache leaf.  For a DTensor
    whose leading dims are not split, a DTensor over the same view of
    its local shard, the remaining dims placed as in `x` (DTensor's own
    indexing need not return a view)."""
    if not isinstance(x, DTensor):
        return x[index]
    lead = len(index) if isinstance(index, tuple) else 1
    place = []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim < lead:
            raise ValueError(f"site: dim {p.dim} of the stack is split ({x.placements})")
        place.append(Shard(p.dim - lead) if isinstance(p, Shard) else p)
    shape = x.shape[lead:]
    return DTensor.from_local(x.to_local()[index], x.device_mesh, place, run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: `to_local`'s backward
    wraps the local gradient with the DTensor's contiguous strides, and
    a later view then fails on a strided one (the GQA einsum's)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_rows_and_heads(fn, args, dims, out_dims, heads: int):
    """`fn(*args)` for DTensor `args`, run on each rank's local tensors: a
    local region for work that is independent across batch rows and
    heads.  `dims[j]` is (batch dim, head dim) of `args[j]` (None where
    it has none; `args[0]` has both), `out_dims` the same for each output
    of `fn` (a tuple).
    Per mesh dim, the batch stays split where `args[0]` splits its batch
    dim, and so do the heads where it splits its head dim (one mesh dim
    whose size divides `heads`), else the first other mesh dim whose size
    divides `heads` splits them (a head dim of h * P elements splits on
    head boundaries); the rest is replicated.  An input with no batch
    (or no head) dim is whole on a mesh dim that splits the batch (the
    heads), and its gradient there is a partial sum.  Returns DTensors."""
    ref = args[0]
    mesh = ref.device_mesh
    rb, rh = dims[0]
    plan = []
    for i, p in enumerate(ref.placements):
        if p == Shard(rb):
            plan.append("batch")
        elif p == Shard(rh) and "heads" not in plan and heads % mesh.size(i) == 0:
            plan.append("heads")
        else:
            plan.append(None)
    for i, k in enumerate(plan):
        if k is None and "heads" not in plan and heads % mesh.size(i) == 0:
            plan[i] = "heads"

    def place(bd, hd, missing=Replicate()):
        out = []
        for k in plan:
            d = bd if k == "batch" else hd if k == "heads" else None
            out.append(Replicate() if k is None else Shard(d) if d is not None else missing)
        return out

    local = [_ContiguousGrad.apply(like(a, ref).redistribute(mesh, place(*d)).to_local(
        grad_placements=place(*d, Partial()))) for a, d in zip(args, dims)]
    outs = fn(*local)
    wrapped = []
    for o, (bd, hd) in zip(outs, out_dims):
        shape = list(o.shape)
        if bd is not None:
            shape[bd] = ref.shape[rb]
        if hd is not None:
            shape[hd] *= math.prod(mesh.size(i) for i, k in enumerate(plan) if k == "heads")
        wrapped.append(DTensor.from_local(o.contiguous(), mesh, place(bd, hd), run_check=False,
                                          shape=torch.Size(shape),
                                          stride=torch.empty(shape, device="meta").stride()))
    return tuple(wrapped)
