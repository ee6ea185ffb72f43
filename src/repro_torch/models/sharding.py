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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

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
    if axes is None:
        return x
    mesh = active_mesh()
    return replicated(x, mesh).redistribute(mesh, placements(spec, mesh))


def act_spec(axes: Optional[MeshAxes], *dims) -> tuple:
    """Build a spec from logical dim tags:
    'dp' -> dp group, 'tp' -> model axis, None -> replicated."""
    if axes is None:
        return P()
    out = []
    for d in dims:
        if d == "dp":
            out.append(axes.dp if len(axes.dp) > 1 else axes.dp[0])
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
