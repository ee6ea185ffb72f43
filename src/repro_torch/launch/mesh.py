"""Device meshes over the current `torch.distributed` world.

Counterpart of `repro/launch/mesh.py`: the same mesh shapes and axis
names, built with `init_device_mesh` over the process group that the
caller has started (`torch.distributed.init_process_group`).  The
device type follows the group's backend: "cuda" under NCCL, "cpu"
under gloo.  A function, not a module constant, so importing starts
nothing.

`use_mesh(mesh)` sets the mesh that `models.sharding.constrain` and
`shard_tree` read, as `jax.set_mesh` does for `with_sharding_constraint`.
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.models import sharding


def _device_type() -> str:
    """The mesh device type of the running process group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the current mesh inside the block."""
    prev = sharding.current_mesh()
    sharding.set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        sharding.set_current_mesh(prev)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16,16) data x model single pod; (2,16,16) pod x data x model.
    `device_type` overrides the group's ("cuda" or "cpu": the dry run's
    fake group serves either)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape, mesh_dim_names=axes)


def dp_axes(multi_pod: bool) -> tuple:
    return ("pod", "data") if multi_pod else ("data",)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type=None):
    """A small mesh over the world (its size must be the product of
    `shape`)."""
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))
