"""Per-device operation counts of one eager call, and the H100's roofline
terms.

Counterpart of `repro/roofline/hlo_analysis.py`.  JAX walks the
compiled, SPMD-partitioned HLO of a step; the port has no HLO, so it
counts the aten ops of one call as they run, on each device's local
shapes.  `OpCounter` is a `TorchDispatchMode`: an op on DTensors is
handed back to DTensor (the mode returns `NotImplemented`), which runs
the local op on this rank's shards and issues the collectives of its
redistributions, and those come back through the mode as plain
tensors.  So every count is this rank's (rank 0 of the world: the
largest shard where a dim does not divide), never the global op's.
DTensor's sharding propagation runs each new op once on fake tensors
of the global shapes to learn its output's (under the caller's
`FakeTensorMode` where one is active); ops called from within it
(`torch/distributed/tensor/_sharding_prop.py` on the Python stack) are
not counted, so a count does not depend on what its cache holds.

The model is the eager port's traffic, not XLA's fused traffic: every
op reads each operand once and writes its result once.

- flops: matmul-class ops (mm, bmm, addmm, baddbmm, dot, mv, addmv,
  convolution) count 2 x output elements x contraction size; every
  other op that computes counts 1 flop per output element, as
  `analyze_hlo` counts ops outside fusions.
- bytes: operands plus results.  An operand broadcast by `expand` is
  read once (its stride-0 dims are not counted).  Views and metadata
  ops (and allocations of uninitialised memory) cost nothing.  Copies
  that change only the layout (`copy_`, `clone`, `contiguous`, a
  `_to_copy` that keeps the dtype) go to `layout_bytes`, as JAX's
  copy/transpose ops do, and stay out of `bytes`; a `copy_` into a
  view of a larger tensor is a write into a slice and counts 2 x the
  slice in `bytes` (JAX's dynamic-update-slice); `index_put_` and the
  scatters count 2 x the values written, gathers (`index`,
  `index_select`, `gather`, `embedding`) 2 x the rows read.  A cast
  (`_to_copy` to another dtype) is an elementwise op here: the eager
  port launches a kernel for it.
- collective bytes: the operand bytes of each `_c10d_functional`
  collective (DTensor's redistributions) and each c10d collective (the
  calls that the port's local regions make), under JAX's names
  (`COLLECTIVES`); a collective with no JAX counterpart (broadcast,
  scatter) is kept under its torch name.  Their operands and results
  also count in `bytes`, as in `analyze_hlo`.  On a CPU mesh DTensor
  turns an all-to-all into an all-gather and a chunk (gloo has no
  all-to-all), so a CPU count can name all-gathers that a CUDA run
  names all-to-alls.

The hand-written CUDA kernels are invisible here: they are loaded by
`ctypes` (`kernels/_build.py`) and launched outside the dispatcher, so
no dispatch mode sees them.  A count of a step that runs kernels A, B
or 5 must add their work from their own byte models.

`HW_H100` and `roofline_terms` turn a count into seconds.  A 256- or
512-card mesh spans nodes of 8 cards, and the links between nodes are
slower than NVLink, so `collective_s` is a lower bound there.
"""

from __future__ import annotations

import math
import sys
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# op name (the overload packet's) -> JAX's collective name
_COLLECTIVE_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "scatter_": "scatter",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_c10d_functional_autograd")

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "dot", "mv", "addmv", "convolution"}
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "_local_scalar_dense", "set_",
         "resize_", "_assert_tensor_metadata", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type"}
_LAYOUT = {"clone", "contiguous"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_add", "index_add_", "index_copy", "index_copy_"}
_GATHERS = {"index", "index_select", "gather", "embedding"}

# NVIDIA H100 SXM5 80GB
HW_H100 = {
    # dense BF16 tensor-core peak, NVIDIA H100 SXM datasheet (1979 TFLOP/s
    # is the 2:4-sparse figure)
    "peak_flops_bf16": 989e12,
    # HBM3, NVIDIA H100 SXM datasheet: 3.35 TB/s
    "hbm_bw": 3.35e12,
    # NVLink 4, NVIDIA H100 SXM datasheet: 900 GB/s per card, both
    # directions together, so 450 GB/s each way
    "link_bw": 450e9,
    # HBM capacity per card, datasheet: 80 GB
    "hbm_bytes": 80e9,
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _elems(t: torch.Tensor) -> int:
    """Elements a read of `t` touches: a broadcast (stride-0) dim once."""
    return math.prod(n for n, s in zip(t.shape, t.stride()) if s != 0) if t.dim() else 1


def _bytes(ts) -> float:
    return float(sum(_elems(t) * t.element_size() for t in ts))


def _out_bytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _contraction(name: str, args) -> int:
    """The contraction size of a matmul-class op."""
    if name in ("mm", "bmm", "dot", "mv"):
        return args[0].shape[-1]
    if name in ("addmm", "baddbmm", "addmv"):
        return args[1].shape[-1]
    if name == "convolution":  # weight [out, in / groups, *kernel]
        return math.prod(args[1].shape[1:])
    raise KeyError(name)


def _is_slice_of_larger(t: torch.Tensor) -> bool:
    """Whether `t` is a view of only part of its storage."""
    try:
        return t.untyped_storage().nbytes() > t.numel() * t.element_size()
    except (RuntimeError, NotImplementedError):
        return False


_PROPAGATION = "_sharding_prop.py"


def in_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the Python stack (the
    caller's caller's and outward)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class OpCounter(TorchDispatchMode):
    """Counts the ops that run inside `with OpCounter()`: flops, bytes,
    layout bytes and collective bytes per device (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.layout_bytes = 0.0
        self.collective_bytes = 0.0
        self.per_collective: Dict[str, float] = {}
        self.n_ops = 0
        self.warnings: list = []
        # op name -> [calls, flops, bytes and layout bytes]
        self.by_op: Dict[str, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not in_propagation():
            before = (self.n_ops, self.flops, self.bytes + self.layout_bytes)
            self._count(func, args, _tensors((args, kwargs)), _tensors(out))
            if self.n_ops > before[0]:
                row = self.by_op.setdefault(str(func), [0, 0.0, 0.0])
                row[0] += 1
                row[1] += self.flops - before[1]
                row[2] += self.bytes + self.layout_bytes - before[2]
        return out

    def _count(self, func, args, ins, outs) -> None:
        ns = func.namespace
        name = func._opname
        if ns == "prim" or func.is_view or name in _FREE:
            return
        self.n_ops += 1
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_OF.get(name)
            if kind is None:
                if name not in ("wait_tensor",):
                    self._warn(f"uncounted {ns}.{name}")
                return
            b = _out_bytes(ins)
            self.collective_bytes += b
            self.per_collective[kind] = self.per_collective.get(kind, 0.0) + b
            self.bytes += b + _out_bytes(outs)
            return
        if name in _MATMUL:
            out_elems = sum(t.numel() for t in outs)
            self.flops += 2.0 * out_elems * _contraction(name, args)
            self.bytes += _bytes(ins) + _out_bytes(outs)
            return
        if name in _LAYOUT or (name == "_to_copy" and outs and ins
                               and outs[0].dtype == ins[0].dtype):
            self.layout_bytes += _bytes(ins) + _out_bytes(outs)
            return
        if name == "copy_":
            dst = args[0]
            if _is_slice_of_larger(dst):
                self.bytes += 2.0 * dst.numel() * dst.element_size()
            else:
                self.layout_bytes += _bytes(ins[1:]) + _out_bytes(outs)
            return
        if name in _SCATTERS:
            values = ins[-1]
            self.flops += values.numel()
            self.bytes += 2.0 * _out_bytes([values])
            return
        if name in _GATHERS:
            self.bytes += 2.0 * _out_bytes(outs)
            return
        self.flops += sum(t.numel() for t in outs)
        self.bytes += _bytes(ins) + _out_bytes(outs)

    def _warn(self, msg: str) -> None:
        if msg not in self.warnings and len(self.warnings) < 20:
            self.warnings.append(msg)

    def result(self) -> dict:
        """The counts under `analyze_hlo`'s keys, plus `n_ops`."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "layout_bytes": self.layout_bytes,
            "collective_bytes": self.collective_bytes,
            "per_collective": dict(self.per_collective),
            "warnings": list(self.warnings),
            "n_ops": self.n_ops,
        }


def analyze_ops(fn, *args, **kwargs) -> dict:
    """Per-device counts of one call `fn(*args, **kwargs)` (`analyze_hlo`'s
    keys); on fake tensors, inside the caller's `FakeTensorMode`."""
    counter = OpCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.result()


def roofline_terms(per_device: dict, hw: dict = HW_H100) -> dict:
    """Seconds of compute, memory and collectives of a per-device count,
    the dominant term and the share of the sum it takes."""
    compute_s = per_device["flops"] / hw["peak_flops_bf16"]
    memory_s = per_device["bytes"] / hw["hbm_bw"]
    collective_s = per_device["collective_bytes"] / hw["link_bw"]
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dom,
        "bound_s": bound,
        "overlap_fraction": bound / total if total else 0.0,
    }
