"""Multi-pod dry run: build and count every (arch x shape x mesh) cell on a
fake world of 256 or 512 ranks.

Counterpart of `repro/launch/dryrun.py`.  For each cell this module:
  1. starts a fake process group of the mesh's size (this process is
     rank 0; collectives return at once) and builds the production mesh
     ((16,16) or (2,16,16)) over it;
  2. builds the port's step (the sharded train step, `prefill` or
     `decode_step`) with its inputs placed by the model's rules (FSDP x
     TP params, DP batch, sequence-sharded KV), as DTensors whose local
     shards are fake tensors (`FakeTensorMode`): nothing is allocated;
  3. runs the step once under `roofline.op_count.OpCounter`, which
     counts the ops on this rank's local shards and the collectives of
     DTensor's redistributions;
  4. writes one JSON per cell under experiments/dryrun_torch/.

The record keeps JAX's keys where the port can fill them, with these
stand-ins: `memory_analysis` gives the bytes of the placed local shards
of the arguments and outputs (and of the outputs that are the inputs,
written in place: JAX's donated aliases) in place of XLA's
`memory_analysis`, and its temp bytes are the peak of the tensors alive
on the device during the call (torch's `MemTracker`, over fake tensors)
less the arguments, so outputs not written in place count as temp;
`op_count_per_device` (the counter's dict) takes the place of
`hlo_walk_per_device`, and `xla_cost_analysis` has no counterpart; the
roofline terms are the H100's (`HW_H100`); `build_s` and `count_s` are
the seconds to build the cell and to run it under the counter (JAX's
`lower_s` and `compile_s`; the count includes the memory tracker's
time).

The decode cell's cache is `cache_specs`' (position 0, as JAX's): the
port's decode scores every cache row under a mask, as JAX's
static-shape step does, so its work does not depend on the position.

The device is "cuda" unless the caller asks for "cpu" (the CPU tests):
fake CUDA tensors need a CUDA build of torch, and still allocate
nothing on the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama4-scout-17b-a16e \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch.configs import ARCH_NAMES, cache_specs, get_config, input_specs
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import dp_axes, make_production_mesh, use_mesh
from repro_torch.models.sharding import (
    MeshAxes,
    batch_specs,
    cache_pspecs,
    dp_spec,
    param_specs,
    zeros_on_mesh,
)
from repro_torch.models.transformer import cast_matmul, decode_step, init_params, prefill
from repro_torch.optim import adamw
from repro_torch.roofline.op_count import HW_H100, OpCounter, in_propagation, roofline_terms
from repro_torch.train.trainer import TrainConfig, TrainState, make_train_step
from repro_torch.tree_util import leaves, tree_map

OUT_DIR = "experiments/dryrun_torch"


def fake_world(n_ranks: int) -> None:
    """Make the default process group a fake one of `n_ranks` ranks, this
    process rank 0 (a group of another size is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n_ranks and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)


@contextlib.contextmanager
def fake_tensors():
    """A `FakeTensorMode` for a cell: tensors made inside it are fake.

    DTensor works out the rows of a strided shard (a dim split over two
    mesh dims after a flatten) with torch ops on index tensors and reads
    them back (`_StridedShard.local_shard_size_and_offset`); inside a
    fake mode those index tensors would be fake and unreadable, so that
    method runs with the mode unset (host tensors of a dim's length).
    Real tensors on a real mesh take the same path."""
    orig = _StridedShard.__dict__.get("local_shard_size_and_offset")
    if orig is not None:
        @functools.wraps(orig)
        def on_host(*args, **kwargs):
            with unset_fake_temporarily():
                return orig(*args, **kwargs)

        _StridedShard.local_shard_size_and_offset = on_host
    try:
        with FakeTensorMode() as mode:
            yield mode
    finally:
        if orig is not None:
            _StridedShard.local_shard_size_and_offset = orig


def _bf16_serving(params):
    """JAX's bf16 serving weights: every float32 leaf of two or more dims
    in bf16 (no float32 masters at inference)."""
    return tree_map(lambda a: torch.empty(a.shape, dtype=torch.bfloat16, device="meta")
                    if a.dtype == torch.float32 and a.dim() >= 2 else a, params)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, multi_pod: bool,
               variant: str = "baseline"):
    """Returns (cell, meta) for one cell: `cell()` runs the step once on
    its placed inputs (`cell.args`, a `functools.partial`); meta holds
    {"tokens": ...}.  Call it, and the cell, inside `fake_tensors()` and
    `launch.mesh.use_mesh(mesh)`: the inputs are made on the mesh's
    device, placed, as fake tensors.

    variant='opt' enables the beyond-paper optimizations as JAX's does:
    block-local MoE dispatch aligned to the data shards, capacity 2.0
    serving dispatch, bf16 serving weights; 'cast' (bf16-once parameter
    casting) and 'rsgrads' (gradient sharding constraints) apply to the
    train step, 'blocks' and 'gNNN' (the einsum group size) to MoE."""
    dpa = dp_axes(multi_pod)
    axes = MeshAxes(dp=dpa, tp="model", fsdp=True)
    dp = dp_spec(axes)
    dp_size = 1
    for a in dpa:
        dp_size *= mesh.size(mesh.mesh_dim_names.index(a))
    batch_div = shape.global_batch % dp_size == 0
    flags = set(variant.split("+")) if variant != "baseline" else set()
    if "opt" in flags:
        flags = {"einsum", "servecf", "bf16serve"}
    if cfg.n_experts:
        group = cfg.dispatch_group
        for f in flags:
            if f.startswith("g") and f[1:].isdigit():
                group = int(f[1:])  # e.g. g512: einsum dispatch group size
        cfg = dataclasses.replace(
            cfg,
            dispatch_blocks=(dp_size if batch_div and "blocks" in flags else 1),
            serve_capacity_factor=(2.0 if "servecf" in flags else 0.0),
            dispatch_mode=("einsum" if "einsum" in flags else "scatter"),
            dispatch_group=group,
        )

    params_shape = init_params(cfg, torch.Generator(), "meta", dtype=torch.float32)
    if "bf16serve" in flags and shape.kind != "train":
        params_shape = _bf16_serving(params_shape)
    params = zeros_on_mesh(params_shape, param_specs(axes, params_shape), mesh)

    def batch_of(kind_shape):
        batch = input_specs(cfg, kind_shape, device="meta")
        return zeros_on_mesh(batch, batch_specs(batch, dp, batch_div), mesh)

    if shape.kind == "train":
        tcfg = TrainConfig(
            microbatches=1, remat=True, dtype=torch.bfloat16,
            cast_params_once="cast" in flags,
            constrain_grads="rsgrads" in flags,
        )
        step = make_train_step(cfg, tcfg, axes)
        state = TrainState(params, adamw.init(params), {})
        cell = functools.partial(step, state, batch_of(shape))
        tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        def pf(params, batch):
            return prefill(cfg, cast_matmul(params, torch.bfloat16), batch,
                           max_len=shape.seq_len, axes=axes, dtype=torch.bfloat16)

        cell = functools.partial(pf, params, batch_of(shape))
        tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "decode":
        cache_shape = cache_specs(cfg, shape, device="meta")
        cache = zeros_on_mesh(cache_shape, cache_pspecs(cfg, cache_shape, dp, "model", batch_div),
                        mesh)
        toks = batch_of(shape)["tokens"]

        def dec(params, cache, tokens):
            return decode_step(cfg, cast_matmul(params, torch.bfloat16), cache, tokens,
                               axes=axes, dtype=torch.bfloat16)

        cell = functools.partial(dec, params, cache, toks)
        tokens = shape.global_batch  # one token per sequence
    else:
        raise ValueError(shape.kind)
    return cell, {"tokens": tokens}


def model_flops(cfg: ArchConfig, shape: ShapeSpec, tokens: int) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def _tensors(tree) -> list:
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    """Bytes of the local shards of tensors `ts` (DTensors or plain)."""
    local = [t.to_local() if isinstance(t, DTensor) else t for t in ts]
    return sum(t.numel() * t.element_size() for t in local)


def memory_of(cell, out, peak=None) -> dict:
    """Bytes per device of the cell's placed arguments and outputs, of the
    outputs that are argument tensors (updated in place: JAX's donated
    aliases), and, given the peak of the tensors alive during the call
    (`peak`, arguments included), of what the call held beyond its
    arguments."""
    args, outs = _tensors(cell.args), _tensors(out)
    ids = {id(t) for t in args}
    arg_bytes = _nbytes(args)
    return {
        "argument_bytes_per_device": arg_bytes,
        "output_bytes_per_device": _nbytes(outs),
        "temp_bytes_per_device": None if peak is None else peak - arg_bytes,
        "alias_bytes_per_device": _nbytes([t for t in outs if id(t) in ids]),
        "peak_bytes_per_device": peak,
    }


class _PeakTracker(MemTracker):
    """torch's `MemTracker` without the tensors of DTensor's sharding
    propagation: it runs each new op once on fake tensors of the global
    shapes, under the caller's fake mode, which `MemTracker`'s own test
    (a fake mode other than the one on entry) does not tell apart."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if in_propagation():
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


def _peak_bytes(tracker, device_type: str) -> int:
    """The tracker's peak of live bytes on devices of `device_type`."""
    return sum(int(v["Total"]) for dev, v in tracker.get_tracker_snapshot("peak").items()
               if torch.device(dev).type == device_type)


def _skipped(arch: str, shape_name: str, multi_pod: bool) -> dict:
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "status": "skipped",
        "reason": "long_500k requires sub-quadratic attention "
                  "(docs/design.md §5)",
    }


def _cell_path(out_dir: str, arch: str, shape_name: str, multi_pod: bool) -> str:
    return os.path.join(out_dir, f"{arch.replace('/', '_')}__{shape_name}__"
                                 f"{'multi' if multi_pod else 'single'}.json")


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             variant: str = "baseline", device: str = "cuda") -> dict:
    cfg = get_config(arch)
    shapes = cfg.supported_shapes()
    if shape_name not in shapes:
        return _skipped(arch, shape_name, multi_pod)
    shape = shapes[shape_name]
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    n_chips = mesh.size()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t0 = time.time()
    with fake_tensors(), use_mesh(mesh):
        cell, meta = build_cell(cfg, shape, mesh, multi_pod, variant)
        t_build = time.time() - t0
        counter, tracker = OpCounter(), _PeakTracker()
        tracker.track_external(*_tensors(cell.args))
        with tracker, counter:
            out = cell()
        t_count = time.time() - t0 - t_build
        mem = memory_of(cell, out, _peak_bytes(tracker, mesh.device_type))
    counts = counter.result()
    mf = model_flops(cfg, shape, meta["tokens"])
    terms = roofline_terms(counts)
    per_dev_model_flops = mf / n_chips
    result = {
        "arch": arch,
        "variant": variant,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": n_chips,
        "device": device,
        "status": "ok",
        "build_s": round(t_build, 1),
        "count_s": round(t_count, 1),
        "memory_analysis": mem,
        "op_count_per_device": counts,
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_device": per_dev_model_flops,
        "useful_flops_ratio": (
            per_dev_model_flops / counts["flops"] if counts["flops"] else None
        ),
        "hw": HW_H100,
        # bytes the cell's build and run allocated on the card: none
        "cuda_bytes_allocated": (torch.cuda.max_memory_allocated() - held
                                 if device == "cuda" else None),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(_cell_path(out_dir, arch, shape_name, multi_pod), "w") as f:
        json.dump(result, f, indent=1)
    return result


def device_gb(r: dict) -> float:
    """GB a cell holds on each device at its peak."""
    return r["memory_analysis"]["peak_bytes_per_device"] / 1e9


def _card_allocations() -> list:
    """One line per allocation on the card that the memory history kept:
    its bytes, the function that made it and the innermost Python frames
    (torch's FakeTensorMode makes a 1-element tensor on the card to start
    the CUDA context, in `init_gpu_context`, once per process)."""
    lines = []
    for trace in torch.cuda.memory._snapshot().get("device_traces", []):
        for ev in trace:
            if ev.get("action") == "alloc":
                frames = [f for f in ev.get("frames", [])
                          if f.get("filename", "").endswith(".py")][:6]
                where = " <- ".join(f"{f['filename']}:{f['line']}" for f in frames)
                by = frames[0]["name"] if frames else "?"
                lines.append(f"cuda allocation: {ev['size']} bytes by {by} at {where}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.all or args.arch is None else [args.arch]
    shape_names = (
        ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
        if args.shape is None
        else [args.shape]
    )
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    if args.device == "cuda":  # where anything lands on the card, if it does
        torch.cuda.memory._record_memory_history(max_entries=100)
    failures = 0
    for arch in archs:
        for sn in shape_names:
            for mp in meshes:
                tag = f"{arch:28s} {sn:12s} {'2x16x16' if mp else '16x16 '}"
                fn = _cell_path(args.out, arch, sn, mp)
                if args.skip_existing and os.path.exists(fn):
                    with open(fn) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached ] {tag}")
                        continue
                try:
                    r = run_cell(arch, sn, mp, args.out, args.variant, args.device)
                    if r["status"] == "skipped":
                        print(f"[skipped] {tag} — {r['reason']}")
                    else:
                        tms = r["roofline"]
                        print(
                            f"[ok     ] {tag} compile={r['count_s']:.0f}s "
                            f"dom={tms['dominant']:<12s} "
                            f"c/m/coll(ms)={tms['compute_s']*1e3:.1f}/"
                            f"{tms['memory_s']*1e3:.1f}/"
                            f"{tms['collective_s']*1e3:.1f} "
                            f"mem={device_gb(r):.2f}GB/{HW_H100['hbm_bytes'] / 1e9:.0f}"
                        )
                except Exception as e:
                    failures += 1
                    print(f"[FAIL   ] {tag}: {e}")
                    traceback.print_exc()
                    os.makedirs(args.out, exist_ok=True)
                    with open(fn, "w") as f:
                        json.dump(
                            {"arch": arch, "shape": sn,
                             "mesh": "2x16x16" if mp else "16x16",
                             "status": "fail", "error": str(e)}, f)
    if args.device == "cuda":
        print(f"cuda max_memory_allocated={torch.cuda.max_memory_allocated()}")
        for line in _card_allocations():
            print(line)
    print(f"done; failures={failures}")
    with contextlib.suppress(Exception):
        dist.destroy_process_group()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
