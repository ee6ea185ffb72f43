"""Elastic rescale demo: train on a (4, 2) mesh, checkpoint, restore onto
a (2, 4) mesh and continue: the code path a cluster uses after losing
(or gaining) nodes.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.elastic_restart   # 8 cards, one NCCL rank each

The twin of `examples/elastic_restart.py`.  It starts 8 ranks of
`torch.distributed` (`launch/ranks.py`: with `--device cpu` gloo ranks
on this host's CPU, one thread each; on the card, the default, one NCCL
rank per card, so it needs 8 cards), which train stablelm-3b at its
reduced widths in float32 with remat for 4 steps on the ("data",
"model") mesh (4, 2), checkpoint synchronously, restore onto (2, 4)
with `CheckpointManager.restore(..., shardings=...)` and train 4 more
steps.  Beyond the JAX example, this process runs the same 8 steps
unsharded (`make_train_step` without axes, from the same initial state
and batches) meanwhile and holds the 8 sharded losses within 1e-5
relative of them; it exits non-zero otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.examples import resolve_device
from repro_torch.launch.ranks import Ranks
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step

ARCH = "stablelm-3b"
SEQ, BATCH = 16, 8
LOSS_TOL = 1e-5

RANK_SCRIPT = """
import json
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.models.sharding import MeshAxes, named_shardings, param_specs, shard_tree
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step
from repro_torch.tree_util import flatten

dev = torch.device("cuda" if BACKEND == "nccl" else "cpu")
cfg = get_config(ARCH).reduced()
tcfg = TrainConfig(remat=True, dtype=torch.float32)
axes = MeshAxes(dp=("data",), tp="model")
data = SyntheticLM(cfg.vocab_size, SEQ, BATCH)
step = make_train_step(cfg, tcfg, axes)
losses = []


def fresh():
    return init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev)


def run_steps(mesh, state, n, start):
    with use_mesh(mesh):
        for i in range(start, start + n):
            state, m = step(state, data.batch_at(i))
            losses.append(float(m["loss"]))
            if RANK == 0:
                print(f"  mesh={tuple(mesh.shape)} step {i} loss {losses[-1]:.4f}", flush=True)
    return state


if RANK == 0:
    print(f"phase 1: (data={MESHES[0][0]}, model={MESHES[0][1]})", flush=True)
mesh1 = make_test_mesh(MESHES[0], ("data", "model"))
state = fresh()
state = run_steps(mesh1, shard_tree(state, param_specs(axes, state), mesh1), STEPS, 0)
ckpt = CheckpointManager(os.path.join(OUT, "ckpt"), async_io=False)
ckpt.save(STEPS, state)
if RANK == 0:
    print("checkpoint saved; simulating topology change (lost a slice)...", flush=True)
mesh2 = make_test_mesh(MESHES[1], ("data", "model"))
like = fresh()
restored = ckpt.restore(ckpt.latest_step(), like=like,
                        shardings=named_shardings(param_specs(axes, like), mesh2))
assert all(t.device_mesh is mesh2 for t in flatten(restored)[0])
if RANK == 0:
    print(f"phase 2: restored onto (data={MESHES[1][0]}, model={MESHES[1][1]}), "
          "training continues", flush=True)
run_steps(mesh2, restored, STEPS, STEPS)
if RANK == 0:
    with open(os.path.join(OUT, "losses.json"), "w") as f:
        json.dump(losses, f)
"""


@contextlib.contextmanager
def _threads(n: int):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def unsharded_losses(device, n_steps: int) -> list:
    """The same steps in this process, unsharded, from the same state."""
    dev = torch.device(device)
    cfg = get_config(ARCH).reduced()
    tcfg = TrainConfig(remat=True, dtype=torch.float32)
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH)
    step = make_train_step(cfg, tcfg)
    state = init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    losses = []
    for i in range(n_steps):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    return losses


def run(device, *, meshes=((4, 2), (2, 4)), steps: int = 4, timeout: float = 600.0,
        out=print) -> dict:
    """The demo on ranks of `device`'s kind (gloo ranks for the CPU, one
    NCCL rank per card for cuda); returns the sharded and unsharded
    losses.  Raises if a rank fails or a loss differs."""
    dev = torch.device(device)
    n = meshes[0][0] * meshes[0][1]
    if meshes[1][0] * meshes[1][1] != n:
        raise ValueError(f"both meshes must have {n} ranks: {meshes}")
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} NCCL ranks need {n} cards, torch sees "
                           f"{torch.cuda.device_count()}; pass --device cpu for gloo ranks")
    consts = (f"ARCH, SEQ, BATCH = {ARCH!r}, {SEQ}, {BATCH}\n"
              f"MESHES, STEPS = {tuple(meshes)!r}, {steps}\n")
    with tempfile.TemporaryDirectory() as d:
        ranks = Ranks(n, consts + RANK_SCRIPT, d, backend=backend)
        try:
            with _threads(1):
                want = unsharded_losses(dev if backend == "gloo" else "cuda", 2 * steps)
        finally:
            outs = ranks.wait(timeout)
        for line in outs[0].splitlines():
            if line.startswith(("phase", "  mesh=", "checkpoint")):
                out(line)
        with open(os.path.join(d, "losses.json")) as f:
            got = json.load(f)
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    out(f"unsharded, one process: {' '.join(f'{w:.4f}' for w in want)}")
    out(f"largest relative difference of the {len(got)} losses: {max(rel):.3g} "
        f"(limit {LOSS_TOL:g})")
    if len(got) != 2 * steps or max(rel) > LOSS_TOL:
        raise AssertionError(f"sharded losses {got} differ from unsharded {want}")
    out("elastic rescale OK")
    return dict(ranks=n, meshes=[list(m) for m in meshes], backend=backend, losses=got,
                unsharded=want, max_rel=max(rel))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: one NCCL rank per card) or cpu (gloo ranks)")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
