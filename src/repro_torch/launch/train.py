"""Training launcher.

Counterpart of `repro/launch/train.py`, with the same flags and the same
last JSON line (`first_loss`, `last_loss`, `steps`), plus `--device`
(default `cuda`).  Parameters are random, drawn on the device by a
generator seeded with `--seed`, and held in float32; the compute dtype
is bf16 on the card and fp32 on the CPU, as JAX picks it by backend.
With `--ckpt-dir` the `Supervisor` checkpoints and restarts after the
failures `--fail-at` injects.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --reduced --device cpu --steps 100 --batch 8 --seq 64 --ckpt-dir D
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.supervisor import (
    FailureInjector,
    StragglerDetector,
    Supervisor,
)
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step


def train_fns(cfg, tcfg: TrainConfig, *, batch: int, seq: int, seed: int, device):
    """(make_state, step_fn) of the launcher: `make_state()` draws the
    same initial state on every call (a restart rebuilds it before the
    restore), `step_fn(state, idx)` trains on the data stream's batch
    `idx`."""
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    step = make_train_step(cfg, tcfg)

    def make_state():
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_train_state(cfg, tcfg, gen, device)

    def step_fn(state, idx):
        return step(state, data.batch_at(idx))

    return make_state, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        remat=True,
        dtype=dtype,
        compress_grads=args.compress_grads,
        optimizer=AdamWConfig(
            peak_lr=args.lr, warmup_steps=20, total_steps=args.steps
        ),
    )
    make_state, step_fn = train_fns(cfg, tcfg, batch=args.batch, seq=args.seq,
                                    seed=args.seed, device=device)

    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        sup = Supervisor(
            make_state,
            step_fn,
            ckpt,
            ckpt_every=args.ckpt_every,
            failure_injector=FailureInjector(tuple(args.fail_at)),
            straggler=StragglerDetector(),
        )
        sup.run(args.steps)
        hist = sup.history
    else:
        state = make_state()
        hist = []
        for i in range(args.steps):
            state, m = step_fn(state, i)
            hist.append({"step": i, "loss": float(m["loss"])})
            if i % args.log_every == 0:
                print(f"step {i:5d} loss {float(m['loss']):.4f} "
                      f"lr {float(m['lr']):.2e}")
    out = {"first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
           "steps": len(hist)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
