"""Train a tiny LM end to end: the full stack (synthetic data pipeline,
AdamW, remat, microbatching, int8 error-feedback gradient compression,
async checkpoints, failure injection + restart).

    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm               # on the card
    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm --device cpu

The twin of `examples/train_tiny_lm.py`: stablelm-3b at its reduced
widths in float32, 150 steps of 8 x 32 tokens in 2 microbatches, AdamW
(peak 3e-3, warm-up 10), a checkpoint every 25 steps under the
`Supervisor`, and a node loss injected at step 60: the supervisor
restores the last checkpoint (after the writer has finished) and
replays from there.  The example is tiny by design on the card too;
`python -m repro_torch.launch.train` trains at full width.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.examples import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.supervisor import FailureInjector, Supervisor
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step

STEPS = 150


def run(device, *, steps: int = STEPS, fail_at=(60,), ckpt_every: int = 25,
        out=print) -> dict:
    """Train for `steps` steps on `device` through a failure at each step
    of `fail_at`; returns the losses and the restarts.  Raises unless
    the loss fell."""
    dev = torch.device(device)
    cfg = get_config("stablelm-3b").reduced()
    tcfg = TrainConfig(
        microbatches=2,
        remat=True,
        dtype=torch.float32,
        compress_grads=True,  # int8 error-feedback wire simulation
        optimizer=AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=steps),
    )
    data = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=8, seed=0)
    step = make_train_step(cfg, tcfg)

    def make_state():   # the same initial state on every call
        return init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        sup = Supervisor(
            make_state=make_state,
            step_fn=lambda st, i: step(st, data.batch_at(i)),
            ckpt_manager=CheckpointManager(ckpt_dir),
            ckpt_every=ckpt_every,
            failure_injector=FailureInjector(fail_at_steps=tuple(fail_at)),  # node loss!
        )
        sup.run(steps)
    losses = [h["loss"] for h in sup.history]
    win = min(10, len(losses) // 2)
    first, last = sum(losses[:win]) / win, sum(losses[-win:]) / win
    out(f"\nsteps run: {len(sup.history)} (incl. replay after "
        f"{sup.restarts} injected failure)")
    out(f"loss: first{win}={first:.3f} last{win}={last:.3f}")
    if not last < first:
        raise AssertionError(f"should have learned: first {first}, last {last}")
    out("loss decreased through a failure+restart  [OK]")
    return dict(steps_run=len(sup.history), restarts=sup.restarts, first_loss=losses[0],
                last_loss=losses[-1], first_mean=first, last_mean=last,
                steps=[h["step"] for h in sup.history], losses=losses)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
