"""The training path on an NVIDIA card against the same path on the CPU
(reduced configs; skips without a card).

- fp32 training on the card equals the CPU from the same parameters
  (TF32 off): the loss within 1e-5 relative and every gradient leaf
  within 1e-4 of the leaf's largest element; AdamW on the card over the
  CPU's gradients gives the CPU's parameters, m and v within 1e-4 of
  each leaf's largest element; one `make_train_step` gives the CPU's
  loss and grad norm within 1e-5 relative.  Its parameters are held
  through those parts: Adam's first step is g / (|g| + eps) per element,
  so an element whose gradient lies within its tolerance of eps may move
  by anything up to 2 lr on either device.
- The launcher's `Supervisor` on the card (bf16, compressed gradients,
  two microbatches) survives a failure at step 17: one restart, steps
  10-16 replayed, the loss lower at the end, and the last checkpoint
  restores bit for bit.
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch.train import train_fns
from repro_torch.models.transformer import train_loss
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.supervisor import FailureInjector, StragglerDetector, Supervisor
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step
from repro_torch.tree_util import flatten, leaves, tree_map
from torch_card import cuda_device  # noqa: F401  (fixture)

LOSS_TOL, LEAF_TOL = 1e-5, 1e-4


def _value_and_grad(cfg, state, batch, device):
    flat = leaves(state.params)
    for p in flat:
        p.requires_grad_(True)
    loss = train_loss(cfg, state.params, to_device(batch, device), dtype=torch.float32)
    loss.backward()
    grads = [p.grad.detach().cpu() for p in flat]
    for p in flat:
        p.grad = None
    return float(loss.detach()), grads


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stablelm-3b", "gemma2-27b", "phi3.5-moe-42b-a6.6b"])
def test_train_step_on_card_equals_cpu(cuda_device, name):
    cfg = get_config(name).reduced()
    tcfg = TrainConfig(microbatches=2, dtype=torch.float32,
                       optimizer=AdamWConfig(peak_lr=3e-4, warmup_steps=1, total_steps=10))
    card = init_train_state(cfg, tcfg, torch.Generator(device=cuda_device).manual_seed(0),
                            cuda_device)
    host = tree_map(lambda x: x.detach().cpu().clone(), card)
    batch = SyntheticLM(cfg.vocab_size, 32, 4, seed=1).batch_at(0)
    loss, grads = _value_and_grad(cfg, card, batch, cuda_device)
    want, want_grads = _value_and_grad(cfg, host, batch, "cpu")
    assert abs(loss - want) <= LOSS_TOL * abs(want)
    for g, w in zip(grads, want_grads):
        assert float((g - w).abs().max()) <= LEAF_TOL * float(w.abs().max())
    treedef = flatten(host.params)[1]
    clone = lambda t: tree_map(lambda x: x.detach().clone(), t)  # noqa: E731
    got = adamw.update(tcfg.optimizer,
                       treedef.unflatten([g.to(cuda_device) for g in want_grads]),
                       clone(card.opt), clone(card.params))
    want_upd = adamw.update(tcfg.optimizer, treedef.unflatten([g.clone() for g in want_grads]),
                            clone(host.opt), clone(host.params))
    for a, b in zip(leaves(got[:2]), leaves(want_upd[:2])):
        a, b = a.cpu(), b.detach()
        assert float((a - b).abs().max()) <= LEAF_TOL * float(b.abs().max())
    step = make_train_step(cfg, tcfg)
    card, m = step(card, batch)
    host, want_m = step(host, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(want_m[k])) <= LOSS_TOL * abs(float(want_m[k]))
    assert int(card.opt.step) == 1 and card.opt.step.dtype == torch.int32


@pytest.mark.cuda
def test_supervisor_restart_on_card(cuda_device):
    cfg = dataclasses.replace(get_config("stablelm-3b").reduced(), n_layers=4)
    tcfg = TrainConfig(microbatches=2, dtype=torch.bfloat16, compress_grads=True,
                       optimizer=AdamWConfig(peak_lr=3e-3, warmup_steps=20, total_steps=30))
    make_state, step_fn = train_fns(cfg, tcfg, batch=8, seq=32, seed=0, device=cuda_device)
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d)
        sup = Supervisor(make_state, step_fn, ckpt, ckpt_every=10,
                         failure_injector=FailureInjector((17,)),
                         straggler=StragglerDetector())
        state = sup.run(30)
        seen = [h["step"] for h in sup.history]
        assert sup.restarts == 1 and seen[-1] == 29 and len(seen) == 37
        assert all(seen.count(s) == 2 for s in range(10, 17))
        assert sup.history[-1]["loss"] < sup.history[0]["loss"]
        assert ckpt.all_steps() == [10, 20, 30]
        back = ckpt.restore(30, like=state)
        for a, b in zip(leaves(state), leaves(back)):
            assert b.device == a.device and torch.equal(a.detach(), b)
        assert np.isfinite([h["grad_norm"] for h in sup.history]).all()
