"""The port's trainer, driver and launcher against the JAX package.

- `make_train_step` takes five steps beside JAX's jitted one from JAX's
  `init_train_state` (stablelm-3b reduced, fp32, remat), with 1 and 2
  microbatches and compression off and on.  Each step's loss must be
  within 1e-5 relative of JAX's (worst seen 5.5e-6, with compression;
  1.6e-7 without).  The final parameters must be within 5 x peak_lr of
  JAX's, element for element: a gradient one ulp apart can put an
  element on the other side of an int8 rounding boundary, and an Adam
  step moves an element by about lr at most (worst seen 3.5e-3, with
  compression).  Without compression they must also be within 1e-3 of
  each leaf's largest element (worst seen 2.7e-5);
- twins of tests/test_substrates.py's TestTrainerLoop and of
  tests/test_system.py's train CLI test (a subprocess of
  `python -m repro_torch.launch.train --device cpu`);
- `Trainer` with checkpoints; a sharded step's refusal of other `axes`
  and of a missing mesh;
- the hybrid and ssm families (zamba2-1.2b, rwkv6-7b reduced): three
  steps beside JAX's jitted step (loss within 1e-5 relative, parameters
  within 1e-3 of each leaf's largest element), each family's train
  state restored across packages, and the launcher on zamba2.
"""

import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import init_train_state as jinit_train_state
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.sharding import MeshAxes
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import (
    TrainConfig,
    Trainer,
    init_train_state,
    make_train_step,
)
from repro_torch.tree_util import flatten, leaves
from test_torch_train_model import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=5)


@pytest.mark.parametrize("microbatches, compress", [(1, False), (2, False), (1, True),
                                                    (2, True)])
def test_train_steps_track_jax(microbatches, compress):
    jcfg = jget_config("stablelm-3b").reduced()
    cfg = get_config("stablelm-3b").reduced()
    jtcfg = JTrainConfig(microbatches=microbatches, dtype=jnp.float32,
                         compress_grads=compress, optimizer=JAdamWConfig(**OPT))
    tcfg = TrainConfig(microbatches=microbatches, dtype=torch.float32,
                       compress_grads=compress, optimizer=AdamWConfig(**OPT))
    jstate = jinit_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    _, treedef = flatten(init_train_state(cfg, tcfg, torch.Generator(), "cpu"))
    state = treedef.unflatten([torch.from_numpy(np.array(x))
                               for x in jax.tree_util.tree_leaves(jstate)])
    jstep = jax.jit(jmake_train_step(jcfg, jtcfg))
    step = make_train_step(cfg, tcfg)
    data = JSyntheticLM(cfg.vocab_size, 16, 4, seed=0)
    for i in range(5):
        batch = data.batch_at(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert int(state.opt.step) == int(jstate.opt.step) == 5
    for mine, theirs in zip(leaves(state.params), jax.tree_util.tree_leaves(jstate.params)):
        theirs = np.asarray(theirs)
        err = np.abs(mine.detach().numpy() - theirs).max()
        assert err <= 5 * OPT["peak_lr"]
        if not compress:
            assert err <= 1e-3 * np.abs(theirs).max()
    assert len(leaves(state.error_buf)) == (len(leaves(state.params)) if compress else 0)


def test_loss_decreases_tiny_lm():
    cfg = get_config("stablelm-3b").reduced()
    tcfg = TrainConfig(
        microbatches=2, remat=True, dtype=torch.float32, compress_grads=True,
        optimizer=AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60),
    )
    data = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)
    step = make_train_step(cfg, tcfg)
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    losses = []
    for i in range(60):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2


def test_trainer_checkpoints_and_logs():
    cfg = get_config("stablelm-3b").reduced()
    tcfg = TrainConfig(dtype=torch.float32, optimizer=AdamWConfig(warmup_steps=1))
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d)
        tr = Trainer(cfg, tcfg, SyntheticLM(cfg.vocab_size, 8, 2), make_train_step(cfg, tcfg),
                     state, ckpt_manager=ckpt, ckpt_every=2,
                     hooks={"pre_step": seen.append})
        last = tr.run(5)
        ckpt.wait()
        assert seen == [0, 1, 2, 3, 4] and tr.step_idx == 5
        assert [r["step"] for r in tr.metrics_log] == seen and len(tr.step_times) == 5
        assert set(last) == {"loss", "grad_norm", "lr", "step_time_s"}
        assert ckpt.all_steps() == [2, 4]
        back = ckpt.restore(4, like=tr.state)
        assert int(back.opt.step) == 4


def test_train_cli_loss_decreases_with_failure_recovery():
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm-3b",
             "--reduced", "--device", "cpu", "--steps", "40", "--batch", "8", "--seq",
             "32", "--lr", "3e-3", "--ckpt-dir", d, "--ckpt-every", "10", "--fail-at",
             "17"],
            # tiny tensors: one thread each, beside the other test workers
            env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=240,
        )
        assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
        stats = json.loads(r.stdout.strip().splitlines()[-1])
        assert stats["last_loss"] < stats["first_loss"]
        # 40 steps plus the 7 replayed after the failure at 17
        assert stats["steps"] == 47
        assert any(n.startswith("step_") for n in os.listdir(d))


def _state_from_jax(cfg, tcfg, jstate):
    _, treedef = flatten(init_train_state(cfg, tcfg, torch.Generator(), "cpu"))
    return treedef.unflatten([torch.from_numpy(np.array(x))
                              for x in jax.tree_util.tree_leaves(jstate)])


@pytest.mark.parametrize("name", ["zamba2-1.2b", "rwkv6-7b"])
def test_hybrid_ssm_train_steps_track_jax(name):
    """Three steps of each family beside JAX's jitted step (fp32, remat,
    2 microbatches), held as test_train_steps_track_jax holds them.  The
    stacked per-head leaves (`A_log`, the RWKV mixes, ...) are decayed,
    as JAX's `adamw.update` decays every leaf with ndim >= 2."""
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    jtcfg = JTrainConfig(microbatches=2, dtype=jnp.float32, optimizer=JAdamWConfig(**OPT))
    tcfg = TrainConfig(microbatches=2, dtype=torch.float32, optimizer=AdamWConfig(**OPT))
    jstate = jinit_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    state = _state_from_jax(cfg, tcfg, jstate)
    jstep = jax.jit(jmake_train_step(jcfg, jtcfg))
    step = make_train_step(cfg, tcfg)
    data = JSyntheticLM(cfg.vocab_size, 16, 4, seed=0)
    for i in range(3):
        batch = data.batch_at(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    for mine, theirs in zip(leaves(state.params), jax.tree_util.tree_leaves(jstate.params)):
        theirs = np.asarray(theirs)
        err = np.abs(mine.detach().numpy() - theirs).max()
        assert err <= 1e-3 * np.abs(theirs).max()


@pytest.mark.parametrize("name", ["zamba2-1.2b", "rwkv6-7b"])
def test_hybrid_ssm_checkpoint_restores_across_packages(name):
    """Each family's train state: port -> JAX and JAX -> port, leaf for
    leaf (the hybrid's [G, attn_every] stacks and the shared block)."""
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    tcfg, jtcfg = TrainConfig(dtype=torch.float32), JTrainConfig(dtype=jnp.float32)
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    state.opt.step.fill_(2)
    jstate = jinit_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    mine, jleaves = leaves(state), jax.tree_util.tree_leaves(jstate)
    assert [tuple(x.shape) for x in mine] == [x.shape for x in jleaves]
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d, async_io=False).save(2, state)
        back = JCheckpointManager(d, async_io=False).restore(2, like=jstate)
        for a, b in zip(mine, jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with tempfile.TemporaryDirectory() as d:
        JCheckpointManager(d, async_io=False).save(3, jstate)
        back = CheckpointManager(d).restore(3, like=state)
        assert set(back.params) == set(state.params)
        for a, b in zip(leaves(back), jleaves):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_train_cli_hybrid():
    """The launcher trains zamba2-1.2b reduced on the CPU, as JAX's
    launcher does (`--arch zamba2-1.2b`)."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "zamba2-1.2b",
         "--reduced", "--device", "cpu", "--steps", "12", "--batch", "8", "--seq", "32",
         "--lr", "3e-3"],
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240,
    )
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["steps"] == 12 and stats["last_loss"] < stats["first_loss"]


def test_sharded_options_refused():
    """`axes` must be a MeshAxes, and a sharded step needs a current mesh
    (the sharded path itself: tests/test_torch_distribution_*.py)."""
    cfg = get_config("stablelm-3b").reduced()
    with pytest.raises(TypeError, match="MeshAxes"):
        make_train_step(cfg, TrainConfig(), axes=object())
    tcfg = TrainConfig(dtype=torch.float32, constrain_grads=True)
    step = make_train_step(cfg, tcfg, axes=MeshAxes())
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLM(cfg.vocab_size, 8, 2).batch_at(0)
    with pytest.raises(RuntimeError, match="current mesh"):
        step(state, batch)
