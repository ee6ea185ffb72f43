"""The port's sharded trainer on four gloo ranks against the JAX
package's unsharded one, and the elastic restore.

The ranks are subprocesses (`torch_dist.Ranks`) that read JAX's
`init_params` (through numpy) and seeded batches from files, and run
on (2, 2) and (1, 4) ("data", "model") meshes; JAX's references and the
unsharded port run are computed here meanwhile.

- one `make_train_step(cfg, tcfg, axes)` step of stablelm-3b reduced
  with `constrain_grads` on (2 microbatches) and off (1) equals JAX's
  jitted step: the loss within 1e-5 relative, the parameters within
  5 x peak_lr element for element and 1e-3 of each leaf's largest
  element (the criterion of tests/test_torch_trainer.py);
- elastic restore: three sharded steps on (2, 2), a checkpoint, a
  restore onto (1, 4) with `shardings`, three more steps: the six
  losses equal an unsharded port run's within 1e-5 relative, and JAX's
  `CheckpointManager` restores the checkpoint into JAX's `TrainState`
  with the unsharded run's parameters after three steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import init_train_state as jinit_train_state
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, TrainState, make_train_step
from repro_torch.tree_util import flatten, leaves
from test_torch_train_model import one_thread  # noqa: F401  (autouse fixture)
from torch_dist import Ranks, load_tree, save_tree

DENSE = "stablelm-3b"
B, S = 8, 16
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6)
STEPS = {"constrained": (True, 2), "unconstrained": (False, 1)}
LOSS_TOL = 1e-5

RANK_SCRIPT = """
from torch_dist import load_tree, save_tree
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.models.sharding import MeshAxes, named_shardings, param_specs, shard_tree
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, TrainState, make_train_step
from repro_torch.tree_util import flatten, tree_map

axes = MeshAxes()
mesh = make_test_mesh((2, 2), ("data", "model"))
batch = dict(np.load(os.path.join(OUT, "batch.npz")))
full = lambda tree: tree_map(lambda t: t.detach().full_tensor().numpy(), tree)

cfg = get_config(DENSE).reduced()

def fresh_state(mesh):
    p = params_from_numpy(cfg, load_tree(os.path.join(OUT, DENSE + ".npz")), "cpu")
    state = TrainState(p, adamw.init(p), {})
    return shard_tree(state, param_specs(axes, state), mesh)

for key, (cg, micro) in STEPS.items():
    tcfg = TrainConfig(microbatches=micro, dtype=torch.float32, constrain_grads=cg,
                       optimizer=AdamWConfig(**OPT))
    with use_mesh(mesh):
        state, m = make_train_step(cfg, tcfg, axes)(fresh_state(mesh), batch)
    out = full(state.params)
    if RANK == 0:
        save_tree(os.path.join(OUT, "step_" + key + ".npz"),
                  dict(out, loss=m["loss"].numpy()))

tcfg = TrainConfig(dtype=torch.float32, constrain_grads=True, optimizer=AdamWConfig(**OPT))
step = make_train_step(cfg, tcfg, axes)
data = SyntheticLM(cfg.vocab_size, S, B, seed=0)
state, losses = fresh_state(mesh), []
with use_mesh(mesh):
    for i in range(3):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
ckpt = CheckpointManager(os.path.join(OUT, "ckpt"))
ckpt.save(3, state)
mesh14 = make_test_mesh((1, 4), ("data", "model"))
state = ckpt.restore(ckpt.latest_step(), state,
                     shardings=named_shardings(param_specs(axes, state), mesh14))
assert all(t.device_mesh is mesh14 for t in flatten(state)[0])
with use_mesh(mesh14):
    for i in range(3, 6):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
save("elastic", losses=np.array(losses))
print("RANK OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks, compute JAX's references meanwhile, collect."""
    d = tmp_path_factory.mktemp("dist_steps")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
             "labels": rng.integers(0, 256, (B, S)).astype(np.int32)}
    np.savez(d / "batch.npz", **batch)
    jparams = jinit_params(jget_config(DENSE).reduced(), jax.random.PRNGKey(0))
    save_tree(d / f"{DENSE}.npz", jax.tree.map(np.asarray, jparams))
    consts = (f"DENSE = {DENSE!r}\nB, S = {B}, {S}\nOPT = {OPT!r}\nSTEPS = {STEPS!r}\n")
    ranks = Ranks(4, consts + RANK_SCRIPT, d)

    ref = {"dir": d, "batch": batch}
    jcfg = jget_config(DENSE).reduced()
    for key, (cg, micro) in STEPS.items():
        jtcfg = JTrainConfig(microbatches=micro, dtype=jnp.float32, constrain_grads=cg,
                             optimizer=JAdamWConfig(**OPT))
        jstate = jinit_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
        jstate = jstate._replace(params=jparams)
        new, m = jax.jit(jmake_train_step(jcfg, jtcfg))(jstate, batch)
        ref["step_" + key] = (float(m["loss"]), jax.tree.map(np.asarray, new.params))

    # the unsharded port run the elastic one continues
    cfg = get_config(DENSE).reduced()
    p = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    state = TrainState(p, adamw.init(p), {})
    step = make_train_step(cfg, TrainConfig(dtype=torch.float32,
                                            optimizer=AdamWConfig(**OPT)))
    data = SyntheticLM(cfg.vocab_size, S, B, seed=0)
    losses = []
    for i in range(6):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
        if i == 2:
            ref["params_at_3"] = [t.detach().clone() for t in leaves(state.params)]
    ref["unsharded_losses"] = losses

    outs = ranks.wait(timeout=170)
    assert all("RANK OK" in o for o in outs)
    return ref


def _close_params(got: list, want: list) -> None:
    """tests/test_torch_trainer.py's criterion after Adam steps."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_array_less(np.abs(g - w), 5 * OPT["peak_lr"] + 1e-7)
        assert np.abs(g - w).max() <= 1e-3 * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("key", list(STEPS))
def test_sharded_train_step_matches_jax(runs, key):
    loss, params = runs["step_" + key]
    got = load_tree(runs["dir"] / f"step_{key}.npz")
    assert abs(float(got.pop("loss")) - loss) <= LOSS_TOL * abs(loss)
    _close_params(flatten(got)[0], jax.tree.leaves(params))


def test_elastic_restore_continues_at_unsharded_losses(runs):
    got = np.load(runs["dir"] / "elastic.npz")["losses"]
    want = np.array(runs["unsharded_losses"])
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=0)


def test_elastic_checkpoint_restores_in_jax(runs):
    jcfg = jget_config(DENSE).reduced()
    like = jinit_train_state(jcfg, JTrainConfig(dtype=jnp.float32), jax.random.PRNGKey(1))
    mgr = JCheckpointManager(os.path.join(runs["dir"], "ckpt"), async_io=False)
    assert mgr.latest_step() == 3
    restored = mgr.restore(3, like=like)
    assert int(restored.opt.step) == 3
    _close_params([np.asarray(x) for x in jax.tree.leaves(restored.params)],
                  [t.numpy() for t in runs["params_at_3"]])
