"""The port's sharded loss and gradients on four gloo ranks against the
JAX package's unsharded ones.

The ranks are subprocesses (`torch_dist.Ranks`) that read JAX's
`init_params` (through numpy) and a seeded batch from files, run on
(2, 2) ("data", "model") meshes with the FSDP x TP rules of
`models.sharding`, and write their results back; JAX's references are
computed here meanwhile.  `train_loss(axes=...)` and its gradients in
fp32 (remat on) equal `jax.value_and_grad` of JAX's unsharded
`train_loss`: the loss within 1e-5 relative, each gradient leaf within
1e-5 of its largest element (JAX's own sharded-against-single test
allows 1e-3 on the loss), for stablelm-3b and phi3.5-moe reduced, the
MoE also with the einsum dispatch (4 groups of 32 tokens, constrained
over dp, the experts over tp), and stablelm-3b on the multi-pod axes
(('pod', 'data') as the dp group of a (2, 2, 1) mesh).  The hybrid and
ssm families: tests/test_torch_distribution_ssm.py; the sharded trainer
steps and the elastic restore: tests/test_torch_distribution_steps.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import train_loss as jtrain_loss
from repro_torch.tree_util import flatten
from torch_dist import Ranks, load_tree, save_tree

POD = dict(mesh=((2, 2), ("data", "model")), axes={})
CASES = {  # name: the arch, config changes, the mesh and MeshAxes' arguments
    "stablelm-3b": dict(POD, arch="stablelm-3b", replace={}),
    "phi3.5-moe": dict(POD, arch="phi3.5-moe-42b-a6.6b", replace={}),
    "phi3.5-moe-einsum": dict(POD, arch="phi3.5-moe-42b-a6.6b",
                              replace=dict(dispatch_mode="einsum", dispatch_group=32)),
    "stablelm-3b-multipod": dict(arch="stablelm-3b", replace={},
                                 mesh=((2, 2, 1), ("pod", "data", "model")),
                                 axes=dict(dp=("pod", "data"))),
}
B, S = 8, 16
LOSS_TOL, GRAD_TOL = 1e-5, 1e-5

RANK_SCRIPT = """
import dataclasses
from torch_dist import load_tree, save_tree
from repro_torch.configs import get_config
from repro_torch.data.pipeline import place_on_mesh
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.models.sharding import MeshAxes, param_specs, shard_tree
from repro_torch.models.transformer import params_from_numpy, train_loss
from repro_torch.tree_util import flatten, tree_map

batch = dict(np.load(os.path.join(OUT, "batch.npz")))
full = lambda tree: tree_map(lambda t: t.detach().full_tensor().numpy(), tree)

for key, case in CASES.items():
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["replace"])
    axes = MeshAxes(**case["axes"])
    mesh = make_test_mesh(*case["mesh"])
    params = params_from_numpy(cfg, load_tree(os.path.join(OUT, case["arch"] + ".npz")),
                               "cpu")
    sp = shard_tree(params, param_specs(axes, params), mesh)
    for p in flatten(sp)[0]:
        p.requires_grad_(True)
    with use_mesh(mesh):
        loss = train_loss(cfg, sp, place_on_mesh(batch, mesh, axes.dp), axes=axes,
                          dtype=torch.float32, remat=True)
        loss.backward()
    out = dict(full(tree_map(lambda p: p.grad, sp)), loss=loss.detach().full_tensor().numpy())
    if RANK == 0:
        save_tree(os.path.join(OUT, "grads_" + key + ".npz"), out)

print("RANK OK")
"""


def start_runs(d, cases) -> dict:
    """Write the inputs, start the ranks on `cases`, compute JAX's
    unsharded loss and gradients of each case meanwhile, collect."""
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
             "labels": rng.integers(0, 256, (B, S)).astype(np.int32)}
    np.savez(d / "batch.npz", **batch)
    jparams = {}
    for arch in {c["arch"] for c in cases.values()}:
        jparams[arch] = jinit_params(jget_config(arch).reduced(), jax.random.PRNGKey(0))
        save_tree(d / f"{arch}.npz", jax.tree.map(np.asarray, jparams[arch]))
    ranks = Ranks(4, f"CASES = {cases!r}\n" + RANK_SCRIPT, d)
    ref = {"dir": d}
    for key, case in cases.items():
        jcfg = dataclasses.replace(jget_config(case["arch"]).reduced(), **case["replace"])
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jtrain_loss(jcfg, p, batch, dtype=jnp.float32)))(jparams[case["arch"]])
        ref[key] = (float(loss), jax.tree.leaves(jax.tree.map(np.asarray, grads)))
    outs = ranks.wait(timeout=170)
    assert all("RANK OK" in o for o in outs)
    return ref


def check_case(runs, key, loss_tol, grad_tol) -> None:
    loss, want = runs[key]
    got = load_tree(runs["dir"] / f"grads_{key}.npz")
    assert abs(float(got.pop("loss")) - loss) <= loss_tol * abs(loss)
    got_leaves = flatten(got)[0]
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= grad_tol * scale


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_runs(tmp_path_factory.mktemp("dist_train"), CASES)


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_loss_and_grads_match_jax(runs, key):
    check_case(runs, key, LOSS_TOL, GRAD_TOL)
