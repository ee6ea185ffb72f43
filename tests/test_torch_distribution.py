"""The port's distribution layer against the JAX package: sharding
rules, the compressed all-reduce, error feedback on sharded leaves, the
pipeline, and batch placement.

- `param_specs` equals JAX's, spec for spec (compared as tuples), for
  every leaf of every registry config's reduced parameters (JAX's tree,
  through `jax.eval_shape`, and the port's own `init_params`), and of a
  `TrainState` with its optimizer moments and error buffer, on the
  one-pod axes, the multi-pod axes (('pod', 'data') as the dp group)
  and with FSDP off.  One process.
- Four gloo ranks, each a subprocess (`torch_dist.run_ranks`), with
  inputs made from a numpy seed and passed by file:
  - `compressed_psum` over one mesh axis ("dp" of a (4,) mesh) and over
    two flattened ones (("pod", "data") of a (2, 2) mesh) is bit-equal
    to JAX's `shard_map` result on 4 forced host devices (run in a
    subprocess: JAX fixes the device count at its first use);
  - `ef_roundtrip` of sharded leaves (uneven shards, nonzero error
    buffers) equals JAX's on the whole arrays bit for bit, and keeps
    each leaf's placement;
  - `pipeline_apply` on a 4-stage ring at JAX's test shapes (L=8,
    n_micro=4, mb=2, d=16) equals the sequential layers within 1e-5
    and its gradient within 1e-4 (JAX's bounds), with the stacked
    weights given sharded over 'pipe' or whole; `make_pp_loss` too;
  - `place_on_mesh` shards the leading dim over the dp axes and
    replicates it over the rest.
- `dp_axes`, and the refusals of a mesh without a process group and of
  sharded code without a current mesh.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models.sharding import MeshAxes as JMeshAxes
from repro.models.sharding import param_specs as jparam_specs
from repro.optim.compression import ef_roundtrip as jef_roundtrip
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import init_train_state as jinit_train_state
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCH_NAMES
from repro_torch.models.sharding import MeshAxes, P, param_specs, spec_leaves
from repro_torch.models.transformer import init_params
from repro_torch.train.trainer import TrainConfig, init_train_state
from torch_dist import REPO, run_ranks

AXES = {
    "pod": (dict(dp=("data",), tp="model", fsdp=True)),
    "multipod": (dict(dp=("pod", "data"), tp="model", fsdp=True)),
    "nofsdp": (dict(dp=("data",), tp="model", fsdp=False)),
}


def _jax_specs(tree) -> list:
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree) -> list:
    return [tuple(s) for s in spec_leaves(tree)]


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_jax(name, axes):
    jshapes = jax.eval_shape(lambda: jinit_params(jget_config(name).reduced(),
                                                  jax.random.PRNGKey(0)))
    want = _jax_specs(jparam_specs(JMeshAxes(**AXES[axes]), jshapes))
    assert _port_specs(param_specs(MeshAxes(**AXES[axes]), jshapes)) == want
    port = init_params(get_config(name).reduced(), torch.Generator().manual_seed(0), "cpu")
    got = param_specs(MeshAxes(**AXES[axes]), port)
    assert _port_specs(got) == want
    assert all(isinstance(s, P) for s in spec_leaves(got))
    if axes == "pod":  # the rules shard something in every config
        assert any(any(e is not None for e in s) for s in want)


@pytest.mark.parametrize("axes", list(AXES))
def test_train_state_specs_match_jax(axes):
    name = "phi3.5-moe-42b-a6.6b"
    jstate = jax.eval_shape(lambda: jinit_train_state(
        jget_config(name).reduced(), JTrainConfig(compress_grads=True),
        jax.random.PRNGKey(0)))
    want = _jax_specs(jparam_specs(JMeshAxes(**AXES[axes]), jstate))
    state = init_train_state(get_config(name).reduced(), TrainConfig(compress_grads=True),
                             torch.Generator().manual_seed(0), "cpu")
    assert _port_specs(param_specs(MeshAxes(**AXES[axes]), state)) == want
    assert _port_specs(param_specs(None, state)) == [()] * len(want)


def test_mesh_helpers():
    """JAX's dp axes; a mesh needs a running process group, and sharded
    code a current mesh."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.sharding import active_mesh

    assert mesh_lib.dp_axes(False) == ("data",)
    assert mesh_lib.dp_axes(True) == ("pod", "data")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_test_mesh((1, 1))
    with pytest.raises(RuntimeError, match="use_mesh"):
        active_mesh()


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

PSUM_SHAPES = {"x512": (4, 512), "x1000": (4, 1000)}
EF_LEAVES = {  # name: (shape, spec on the (2, 2) ("data", "model") mesh)
    "a": ((64, 100), ("data", "model")),
    "b": ((3, 70, 33), (None, "model", "data")),
    "c": ((37,), (("data", "model"),)),
    "d": ((5, 256), ()),
}
L, N_MICRO, MB, D = 8, 4, 2, 16

RANK_SCRIPT = """
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from repro_torch.data.pipeline import place_on_mesh
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.models.sharding import P, placements
from repro_torch.optim.compression import compressed_psum, ef_roundtrip
from repro_torch.train.pp import make_pp_loss, pipeline_apply

inp = dict(np.load(os.path.join(OUT, "inputs.npz")))
mesh4 = make_test_mesh((4,), ("dp",))
mesh22 = make_test_mesh((2, 2), ("pod", "data"))
out = {}
with use_mesh(mesh4):
    for k in PSUM_SHAPES:
        out["one_" + k] = compressed_psum(torch.from_numpy(inp[k][RANK]), "dp").numpy()
with use_mesh(mesh22):
    for k in PSUM_SHAPES:
        out["two_" + k] = compressed_psum(torch.from_numpy(inp[k][RANK]),
                                          ("pod", "data")).numpy()
save("psum", **out)

mesh = make_test_mesh((2, 2), ("data", "model"))
grads, errs = {}, {}
for k, (shape, spec) in EF_LEAVES.items():
    pl = placements(P(*spec), mesh)
    grads[k] = distribute_tensor(torch.from_numpy(inp["g_" + k]), mesh, pl)
    errs[k] = distribute_tensor(torch.from_numpy(inp["e_" + k]), mesh, pl)
rec, err = ef_roundtrip(grads, errs)
for k in EF_LEAVES:
    assert rec[k].placements == grads[k].placements, (k, rec[k].placements)
    assert err[k].placements == grads[k].placements, (k, err[k].placements)
save("ef", **{"rec_" + k: rec[k].full_tensor().numpy() for k in rec},
     **{"err_" + k: err[k].full_tensor().numpy() for k in err})

pipe = make_test_mesh((4,), ("pipe",))
body = lambda w, h: torch.tanh(h @ w)
x = torch.from_numpy(inp["pp_x"])
res = {}
for mode in ("sharded", "whole"):
    W = torch.from_numpy(inp["pp_w"])
    W = (distribute_tensor(W, pipe, [Shard(0)]) if mode == "sharded" else W.clone())
    W.requires_grad_(True)
    y = pipeline_apply(body, W, x, pipe)
    torch.square(y).sum().backward()
    res["y_" + mode] = y.detach().numpy()
    res["g_" + mode] = (W.grad.full_tensor() if isinstance(W.grad, DTensor)
                        else W.grad).numpy()
W = torch.from_numpy(inp["pp_w"]).requires_grad_(True)
loss = make_pp_loss(body, N_MICRO)(W, x, torch.from_numpy(inp["pp_t"]), pipe)
loss.backward()
res["loss"], res["loss_g"] = loss.detach().numpy(), W.grad.numpy()
save("pp", **res)

batch = place_on_mesh({"tokens": inp["tokens"], "embeds": inp["embeds"]}, mesh, ("data",))
for k, v in batch.items():
    assert v.placements == (Shard(0), torch.distributed.tensor.Replicate()), v.placements
    r = mesh.get_local_rank("data")
    n = len(inp[k]) // 2
    assert np.array_equal(v.to_local().numpy(), inp[k][r * n:(r + 1) * n]), k
print("RANK OK")
"""

JAX_PSUM = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.launch.mesh import make_test_mesh
from repro.optim.compression import compressed_psum

inp = dict(np.load(sys.argv[1]))
out = {}
mesh4 = make_test_mesh((4,), ("dp",))
mesh22 = make_test_mesh((2, 2), ("pod", "data"))
for k in %r:
    x = jnp.asarray(inp[k])
    out["one_" + k] = shard_map(lambda g: compressed_psum(g[0], "dp"), mesh=mesh4,
                                in_specs=P("dp", None), out_specs=P())(x)
    out["two_" + k] = shard_map(lambda g: compressed_psum(g[0], ("pod", "data")),
                                mesh=mesh22, in_specs=P(("pod", "data"), None),
                                out_specs=P())(x)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _inputs():
    rng = np.random.default_rng(7)
    inp = {}
    for k, shape in PSUM_SHAPES.items():
        x = rng.standard_normal(shape).astype(np.float32)
        x[:, :7] = 0.0        # an all-zero start of a block, zero scales
        x[1, 300 % shape[1]] = 40.0  # one large element per block max
        inp[k] = x
    for k, (shape, _) in EF_LEAVES.items():
        inp["g_" + k] = rng.standard_normal(shape).astype(np.float32)
        inp["e_" + k] = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    inp["pp_w"] = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    inp["pp_x"] = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    inp["pp_t"] = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    inp["tokens"] = rng.integers(0, 256, (8, 12)).astype(np.int32)
    inp["embeds"] = rng.standard_normal((8, 12, 6)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 4-rank run of everything, and JAX's compressed psum beside it."""
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    consts = (f"PSUM_SHAPES = {PSUM_SHAPES!r}\nEF_LEAVES = {EF_LEAVES!r}\n"
              f"N_MICRO = {N_MICRO}\n")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_PSUM % (list(PSUM_SHAPES),), str(d / "inputs.npz"),
         str(d / "jax_psum.npz")],
        env=dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        outs = run_ranks(4, consts + RANK_SCRIPT, d, timeout=150)
        jax_out, _ = jax_run.communicate(timeout=150)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, jax_out
    assert all("RANK OK" in o for o in outs)
    load = lambda name: dict(np.load(d / f"{name}.npz"))
    return inp, load("psum"), load("jax_psum"), load("ef"), load("pp")


@pytest.mark.parametrize("axis", ["one", "two"])
@pytest.mark.parametrize("shape", list(PSUM_SHAPES))
def test_compressed_psum_bit_equal_to_jax(runs, axis, shape):
    inp, psum, jax_psum, _, _ = runs
    got, want = psum[f"{axis}_{shape}"], jax_psum[f"{axis}_{shape}"]
    assert got.shape == want.shape == inp[shape].shape[1:]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # and it is the sum within the int8 quantization (JAX's test's bound)
    ref = inp[shape].sum(0)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.02


@pytest.mark.parametrize("leaf", list(EF_LEAVES))
def test_ef_roundtrip_of_sharded_leaves_equals_jax(runs, leaf):
    inp, _, _, ef, _ = runs
    rec, err = jef_roundtrip({"x": inp["g_" + leaf]}, {"x": inp["e_" + leaf]})
    assert np.array_equal(ef["rec_" + leaf], np.asarray(rec["x"]))
    assert np.array_equal(ef["err_" + leaf], np.asarray(err["x"]))


def _sequential(w, x):
    w = torch.from_numpy(w).requires_grad_(True)
    y = torch.from_numpy(x)
    for layer in range(L):
        y = torch.tanh(y @ w[layer])
    return y, w


@pytest.mark.parametrize("mode", ["sharded", "whole"])
def test_pipeline_forward_and_grad(runs, mode):
    inp, _, _, _, pp = runs
    ref, w = _sequential(inp["pp_w"], inp["pp_x"])
    torch.square(ref).sum().backward()
    np.testing.assert_allclose(pp["y_" + mode], ref.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(pp["g_" + mode], w.grad.numpy(), atol=1e-4)


def test_pp_loss(runs):
    inp, _, _, _, pp = runs
    ref, w = _sequential(inp["pp_w"], inp["pp_x"])
    loss = torch.mean(torch.square(ref - torch.from_numpy(inp["pp_t"])))
    loss.backward()
    np.testing.assert_allclose(pp["loss"], loss.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(pp["loss_g"], w.grad.numpy(), atol=1e-4)
