"""The port's einsum MoE dispatch on four gloo ranks against the JAX
package's unsharded `_apply_moe_einsum`.

The layer of reduced phi3.5-moe (d 64, ff 128, 4 experts, top 2,
capacity factor 1.25, so tokens drop), fp32, runs with `axes` on a
(2, 1, 2) ("pod", "data", "model") mesh whose dp group is ('pod',
'data'), its parameters placed by `param_specs` and its input on the dp
group.  Cases: one group (`group_size` >= T: fewer groups than dp
shards, where DTensor's sharding propagation of the combine einsum did
not end), groups that split over dp (G = dp shards, G = 2 x dp shards),
and G = 3, which the dp group does not divide.  The output, the aux
loss and the gradients of every parameter and of the input, of `sum(y
* w) + aux` with a fixed `w`, equal JAX's within 1e-5 of each tensor's
largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import moe as jmoe
from torch_dist import Ranks, load_tree, save_tree

D, FF, E, K, CF = 64, 128, 4, 2, 1.25
CASES = {  # name: (B, S, group_size)
    "one-group": (4, 8, 2048),
    "groups-on-dp": (4, 8, 16),
    "two-groups-per-shard": (4, 8, 8),
    "groups-not-dividing": (3, 8, 8),
}
TOL = 1e-5

RANK_SCRIPT = """
from torch_dist import load_tree, save_tree
from torch.distributed.tensor import distribute_tensor
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.models import moe
from repro_torch.models.sharding import MeshAxes, P, param_specs, placements, shard_tree

mesh = make_test_mesh((2, 1, 2), ("pod", "data", "model"))
axes = MeshAxes(dp=("pod", "data"))
params = {k: torch.from_numpy(v) for k, v in load_tree(os.path.join(OUT, "params.npz")).items()}
for key, (B, S, group) in CASES.items():
    inp = np.load(os.path.join(OUT, "x_" + key + ".npz"))
    sp = shard_tree({"moe": params}, param_specs(axes, {"moe": params}), mesh)["moe"]
    for t in sp.values():
        t.requires_grad_(True)
    x = distribute_tensor(torch.from_numpy(inp["x"]), mesh,
                          placements(P(("pod", "data"), None, None), mesh)).requires_grad_(True)
    with use_mesh(mesh):
        y, aux = moe.apply_moe(sp, x, top_k=K, capacity_factor=CF, dtype=torch.float32,
                               axes=axes, dispatch="einsum", group_size=group)
        w = distribute_tensor(torch.from_numpy(inp["w"]), mesh, y.placements)
        ((y * w).sum() + aux).backward()
    out = {"y": y.detach().full_tensor().numpy(), "aux": aux.detach().full_tensor().numpy(),
           "dx": x.grad.full_tensor().numpy()}
    out.update({"d_" + k: t.grad.full_tensor().numpy() for k, t in sp.items()})
    if RANK == 0:
        save_tree(os.path.join(OUT, "out_" + key + ".npz"), out)
print("RANK OK")
"""


def _jax_ref(jp, x, w, group):
    def loss(p, x):
        y, aux = jmoe._apply_moe_einsum(p, x, top_k=K, capacity_factor=CF, dtype=jnp.float32,
                                        axes=None, group_size=group)
        return (y * w).sum() + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                         has_aux=True))(jp, x)
    out = {"y": np.asarray(y), "aux": np.asarray(aux), "dx": np.asarray(gx)}
    out.update({"d_" + k: np.asarray(v) for k, v in gp.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_einsum")
    jp = jax.jit(jmoe.init_moe, static_argnums=(1, 2, 3))(jax.random.PRNGKey(0), D, FF, E)
    save_tree(d / "params.npz", jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    inputs = {}
    for key, (B, S, _) in CASES.items():
        inputs[key] = (rng.standard_normal((B, S, D)).astype(np.float32),
                       rng.standard_normal((B, S, D)).astype(np.float32))
        np.savez(d / f"x_{key}.npz", x=inputs[key][0], w=inputs[key][1])
    ranks = Ranks(4, f"CASES = {CASES!r}\nK, CF = {K}, {CF}\n" + RANK_SCRIPT, d)
    want = {key: _jax_ref(jp, jnp.asarray(x), jnp.asarray(w), CASES[key][2])
            for key, (x, w) in inputs.items()}
    outs = ranks.wait(timeout=150)
    assert all("RANK OK" in o for o in outs)
    return {key: (want[key], load_tree(d / f"out_{key}.npz")) for key in CASES}


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_einsum_dispatch_matches_jax(runs, key):
    want, got = runs[key]
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= TOL * scale, (name, float(np.abs(g - w).max()))

