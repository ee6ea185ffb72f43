"""The port's MoE layer (`repro_torch.models.moe`) against the JAX package.

The JAX `init_moe` parameters move to the port through numpy; the same
numpy-made activations go through both `apply_moe`s.  fp32 outputs and
aux losses agree within 1e-5 (the atol of tests/test_models.py's
dispatch test: the sums run in another order), bf16 outputs within
2e-2.  Covered: top_k 1 and 2; capacity factor 1.25 (tokens drop) and
n_experts (drop-free); `n_blocks` 1 and 4 and a token count that 4 does
not divide (the fallback to one block); the einsum dispatch at several
group sizes, one that leaves a group count dividing T only after the
`while T % G` loop; a zero router (every probability equal: both must
pick experts 0..k-1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

KEY = jax.random.PRNGKey(0)
D, FF, E = 16, 32, 4
ATOL = 1e-5
_japply = jax.jit(jmoe.apply_moe, static_argnames=(
    "top_k", "capacity_factor", "dtype", "n_blocks", "dispatch", "group_size"))
_JP = jax.tree.map(np.asarray, jax.jit(jmoe.init_moe, static_argnums=(1, 2, 3))(
    KEY, D, FF, E))


def _params(zero_router=False, dtype=torch.float32):
    jp = {k: jnp.asarray(v) for k, v in _JP.items()}
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = {k: torch.tensor(np.asarray(v)).to(torch.float32 if k == "router" else dtype)
          for k, v in jp.items()}
    return jp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(jp, tp, x, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    jy, jaux = _japply(jp, jnp.asarray(x).astype(jdtype), dtype=jdtype, **kw)
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x).to(tdtype), dtype=tdtype, **kw)
    return (np.asarray(jy.astype(jnp.float32)), float(jaux),
            ty.float().numpy(), float(taux))


def test_init_moe_shapes():
    jp, _ = _params()
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), D, FF, E, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [1.25, float(E)], ids=["drops", "drop-free"])
@pytest.mark.parametrize("n_blocks", [1, 4])
def test_scatter_matches_jax(top_k, cf, n_blocks):
    jp, tp = _params()
    jy, ja, ty, ta = _both(jp, tp, _x((2, 16, D)), top_k=top_k, capacity_factor=cf,
                           n_blocks=n_blocks)
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    np.testing.assert_allclose(ta, ja, atol=ATOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_scatter_blocks_that_do_not_divide(top_k):
    """T = 7 with n_blocks 4 falls back to one block, in both packages."""
    jp, tp = _params()
    x = _x((1, 7, D), 1)
    jy, ja, ty, ta = _both(jp, tp, x, top_k=top_k, capacity_factor=1.0, n_blocks=4)
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    np.testing.assert_allclose(ta, ja, atol=ATOL)
    _, _, one, _ = _both(jp, tp, x, top_k=top_k, capacity_factor=1.0, n_blocks=1)
    np.testing.assert_array_equal(ty, one)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("group_size", [64, 16, 5, 3])
def test_einsum_matches_jax(top_k, group_size):
    """T = 2 x 21 = 42: group size 64 gives one group, 16 gives G = 2,
    5 gives G = 8 -> 7 by the loop, 3 gives G = 14."""
    jp, tp = _params()
    jy, ja, ty, ta = _both(jp, tp, _x((2, 21, D), 2), top_k=top_k, capacity_factor=1.25,
                           dispatch="einsum", group_size=group_size)
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    np.testing.assert_allclose(ta, ja, atol=ATOL)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_zero_router_ties(dispatch, top_k):
    """A zero router makes every probability 1/E: JAX's top_k takes
    experts 0..k-1, and so must the port (gates 1/k each, capacity
    binding on those experts only)."""
    jp, tp = _params(zero_router=True)
    x = _x((2, 8, D), 3)
    jy, ja, ty, ta = _both(jp, tp, x, top_k=top_k, capacity_factor=1.25,
                           dispatch=dispatch, group_size=16)
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    np.testing.assert_allclose(ta, ja, atol=ATOL)
    gates, idx, _ = tmoe._route(tp["router"], torch.from_numpy(x).reshape(16, D), top_k)
    assert idx.tolist() == [list(range(top_k))] * 16
    assert torch.equal(gates, torch.full((16, top_k), 1.0 / top_k))


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_bf16_matches_jax_bf16(dispatch):
    jp, _ = _params()
    _, tp = _params(dtype=torch.bfloat16)
    jp16 = {k: (v if k == "router" else v.astype(jnp.bfloat16)) for k, v in jp.items()}
    jy, ja, ty, ta = _both(jp16, tp, _x((2, 16, D), 4), jdtype=jnp.bfloat16,
                           tdtype=torch.bfloat16, top_k=2, capacity_factor=1.25,
                           dispatch=dispatch, group_size=16)
    np.testing.assert_allclose(ty, jy, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(ta, ja, atol=2e-2, rtol=2e-2)


def test_dispatch_modes_equivalent():
    """Twin of tests/test_models.py::test_moe_dispatch_modes_equivalent
    on the port alone: einsum dispatch at group size T == scatter, and
    block-local scatter == group-local einsum at matching geometry."""
    p = {k: torch.tensor(v) for k, v in _JP.items()}   # init_moe(KEY, 16, 32, 4)
    x = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.fold_in(KEY, 5), (2, 32, 16), jnp.float32)))
    kw = dict(dtype=torch.float32)
    for k in (1, 2):
        y1, a1 = tmoe.apply_moe(p, x, top_k=k, capacity_factor=1.25, **kw)
        y2, a2 = tmoe.apply_moe(p, x, top_k=k, capacity_factor=1.25, dispatch="einsum",
                                group_size=64, **kw)
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
        np.testing.assert_allclose(float(a1), float(a2), atol=1e-5)
    y3, _ = tmoe.apply_moe(p, x, top_k=2, capacity_factor=2.0, n_blocks=4, **kw)
    y4, _ = tmoe.apply_moe(p, x, top_k=2, capacity_factor=2.0, dispatch="einsum",
                           group_size=16, **kw)
    np.testing.assert_allclose(y3.numpy(), y4.numpy(), atol=1e-5)


def test_drops_happen_and_overflow_slot_is_cut(monkeypatch):
    """At capacity factor 0.5 (2 slots per expert) some tokens drop:
    their outputs are zero in both packages, and the expert FFN sees
    the 2 slots only, the overflow slot cut off before it."""
    jp, tp = _params()
    x = _x((1, 16, D), 6)
    jy, _, ty, _ = _both(jp, tp, x, top_k=1, capacity_factor=0.5)
    dropped = np.all(jy == 0, axis=-1)
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(np.all(ty == 0, axis=-1), dropped)
    seen = []
    real = tmoe._swiglu_experts
    monkeypatch.setattr(tmoe, "_swiglu_experts",
                        lambda p, buf, dtype: seen.append(buf.shape) or real(p, buf, dtype))
    again, _ = tmoe.apply_moe(tp, torch.from_numpy(x), top_k=1, capacity_factor=0.5,
                              dtype=torch.float32)
    assert seen == [(E, 2, D)]
    np.testing.assert_array_equal(again.numpy(), ty)
