"""The port's RWKV6 block (`repro_torch/models/rwkv.py`) against the JAX
package's, at fp32 within 2e-5 (absolute and relative), on JAX's
`init_rwkv6` parameters and seeded numpy inputs:

- `apply_rwkv6` from the zero state and from a seeded state (output and
  the new tm_x, cm_x, wkv), and in bf16 (the projections in bf16, the
  decay LoRA and the state in float32; within 2^-6 of each output's
  largest element);
- `_group_norm` (population variance, eps 1e-5) and `_wkv_scan`;
- the twin of tests/test_models.py's `test_rwkv6_streaming_equivalence`
  (two chunks, then one token at a time), held against JAX's calls;
- gradients of a seeded projection of the output, from a seeded state,
  against `jax.grad`: every leaf, the input and the state within 2e-5 of
  its largest element;
- `init_rwkv6`'s deterministic leaves (the mixes, `w0`, `ln_scale`,
  `ln1`, `ln2`) equal JAX's, the random leaves' shapes too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro_torch.models import rwkv
from test_torch_train_model import one_thread  # noqa: F401  (autouse fixture)

TOL = 2e-5
D, HD, B = 32, 16, 2
H = D // HD
japply = jax.jit(jrwkv.apply_rwkv6, static_argnames=("head_dim",))


def _params(seed=0):
    p = jrwkv.init_rwkv6(jax.random.PRNGKey(seed), D, 4 * D, HD)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(seed, S):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"tm_x": rng.standard_normal((B, D)).astype(np.float32),
            "cm_x": rng.standard_normal((B, D)).astype(np.float32),
            "wkv": (0.3 * rng.standard_normal((B, H, HD, HD))).astype(np.float32)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_apply_rwkv6_matches_jax(S, with_state):
    jp, p = _params()
    x = _x(1, S)
    st = _state(2) if with_state else None
    jout, jnew = japply(jp, jnp.asarray(x), head_dim=HD,
                        state=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    slots = None if st is None else {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    out, new = rwkv.apply_rwkv6(p, torch.from_numpy(x), head_dim=HD, state=slots)
    _close(out, jout)
    for k in ("tm_x", "cm_x", "wkv"):
        assert new[k].dtype == torch.float32 and tuple(new[k].shape) == jnew[k].shape
        _close(new[k], jnew[k])
    if st is not None:   # the caller's slots are read, not written
        for k, v in st.items():
            np.testing.assert_array_equal(slots[k].numpy(), v)


def test_bf16_block_matches_jax():
    jp, p = _params()
    names = ("w_r", "w_k", "w_v", "w_g", "w_o", "cm_k", "cm_v", "cm_r")
    bf = {k: (v.to(torch.bfloat16) if k in names else v) for k, v in p.items()}
    x = _x(3, 7)
    st = _state(4)
    jout, jnew = japply(jp, jnp.asarray(x).astype(jnp.bfloat16), head_dim=HD,
                        state={k: jnp.asarray(v) for k, v in st.items()})
    out, new = rwkv.apply_rwkv6(bf, torch.from_numpy(x).to(torch.bfloat16), head_dim=HD,
                                state={k: torch.from_numpy(v) for k, v in st.items()})
    assert out.dtype == torch.bfloat16
    for got, want in ((out, jout), (new["tm_x"], jnew["tm_x"]), (new["cm_x"], jnew["cm_x"]),
                      (new["wkv"], jnew["wkv"])):
        want = np.asarray(want, np.float32)
        assert got.dtype in (torch.bfloat16, torch.float32)
        assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -6 * np.abs(want).max()
    assert all(new[k].dtype == torch.float32 for k in new)


def test_group_norm_and_wkv_scan_match_jax():
    rng = np.random.default_rng(5)
    y = (3 * rng.standard_normal((B, 6, D)) + 1).astype(np.float32)
    scale = rng.standard_normal(D).astype(np.float32)
    _close(rwkv._group_norm(torch.from_numpy(y), torch.from_numpy(scale), H),
           jrwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), H))
    r, k, v = (rng.standard_normal((B, 6, D)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (B, 6, D)).astype(np.float32)
    u = rng.standard_normal(D).astype(np.float32)
    s0 = rng.standard_normal((B, H, HD, HD)).astype(np.float32)
    jy, js = jrwkv._wkv_scan(*map(jnp.asarray, (r, k, v, w, u)), HD, jnp.asarray(s0))
    ty, ts = rwkv._wkv_scan(*map(torch.from_numpy, (r, k, v, w, u)), HD, torch.from_numpy(s0))
    _close(ty, jy)
    _close(ts, js)


def test_streaming_equivalence_twin():
    """Twin of tests/test_models.py::test_rwkv6_streaming_equivalence on
    the port (within 1e-4, as there), each output against JAX's."""
    jp, p = _params()
    x = _x(6, 24)
    tx = torch.from_numpy(x)
    y1, _ = rwkv.apply_rwkv6(p, tx, head_dim=HD)
    _close(y1, japply(jp, jnp.asarray(x), head_dim=HD)[0])
    ha, sta = rwkv.apply_rwkv6(p, tx[:, :12], head_dim=HD)
    hb, _ = rwkv.apply_rwkv6(p, tx[:, 12:], head_dim=HD, state=sta)
    np.testing.assert_allclose(torch.cat([ha, hb], 1).numpy(), y1.numpy(), atol=1e-4)
    st = rwkv.init_rwkv6_state(B, D, HD, device="cpu")
    jst = jrwkv.init_rwkv6_state(B, D, HD)
    ys = []
    for t in range(24):
        yt, st = rwkv.apply_rwkv6(p, tx[:, t : t + 1], head_dim=HD, state=st)
        jyt, jst = japply(jp, jnp.asarray(x[:, t : t + 1]), head_dim=HD, state=jst)
        ys.append(yt)
        _close(yt, jyt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y1.numpy(), atol=1e-4)
    for k in ("tm_x", "cm_x", "wkv"):
        _close(st[k], jst[k])


def test_grads_match_jax():
    jp, p = _params()
    x = _x(7, 8)
    st = _state(8)
    cot = np.random.default_rng(9).standard_normal((B, 8, D)).astype(np.float32)

    def jloss(jp, jx, jst):
        out, new = jrwkv.apply_rwkv6(jp, jx, head_dim=HD, state=jst)
        return jnp.sum(out * cot) + jnp.sum(new["wkv"]) + jnp.sum(new["cm_x"])

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tst = {k: torch.from_numpy(v).requires_grad_(True) for k, v in st.items()}
    for v in p.values():
        v.requires_grad_(True)
    out, new = rwkv.apply_rwkv6(p, tx, head_dim=HD, state=tst)
    ((out * torch.from_numpy(cot)).sum() + new["wkv"].sum() + new["cm_x"].sum()).backward()
    got = [(k, v.grad) for k, v in p.items()] + [("x", tx.grad)] + [
        (f"state/{k}", v.grad) for k, v in tst.items()]
    want = dict(jg[0], x=jg[1], **{f"state/{k}": v for k, v in jg[2].items()})
    for k, g in got:
        w = np.asarray(want[k])
        assert g is not None and np.isfinite(g.numpy()).all(), k
        assert np.abs(g.numpy() - w).max() <= TOL * max(np.abs(w).max(), 1e-30), k


def test_init_deterministic_leaves():
    jp = jrwkv.init_rwkv6(jax.random.PRNGKey(0), D, 4 * D, HD)
    p = rwkv.init_rwkv6(torch.Generator().manual_seed(0), D, 4 * D, HD, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    for k in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "ln_scale", "cm_mu_k",
              "cm_mu_r", "ln1", "ln2"):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]), err_msg=k)
    assert all(v.dtype == torch.float32 for v in p.values())
