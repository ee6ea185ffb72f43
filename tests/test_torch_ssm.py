"""The port's Mamba2 block (`repro_torch/models/ssm.py`) against the JAX
package's, at fp32 within 2e-5 (absolute and relative), on JAX's
`init_mamba2` parameters and seeded numpy inputs:

- `apply_mamba2` at chunks 8 and 24 and at an S that is not a multiple
  of the chunk (the padded steps leave the final state exact), with
  `return_state`, also for prompts shorter than d_conv - 1 (the conv
  tail padded on the left);
- `apply_mamba2_decode` from a seeded state, in fp32 and in bf16 (its
  conv runs in the compute dtype where prefill's runs in float32; bf16
  within 2^-6 of each output's largest element);
- twins of tests/test_models.py's `test_mamba2_chunk_invariance_and_decode`
  and `test_mamba2_prefill_state_continuation`, run on the port and
  held against the same calls in JAX;
- gradients of a seeded projection of the output against `jax.grad`,
  every leaf and the input within 2e-5 of its largest element;
- `init_mamba2`'s deterministic leaves equal JAX's (`D`, `dt_bias`,
  `norm`, `conv_b` exactly; `A_log` to the float32 ulp: XLA's float32
  `log` on the CPU is not correctly rounded, at 8 heads one of the 8
  values is one ulp from torch's), the random leaves' shapes too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm
from test_torch_train_model import one_thread  # noqa: F401  (autouse fixture)

TOL = 2e-5
D_MODEL, D_INNER, D_STATE, HD = 32, 64, 16, 16
KW = dict(d_inner=D_INNER, d_state=D_STATE, head_dim=HD)
B = 2
_STATIC = ("d_inner", "d_state", "head_dim", "chunk", "return_state")
# jitted: one compile per shape, where op-by-op dispatch compiles each op
japply = jax.jit(jssm.apply_mamba2, static_argnames=_STATIC)
jdecode = jax.jit(jssm.apply_mamba2_decode, static_argnames=_STATIC[:3])


def _params(seed=0):
    p = jssm.init_mamba2(jax.random.PRNGKey(seed), D_MODEL, D_INNER, D_STATE, HD)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(seed, S):
    return np.random.default_rng(seed).standard_normal((B, S, D_MODEL)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("S, chunk", [(24, 8), (24, 24), (21, 8), (13, 24)])
def test_apply_mamba2_matches_jax(S, chunk):
    jp, p = _params()
    x = _x(1, S)
    jout, jst = japply(jp, jnp.asarray(x), chunk=chunk, return_state=True, **KW)
    out, st = ssm.apply_mamba2(p, torch.from_numpy(x), chunk=chunk, return_state=True, **KW)
    _close(out, jout)
    for k in ("ssm", "conv"):
        assert tuple(st[k].shape) == jst[k].shape and st[k].dtype == torch.float32
        _close(st[k], jst[k])
    _close(ssm.apply_mamba2(p, torch.from_numpy(x), chunk=chunk, **KW), jout)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_return_state_short_prompt(S):
    """Prompts of 1 and 2 tokens pad the conv tail on the left (d_conv 4)."""
    jp, p = _params()
    x = _x(2, S)
    jout, jst = japply(jp, jnp.asarray(x), return_state=True, **KW)
    out, st = ssm.apply_mamba2(p, torch.from_numpy(x), return_state=True, **KW)
    _close(out, jout)
    assert tuple(st["conv"].shape) == (B, 3, D_INNER + 2 * D_STATE)
    for k in ("ssm", "conv"):
        _close(st[k], jst[k])
    assert not st["conv"][:, : 3 - S].any()


def _state(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    H = D_INNER // HD
    return {"ssm": rng.standard_normal((B, H, D_STATE, HD)).astype(np.float32),
            "conv": rng.standard_normal((B, 3, D_INNER + 2 * D_STATE)).astype(dtype)}


def test_apply_mamba2_decode_matches_jax():
    jp, p = _params()
    x = _x(3, 1)
    st = _state(4)
    jout, jnew = jdecode(jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()},
                         **KW)
    slots = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    out, new = ssm.apply_mamba2_decode(p, torch.from_numpy(x), slots, **KW)
    _close(out, jout)
    for k in ("ssm", "conv"):
        _close(new[k], jnew[k])
        # fresh tensors: the caller copies them over its slots
        assert new[k].data_ptr() != slots[k].data_ptr()
    np.testing.assert_array_equal(slots["ssm"].numpy(), st["ssm"])


def test_bf16_decode_and_prefill_precision():
    """In bf16 the port rounds where JAX does: prefill's conv by type
    promotion in float32, decode's in bf16."""
    jp, p = _params()
    bf = {k: (v.to(torch.bfloat16) if k in ("w_in", "w_out") else v) for k, v in p.items()}
    x = _x(5, 9)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jout, jst = japply(jp, jx, chunk=4, return_state=True, **KW)
    out, st = ssm.apply_mamba2(bf, tx, chunk=4, return_state=True, **KW)
    assert out.dtype == torch.bfloat16 and st["conv"].dtype == torch.bfloat16
    assert st["ssm"].dtype == torch.float32
    for got, want in ((out, jout), (st["ssm"], jst["ssm"]), (st["conv"], jst["conv"])):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -6 * np.abs(want).max()
    jdec, jnew = jdecode(jp, jx[:, :1], jst, **KW)
    dec, new = ssm.apply_mamba2_decode(bf, tx[:, :1], st, **KW)
    assert dec.dtype == torch.bfloat16 and new["conv"].dtype == torch.bfloat16
    for got, want in ((dec, jdec), (new["ssm"], jnew["ssm"])):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -6 * np.abs(want).max()


def test_chunk_invariance_and_decode_twin():
    """Twin of tests/test_models.py::test_mamba2_chunk_invariance_and_decode
    on the port (within 1e-4, as there), each output against JAX's."""
    jp, p = _params()
    x = _x(6, 24)
    tx = torch.from_numpy(x)
    y8 = ssm.apply_mamba2(p, tx, chunk=8, **KW)
    y24 = ssm.apply_mamba2(p, tx, chunk=24, **KW)
    np.testing.assert_allclose(y8.numpy(), y24.numpy(), atol=1e-4)
    st = ssm.init_mamba2_state(B, D_INNER, D_STATE, HD, dtype=torch.float32, device="cpu")
    jst = jssm.init_mamba2_state(B, D_INNER, D_STATE, HD, dtype=jnp.float32)
    ys, jys = [], []
    for t in range(24):
        yt, st = ssm.apply_mamba2_decode(p, tx[:, t : t + 1], st, **KW)
        jyt, jst = jdecode(jp, jnp.asarray(x[:, t : t + 1]), jst, **KW)
        ys.append(yt)
        jys.append(jyt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y8.numpy(), atol=1e-4)
    _close(torch.cat(ys, 1), jnp.concatenate(jys, 1))
    _close(y8, japply(jp, jnp.asarray(x), chunk=8, **KW))
    for k in ("ssm", "conv"):
        _close(st[k], jst[k])


def test_prefill_state_continuation_twin():
    """Twin of tests/test_models.py::test_mamba2_prefill_state_continuation."""
    jp, p = _params()
    x = _x(7, 20)
    tx = torch.from_numpy(x)
    y_full = ssm.apply_mamba2(p, tx, chunk=8, **KW)
    _, st = ssm.apply_mamba2(p, tx[:, :12], chunk=8, return_state=True, **KW)
    _, jst = japply(jp, jnp.asarray(x[:, :12]), chunk=8, return_state=True, **KW)
    ys = []
    for t in range(12, 20):
        yt, st = ssm.apply_mamba2_decode(p, tx[:, t : t + 1], st, **KW)
        jyt, jst = jdecode(jp, jnp.asarray(x[:, t : t + 1]), jst, **KW)
        ys.append(yt)
        _close(yt, jyt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full[:, 12:].numpy(), atol=1e-4)


@pytest.mark.parametrize("S, chunk", [(16, 8), (11, 4)])
def test_grads_match_jax(S, chunk):
    jp, p = _params()
    x = _x(8, S)
    cot = np.random.default_rng(9).standard_normal((B, S, D_MODEL)).astype(np.float32)

    def jloss(jp, jx):
        return jnp.sum(japply(jp, jx, chunk=chunk, **KW) * cot)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    for v in p.values():
        v.requires_grad_(True)
    (ssm.apply_mamba2(p, tx, chunk=chunk, **KW) * torch.from_numpy(cot)).sum().backward()
    for k, v in p.items():
        want = np.asarray(jgp[k])
        assert np.isfinite(v.grad.numpy()).all(), k
        assert np.abs(v.grad.numpy() - want).max() <= TOL * np.abs(want).max(), k
    want = np.asarray(jgx)
    assert np.abs(tx.grad.numpy() - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("d_inner, head_dim", [(64, 16), (128, 16), (4096, 64)])
def test_init_deterministic_leaves(d_inner, head_dim):
    """At 4, 8 (zamba2 reduced) and 64 heads (zamba2 at full width)."""
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), 32, d_inner, 16, head_dim)
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), 32, d_inner, 16, head_dim,
                        device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    for k in ("D", "dt_bias", "norm", "conv_b"):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]), err_msg=k)
    np.testing.assert_array_max_ulp(p["A_log"].numpy(), np.asarray(jp["A_log"]), maxulp=1)
    assert all(v.dtype == torch.float32 for v in p.values())
