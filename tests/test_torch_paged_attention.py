"""The port's paged decode attention against the JAX package.

The plain version (what the wrapper runs on CPU tensors) is held against
`repro.kernels.ref.paged_attention_reference` on live rows and against
the Pallas kernel in interpret mode on every row, empty rows included.
Tolerances as in tests/test_kernels.py: fp32 2e-5, bf16 3e-2.  The CUDA
kernel is held against the plain version by
tests/test_torch_kernels_on_card.py and `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as paged_pallas
from repro.kernels.ref import paged_attention_reference as jref
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels.ops import paged_attention as tops_paged
from repro_torch.kernels.ref import paged_attention_reference as tref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, B, P, page, maxp, Hq, Hkv, D, empty_rows=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = np.full((B, maxp), -1, np.int32)
    cl = np.zeros((B,), np.int32)
    for b in range(B):
        if empty_rows and b % 4 == 3:
            if b % 8 == 7:  # pages mapped but zero context
                bt[b, :2] = rng.choice(P, size=2, replace=False)
            continue
        n = int(rng.integers(1, maxp + 1))
        bt[b, :n] = rng.choice(P, size=n, replace=False)
        if b % 5 == 2 and n > 1:
            bt[b, 0] = -1  # a hole inside the table
        cl[b] = int(rng.integers(1, n * page + 1))
    return q, kp, vp, bt, cl


def _both(arrs, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    j = [jnp.asarray(a, jd) for a in arrs[:3]] + [jnp.asarray(a) for a in arrs[3:]]
    t = [torch.from_numpy(a).to(td) for a in arrs[:3]] + [
        torch.from_numpy(a) for a in arrs[3:]
    ]
    return j, t


def _live_rows(bt, cl, page):
    pos = np.arange(bt.shape[1] * page)[None, :]
    live = np.repeat(bt >= 0, page, axis=1) & (pos < cl[:, None])
    return live.any(axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("page,D,Hq,Hkv", [
    (4, 16, 4, 4), (8, 80, 4, 2), (16, 128, 2, 1), (4, 80, 2, 2),
])
def test_plain_matches_jax(page, D, Hq, Hkv, softcap, dtype):
    B, P, maxp = 8, 32, 4
    arrs = _inputs(page + D + Hq, B, P, page, maxp, Hq, Hkv, D)
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(arrs, dtype)
    out = tpa.paged_attention_plain(tq, tk, tv, tbt, tcl, softcap=softcap)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    got = out.float().numpy()
    tol = TOL[dtype]
    live = _live_rows(arrs[3], arrs[4], page)
    ref = np.asarray(jref(jq, jk, jv, jbt, jcl, softcap=softcap), np.float32)
    np.testing.assert_allclose(got[live], ref[live], atol=tol, rtol=tol)
    pal = np.asarray(
        paged_pallas(jq, jk, jv, jbt, jcl, softcap=softcap, interpret=True),
        np.float32,
    )
    np.testing.assert_allclose(got, pal, atol=tol, rtol=tol)
    assert (got[~live] == 0).all() and (~live).any()


def test_reference_matches_jax_reference():
    """The port's reference keeps the JAX reference's uniform-weight
    behaviour on empty rows (only the kernel and its plain version give
    zeros there)."""
    arrs = _inputs(3, 8, 16, 4, 4, 4, 2, 16)
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(arrs, "float32")
    np.testing.assert_allclose(
        tref(tq, tk, tv, tbt, tcl).numpy(), np.asarray(jref(jq, jk, jv, jbt, jcl)),
        atol=2e-5, rtol=2e-5,
    )


def test_ops_dispatches_cpu_to_plain():
    arrs = _inputs(4, 4, 16, 8, 3, 4, 2, 32)
    _, (tq, tk, tv, tbt, tcl) = _both(arrs, "float32")
    before = tpa.launches
    out = tops_paged(tq, tk, tv, tbt, tcl)
    assert tpa.launches == before  # a CPU tensor never launches the kernel
    assert torch.equal(out, tpa.paged_attention_plain(tq, tk, tv, tbt, tcl))
