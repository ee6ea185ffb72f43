"""The port's flash attention against the JAX package.

The same inputs, made with numpy from a seed, go through JAX's Pallas
kernel in interpret mode (`repro.kernels.flash_attention.
flash_attention_fwd(interpret=True)`) and the port's
`flash_attention_fwd` on CPU tensors (its plain version,
`mha_reference`), over the sweep of tests/test_kernels.py's
TestFlashAttention: shapes x dtypes, variants and block sizes, with its
tolerances (fp32 2e-5, bf16 2e-2).  The gradients of the port's
`ops.flash_attention` (a torch.autograd.Function) are held against
`jax.grad` of JAX's `ops.flash_attention(impl="interpret")` within 1e-5,
as there.  The CUDA kernel is held against the plain version by
tests/test_torch_kernels_on_card.py and `chip_smoke.py`.

The numerics of the kernel's bf16 body (tensor cores, P as a hi/lo pair
of bf16 values) are modelled here in plain PyTorch at stablelm-3b's
head width and held to one rounding of the reference and to the Pallas
kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jflash
from repro.kernels.ops import flash_attention as jflash_op
from repro.kernels.ref import mha_reference as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import mha_reference as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, Hq, Hkv, S, D, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32))


def _both(arrs, dtype="float32"):
    return ([jnp.asarray(a, JD[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TD[dtype]) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _against_pallas(arrs, dtype, bq, bk, **variant):
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    before = tfa.launches
    got = tfa.flash_attention_fwd(q, k, v, block_q=bq, block_k=bk, **variant)
    assert tfa.launches == before  # CPU tensors take the plain version
    assert got.dtype == TD[dtype] and got.shape == q.shape
    want = jflash(jq, jk, jv, block_q=bq, block_k=bk, interpret=True, **variant)
    _close(got, want, TOL[dtype])
    return got


@pytest.mark.parametrize("S,D,Hq,Hkv", [
    (128, 32, 4, 4),    # MHA
    (256, 64, 8, 2),    # GQA
    (192, 16, 2, 1),    # MQA, non-128 seq
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shapes_dtypes(S, D, Hq, Hkv, dtype):
    _against_pallas(_inputs(S + D, 2, Hq, Hkv, S, D), dtype, 64, 64)


@pytest.mark.parametrize("variant", [
    dict(causal=False),
    dict(causal=True, window=64),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=96, softcap=50.0),
], ids=["noncausal", "window64", "softcap30", "window96-softcap50"])
def test_variants(variant):
    _against_pallas(_inputs(4, 1, 4, 2, 256, 32), "float32", 64, 64, **variant)


@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 128), (128, 64)])
def test_block_size_sweep(bq, bk):
    _against_pallas(_inputs(7, 1, 2, 2, 256, 32), "float32", bq, bk)


@pytest.mark.parametrize("variant", [
    dict(causal=True), dict(causal=False, softcap=30.0),
    dict(causal=True, window=40, softcap=50.0, scale=0.3),
], ids=["causal", "noncausal-softcap", "window-softcap-scale"])
def test_mha_reference_matches_jax(variant):
    arrs = _inputs(11, 2, 4, 2, 96, 24, Sk=160)
    (jq, jk, jv), (q, k, v) = _both(arrs)
    _close(tref(q, k, v, **variant), jref(jq, jk, jv, **variant), 2e-5)


def test_degenerate_window_gives_zeros():
    """window=0 with the causal mask leaves no live column in any row:
    both sides give zeros (not the uniform weights of a plain softmax)."""
    got = _against_pallas(_inputs(5, 1, 2, 1, 128, 16), "float32", 64, 64,
                          causal=True, window=0)
    assert not got.any()


@pytest.mark.parametrize("S,Sk,variant", [
    (128, 256, dict(causal=True)),
    (256, 128, dict(causal=True, window=48)),
    (64, 192, dict(causal=False, softcap=20.0)),
])
def test_kv_length_differs(S, Sk, variant):
    """Rows and columns both count from 0 when Sk != S."""
    _against_pallas(_inputs(S + Sk, 1, 4, 2, S, 32, Sk=Sk), "float32", 64, 64,
                    **variant)


@pytest.mark.parametrize("Hq,Hkv,S,Sk,bq,bk", [
    (6, 4, 64, 64, 64, 64),      # Hq not a multiple of Hkv
    (2, 1, 96, 64, 64, 64),      # S not a multiple of block_q
    (2, 1, 64, 96, 64, 64),      # Sk not a multiple of block_k
])
def test_refuses_what_jax_refuses(Hq, Hkv, S, Sk, bq, bk):
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, 1, Hq, Hkv, S, 16, Sk=Sk))
    with pytest.raises(AssertionError):
        jflash(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, v, block_q=bq, block_k=bk)


@pytest.mark.parametrize("variant", [
    dict(causal=True), dict(causal=True, window=48, softcap=30.0),
], ids=["causal", "window-softcap"])
def test_gradients_match_jax(variant):
    arrs = _inputs(10, 1, 4, 2, 128, 32)
    (jq, jk, jv), (q, k, v) = _both(arrs)
    want = jax.grad(
        lambda q, k, v: jflash_op(q, k, v, impl="interpret", **variant).sum(),
        argnums=(0, 1, 2),
    )(jq, jk, jv)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = tops.flash_attention(*leaves, **variant)
    got = torch.autograd.grad(out.sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _tensor_core_model(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
                       bk=64, split=True):
    """The rounding of the CUDA kernel's bf16 body, in plain PyTorch:
    bf16 Q and K with fp32 sums of their exact products, an fp32 online
    softmax in base 2 over kv tiles of `bk` columns, P split into hi =
    bf16(P) and lo = bf16(P - hi) with both products summed in fp32,
    and one rounding of the output.  The kernel skips tiles in which
    every element is masked; here they change nothing (alpha 1, p 0).
    `split=False` drops lo: P rounded once to bf16."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(D) if scale is None else scale
    kr = k.repeat_interleave(Hq // Hkv, dim=1).float()
    vr = v.repeat_interleave(Hq // Hkv, dim=1).float()
    qf = q.float()
    m = torch.full((B, Hq, S), NEG_INF)
    l = torch.zeros((B, Hq, S))
    acc = torch.zeros((B, Hq, S, D))
    rows = torch.arange(S)[:, None]
    for c0 in range(0, Sk, bk):
        cols = torch.arange(c0, min(c0 + bk, Sk))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kr[:, :, c0:c0 + bk])
        if softcap is not None:
            y = softcap * LOG2E * torch.tanh(s * scale / softcap)
        else:
            y = s * (scale * LOG2E)
        mask = torch.ones((S, cols.shape[1]), dtype=torch.bool)
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= cols > rows - window
        y = torch.where(mask, y, NEG_INF)
        m_cur = torch.maximum(m, y.amax(dim=-1))
        dead = m_cur == NEG_INF
        alpha = torch.where(dead, 1.0, torch.exp2(m - m_cur))
        p = torch.where(dead[..., None], 0.0, torch.exp2(y - m_cur[..., None]))
        l = l * alpha + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float() if split else torch.zeros_like(p)
        vt = vr[:, :, c0:c0 + bk]
        acc = acc * alpha[..., None] + hi @ vt + lo @ vt
        m = m_cur
    norm = torch.where(l == 0, 1.0, l)
    return (acc / norm[..., None]).to(q.dtype)


@pytest.mark.parametrize("against", ["mha_reference", "pallas"])
@pytest.mark.parametrize("variant", [
    dict(causal=True), dict(causal=True, window=300, softcap=50.0),
], ids=["causal", "window300-softcap50"])
def test_tensor_core_rounding_model(variant, against):
    """At stablelm-3b's head width (D=80) and S=1024: the model of the
    bf16 body is within one rounding of the output of `mha_reference`
    in bf16 (|err| <= 2^-7 |want| + 1e-4, the card's check), and within
    the bf16 tolerance of the Pallas kernel in interpret mode."""
    arrs = _inputs(80, 1, 2, 2, 1024, 80)
    (jq, jk, jv), (q, k, v) = _both(arrs, "bfloat16")
    got = _tensor_core_model(q, k, v, **variant)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    if against == "mha_reference":
        want = tref(q, k, v, **variant).float()
        err = (got.float() - want).abs()
        assert bool((err <= want.abs() * 2.0 ** -7 + 1e-4).all()), float(err.max())
    else:
        want = jflash(jq, jk, jv, block_q=128, block_k=128, interpret=True, **variant)
        _close(got, want, TOL["bfloat16"])


def _worst_slack(S, split, seed=80, H=2, D=80):
    """max |model - mha_reference| / (2^-7 |want| + 1e-4), causal, bf16."""
    (_, _, _), (q, k, v) = _both(_inputs(seed, 1, H, H, S, D), "bfloat16")
    want = tref(q, k, v, causal=True).float()
    got = _tensor_core_model(q, k, v, causal=True, split=split).float()
    return float(((got - want).abs() / (want.abs() * 2.0 ** -7 + 1e-4)).max())


def test_one_bf16_rounding_of_p_breaks_the_bound():
    """Why P goes to the tensor cores as a hi/lo pair: rounded once to
    bf16, P puts outputs several bf16 ulps from the reference at D=80,
    S=1024, beyond the card's one-rounding check."""
    assert _worst_slack(1024, split=True) <= 1.0
    assert _worst_slack(1024, split=False) > 1.0


if __name__ == "__main__":
    # the worst element of the rounding model over its one-rounding limit
    for S in (1024, 4096):
        print(f"S={S}: P as hi/lo {_worst_slack(S, True):.3f}, "
              f"P rounded once {_worst_slack(S, False):.3f}")
