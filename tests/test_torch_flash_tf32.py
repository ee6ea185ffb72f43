"""A plain model of kernel 5's float32 body (3xTF32 on the tensor cores).

The CUDA body (`csrc/flash_attention.cu::flash_fwd_tf32_kernel`, D <=
128) sends each fp32 operand x to the tensor cores as hi = tf32(x) and
lo = tf32(x - hi), tf32() rounding to nearest with ties away from zero
(`cvt.rna.tf32.f32`), and sums lo_a hi_b, hi_a lo_b and hi_a hi_b into
one fp32 accumulator for every 8 columns of the contraction, in that
order: S = Q K^T over D, then an fp32 online softmax in base 2 over kv
tiles of 32 columns, then O += P V with P split after the softmax.
`tf32x3_model` does the same in plain PyTorch, the rounding emulated on
the int32 view of each value.  The tests hold it within the card's
limit, 2e-5 + 2e-5 |want|, of `mha_reference` at stablelm-3b's head
width (D=80) and a GQA width (D=128), within the fp32 tolerance of JAX's
Pallas kernel in interpret mode, and show that one TF32 product, with
no split, breaks that limit.  The tensor cores' own summation order
is not modelled; the card tests hold the kernel itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jflash
from repro_torch.kernels.ref import mha_reference

LOG2E = 1.4426950408889634
NEG_INF = -1e30
BK = 32      # kv columns a tile of the kernel
KSTEP = 8    # the contraction of one tf32 wgmma


def tf32(x):
    """`cvt.rna.tf32.f32`: round the fp32 word to 10 mantissa bits,
    halfway cases away from zero (add half of the 13 dropped bits to the
    magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _products(a, b, split_on):
    """sum_k a[..., k] b[..., k] over k8 steps into one fp32 sum, per
    step lo_a hi_b + hi_a lo_b + hi_a hi_b (one hi_a hi_b without the
    split).  a: [..., M, K], b: [..., N, K]."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for k0 in range(0, a.shape[-1], KSTEP):
        ks = slice(k0, k0 + KSTEP)
        if split_on:
            acc = acc + al[..., ks] @ bh[..., ks].transpose(-1, -2)
            acc = acc + ah[..., ks] @ bl[..., ks].transpose(-1, -2)
        acc = acc + ah[..., ks] @ bh[..., ks].transpose(-1, -2)
    return acc


def tf32x3_model(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
                 split_on=True):
    """Kernel 5's fp32 body in plain PyTorch (fp32 tensors [B, H, S, D]).
    `split_on=False` is one TF32 product per product: hi_a hi_b only."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(D) if scale is None else scale
    kr = k.repeat_interleave(Hq // Hkv, dim=1)
    vt = v.repeat_interleave(Hq // Hkv, dim=1).transpose(-1, -2)   # [B, H, D, Sk]
    m = torch.full((B, Hq, S), NEG_INF)
    l = torch.zeros((B, Hq, S))
    acc = torch.zeros((B, Hq, S, D))
    rows = torch.arange(S)[:, None]
    for c0 in range(0, Sk, BK):
        cols = torch.arange(c0, min(c0 + BK, Sk))[None, :]
        s = _products(q, kr[:, :, c0:c0 + BK], split_on)
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
        acc = acc * alpha[..., None] + _products(p, vt[..., c0:c0 + BK], split_on)
        m = m_cur
    norm = torch.where(l == 0, 1.0, l)
    return acc / norm[..., None]


def _inputs(seed, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


def _worst_slack(arrs, split_on, **variant):
    """max |model - mha_reference| / (2e-5 + 2e-5 |want|): <= 1 passes."""
    q, k, v = (torch.from_numpy(a) for a in arrs)
    want = mha_reference(q, k, v, **variant)
    got = tf32x3_model(q, k, v, split_on=split_on, **variant)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    return float(((got - want).abs() / (2e-5 + 2e-5 * want.abs())).max())


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11, 3.0e-30, -7.25], dtype=torch.float32)
    got = tf32(x)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         1.0 + 2 * 2.0 ** -10, float(tf32(torch.tensor([3.0e-30]))[0]),
                         -7.25])
    assert torch.equal(got, want)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())
    hi, lo = split(torch.tensor([np.pi], dtype=torch.float32))
    assert abs(float(hi[0]) + float(lo[0]) - float(np.float32(np.pi))) < 2.0 ** -21


_WIDTHS = [
    ("stablelm-3b", 2, 2, 80),   # D=80, MHA
    ("gqa-d128", 4, 1, 128),     # D=128, four q heads on one kv head
]
_VARIANTS = [dict(causal=True), dict(causal=True, window=300, softcap=50.0)]


@pytest.mark.parametrize("variant", _VARIANTS, ids=["causal", "window300-softcap50"])
@pytest.mark.parametrize("name,Hq,Hkv,D", _WIDTHS, ids=[w[0] for w in _WIDTHS])
def test_model_within_card_limit_of_reference(name, Hq, Hkv, D, variant):
    """S=1024: the model within 2e-5 + 2e-5 |want| of `mha_reference`."""
    slack = _worst_slack(_inputs(D + Hq, 1, Hq, Hkv, 1024, D), True, **variant)
    print(f"{name} {variant}: 3xTF32 at {slack:.3f} of the limit")
    assert slack <= 1.0


@pytest.mark.parametrize("name,Hq,Hkv,D", _WIDTHS, ids=[w[0] for w in _WIDTHS])
def test_one_tf32_product_breaks_the_limit(name, Hq, Hkv, D):
    """Why the operands are split: one TF32 product per product puts
    outputs beyond the card's limit; the split keeps them within it."""
    arrs = _inputs(D + Hq, 1, Hq, Hkv, 1024, D)
    split3 = _worst_slack(arrs, True, causal=True)
    single = _worst_slack(arrs, False, causal=True)
    print(f"{name}: worst element at {split3:.3f} of the limit with 3xTF32, "
          f"{single:.3f} with one TF32 product")
    assert split3 <= 1.0 < single


@pytest.mark.parametrize("variant", [
    dict(causal=True), dict(causal=False, softcap=30.0), dict(causal=True, window=40),
], ids=["causal", "noncausal-softcap30", "window40"])
def test_model_matches_pallas(variant):
    """S=256, D=80, GQA 2/1: the model against JAX's Pallas kernel in
    interpret mode, within the fp32 tolerance of tests/test_kernels.py."""
    arrs = _inputs(3, 1, 2, 1, 256, 80)
    got = tf32x3_model(*(torch.from_numpy(a) for a in arrs), **variant)
    want = jflash(*(jnp.asarray(a) for a in arrs), block_q=64, block_k=64,
                  interpret=True, **variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


if __name__ == "__main__":
    # the worst element of the model over the card's limit, both ways
    for name, Hq, Hkv, D in _WIDTHS:
        arrs = _inputs(D + Hq, 1, Hq, Hkv, 1024, D)
        print(f"{name}: 3xTF32 {_worst_slack(arrs, True, causal=True):.3f}, one TF32 "
              f"product {_worst_slack(arrs, False, causal=True):.3f} of 2e-5 + 2e-5 |want|")
