"""The port's paged decode attention against the JAX package.

The plain version (what the wrapper runs on CPU tensors) is held against
`repro.kernels.ref.paged_attention_reference` on live rows and against
the Pallas kernel in interpret mode on every row, empty rows included.
Tolerances as in tests/test_kernels.py: fp32 2e-5, bf16 3e-2.  The CUDA
kernel is held against the plain version by
tests/test_torch_kernels_on_card.py and `chip_smoke.py`.

The kernel cannot run here, so its order of work has a plain model,
`warp_split_model`: each row's live pages, compacted a window at a time,
cut into items of TC tokens and dealt to the CTA's warps, each warp's
masked fp32 (m, l, acc), and the merge.  The model is held against the
Pallas kernel in interpret mode (fp32 2e-5; bf16 within one rounding of
the output) on the edges of that order: warps with empty shares, pages
with zero context, rows with no page, holes, contexts ending mid-page.
"""

import math

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


# ---------------------------------------------------------------------------
# The CUDA kernel's order of work (csrc/paged_attention.cu), in numpy fp32
# ---------------------------------------------------------------------------

WARPS, TC, LIST = 4, 4, 1024   # the kernel's constants


def deal(bt, cl, page, P, warps=WARPS, tc=TC, window=LIST):
    """Per row: [(warp, window, page id, first token, tokens)] in the
    order the kernel's warps take them.  The row's table is read up to
    its last page with a position below the context, a window of
    `window` entries at a time; its live pages (0 <= id < P) are cut
    into items of `tc` tokens, and item i of a window goes to warp
    i % warps."""
    rows = []
    for b in range(bt.shape[0]):
        items, ctx = [], int(cl[b])
        if ctx > 0:
            nscan = min(bt.shape[1], (ctx - 1) // page + 1)
            tail = min(page, ctx - (nscan - 1) * page)
            subs = -(-page // tc)
            for ws in range(0, nscan, window):
                live = [(j, int(bt[b, j])) for j in range(ws, min(nscan, ws + window))
                        if 0 <= bt[b, j] < P]
                for i in range(len(live) * subs):
                    j, pid = live[i // subs]
                    t0 = (i % subs) * tc
                    nt = min(tc, (tail if j == nscan - 1 else page) - t0)
                    if nt > 0:
                        items.append((i % warps, ws, pid, t0, nt))
        rows.append(items)
    return rows


def warp_split_model(q, kp, vp, bt, cl, softcap=None, warps=WARPS, tc=TC, window=LIST):
    """fp32 output [B, Hq, D] of the kernel's order of work: each warp's
    online softmax over its items (masked tokens never enter), then the
    warps merged with the usual rescale; a warp with no item adds
    nothing, and a row with none gives zeros."""
    B, Hq, D = q.shape
    P, page, Hkv, _ = kp.shape
    hk = np.arange(Hq) // (Hq // Hkv)
    scale = np.float32(1.0 / math.sqrt(D))
    out = np.zeros((B, Hq, D), np.float32)
    for b, items in enumerate(deal(bt, cl, page, P, warps, tc, window)):
        m = np.full((warps, Hq), -1e30, np.float32)
        l = np.zeros((warps, Hq), np.float32)
        acc = np.zeros((warps, Hq, D), np.float32)
        for w, _, pid, t0, nt in items:
            k = kp[pid, t0:t0 + nt][:, hk]          # [nt, Hq, D]
            v = vp[pid, t0:t0 + nt][:, hk]
            s = np.einsum("hd,thd->ht", q[b], k) * scale
            if softcap is not None:
                s = np.float32(softcap) * np.tanh(s / np.float32(softcap))
            mx = np.maximum(m[w], s.max(axis=1))
            alpha = np.exp(m[w] - mx)
            p = np.exp(s - mx[:, None])
            l[w] = l[w] * alpha + p.sum(axis=1)
            acc[w] = acc[w] * alpha[:, None] + np.einsum("ht,thd->hd", p, v)
            m[w] = mx
        has = l > 0
        M = np.where(has, m, np.float32(-1e30)).max(axis=0)
        f = np.where(has, np.exp(np.where(has, m - M, 0)), 0).astype(np.float32)
        L = (l * f).sum(axis=0)
        O = (acc * f[:, :, None]).sum(axis=0)
        out[b] = np.where(L[:, None] > 0, O / np.where(L > 0, L, 1)[:, None], 0)
    return out


def _edge_inputs(seed, page, Hq, Hkv, D, P=24, maxp=6):
    """Rows on the edges of the kernel's order of work (see EDGE_ROWS)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(EDGE_ROWS), Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = np.full((len(EDGE_ROWS), maxp), -1, np.int32)
    cl = np.zeros(len(EDGE_ROWS), np.int32)
    for b, (name, (npages, ctx)) in enumerate(EDGE_ROWS.items()):
        bt[b, :npages] = rng.choice(P, size=npages, replace=False)
        cl[b] = ctx(page, maxp)
        if name == "hole mid-table":
            bt[b, 2] = -1
        if name == "ids past the pool":
            bt[b, 1] = P + 3
    return q, kp, vp, bt, cl


# name: (pages mapped, context length from (page, max_pages))
EDGE_ROWS = {
    "full table": (6, lambda pg, mp: mp * pg),
    "ends mid-page": (4, lambda pg, mp: 3 * pg + 1),
    "hole mid-table": (6, lambda pg, mp: 5 * pg + 2),
    "pages, zero context": (3, lambda pg, mp: 0),
    "no pages": (0, lambda pg, mp: 2 * pg),
    "one item": (1, lambda pg, mp: min(pg, TC)),
    "one token": (2, lambda pg, mp: 1),
    "context past the table": (6, lambda pg, mp: mp * pg + 5),
    "ids past the pool": (3, lambda pg, mp: 3 * pg),
}


def _pallas_arrays(arrs):
    """The Pallas kernel reads out of bounds at a page id >= P (the CUDA
    kernel skips it): give it -1 there, the same live positions."""
    q, kp, vp, bt, cl = arrs
    return q, kp, vp, np.where(bt < kp.shape[0], bt, -1).astype(np.int32), cl


def test_deal_reaches_every_edge():
    """The edge rows do reach the cases they are named for."""
    page = 4
    q, kp, vp, bt, cl = _edge_inputs(0, page, 2, 2, 16)
    rows = dict(zip(EDGE_ROWS, deal(bt, cl, page, kp.shape[0])))
    warps_of = {n: {it[0] for it in items} for n, items in rows.items()}
    assert warps_of["full table"] == set(range(WARPS))
    assert warps_of["one item"] == {0} and warps_of["one token"] == {0}
    assert rows["pages, zero context"] == [] and rows["no pages"] == []
    assert [it[4] for it in rows["ends mid-page"]] == [4, 4, 4, 1]
    assert len(rows["hole mid-table"]) == 5 and rows["hole mid-table"][-1][4] == 2
    assert len(rows["context past the table"]) == 6
    assert len(rows["ids past the pool"]) == 2
    # a window of 2 entries deals each window from warp 0 again
    small = deal(bt, cl, page, kp.shape[0], window=2)[0]
    assert [(it[0], it[1]) for it in small] == [(0, 0), (1, 0), (0, 2), (1, 2), (0, 4), (1, 4)]
    # pages of 8 tokens are two items each, on two warps
    q8, kp8, vp8, bt8, cl8 = _edge_inputs(0, 8, 2, 2, 16)
    one = dict(zip(EDGE_ROWS, deal(bt8, cl8, 8, kp8.shape[0])))["one item"]
    assert [(it[0], it[3], it[4]) for it in one] == [(0, 0, 4)]
    mid = dict(zip(EDGE_ROWS, deal(bt8, cl8, 8, kp8.shape[0])))["ends mid-page"]
    assert [(it[0], it[4]) for it in mid] == [(0, 4), (1, 4), (2, 4), (3, 4), (0, 4),
                                               (1, 4), (2, 1)]


@pytest.mark.parametrize("window", [LIST, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page,D,Hq,Hkv,softcap", [
    (4, 16, 4, 4, None), (8, 32, 4, 1, 20.0), (16, 16, 4, 2, None), (2, 80, 2, 2, 50.0),
])
def test_warp_split_model_matches_pallas(page, D, Hq, Hkv, softcap, dtype, window):
    arrs = _edge_inputs(page * D + Hq, page, Hq, Hkv, D)
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, _, _) = _both(_pallas_arrays(arrs), dtype)
    want = np.asarray(
        paged_pallas(jq, jk, jv, jbt, jcl, softcap=softcap, interpret=True), np.float32)
    # the model reads the inputs as the kernel does: in the working type
    q, kp, vp = (t.float().numpy() for t in (tq, tk, tv))
    got32 = warp_split_model(q, kp, vp, arrs[3], arrs[4], softcap=softcap, window=window)
    got = torch.from_numpy(got32).to(tq.dtype).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:  # both round one fp32 value once: one bf16 ulp at most
        over = np.abs(got - want) - (np.abs(want) * 2.0 ** -7 + 1e-4)
        assert over.max() <= 0, f"worst element {over.max():.3e} over one rounding"
    dead = ~_live_rows(arrs[3], arrs[4], page)
    assert (got[dead] == 0).all() and dead.sum() == 2


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("live,P", [(None, 4096), (64, 4096), (None, 64)])
def test_chip_smoke_rows_have_their_own_pages(live, P):
    """`chip_smoke.py`'s attention rows give every row its own pages, as
    the engine's allocator does, so its byte bound counts no K/V read
    that another row's launch could find in L2; P grows where the rows
    need more pages than it gives."""
    cs = _chip_smoke()
    page = 4
    q, k, v, tables, lens = cs.attention_inputs(
        torch, torch.device("cpu"), torch.float32, Hq=2, Hkv=1, D=8, page=page,
        P=P, live=live)
    ids = tables[tables >= 0]
    assert ids.numel() == ids.unique().numel()
    assert int(ids.max()) < k.shape[0] and k.shape[0] >= P
    need = -(-lens.long() // page)
    zero_ctx_rows = (tables >= 0).sum(1) != need
    assert bool((lens[zero_ctx_rows] == 0).all())
    if live is not None:
        assert int((lens > 0).sum()) == live and not bool(zero_ctx_rows.any())
    if P == 64:
        assert k.shape[0] == ids.numel() > P
