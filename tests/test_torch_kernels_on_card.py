"""The port's CUDA kernels against their plain versions, on the card.

These tests import torch, numpy and the port only (the machine with the
card has no JAX).  Without a card each test skips with its reason; on
one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_on_card.py

Kernel A (the pooled NBBS step) must be bit-identical to the lockstep
router, overflow included, and its release half alone to
`pool_free_round`, per-handle freed flags included; kernel B (paged attention) must agree within
fp32 2e-5 / bf16 3e-2 and give zeros on rows with no live page.  The
engine's decode step must run with no host sync.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.concurrent import TreeConfig
from repro_torch.core.pool import PoolConfig, pool_free_round, pool_wavefront_step
from repro_torch.kernels import nbbs_alloc, paged_attention as pa
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import JitServeEngine
from torch_card import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("S,depth", [(1, 6), (4, 5), (1, 12)])
def test_pool_step_kernel_matches_plain(cuda_device, S, depth):
    dev = cuda_device
    pcfg = PoolConfig(TreeConfig(depth=depth), S)
    rng = np.random.default_rng(S * 100 + depth)
    trees = pcfg.empty_trees(dev)
    N = pcfg.n_words
    K, F = 64, 32
    overflows = 0
    for _ in range(8):
        levels = np.where(rng.random(K) < 0.6, depth,
                          rng.integers(max(depth - 3, 0), depth + 1, size=K))
        args = [
            rng.integers(0, N, size=F), rng.integers(-1, S + 1, size=F),
            rng.random(F) < 0.7, levels, rng.random(K) < 0.9,
            rng.integers(-2, 2**31 - 1, size=K),
        ]
        fn, fs, fa, lv, act, ids = (
            torch.from_numpy(np.asarray(a)).to(dev) for a in args
        )
        fn, fs, lv, ids = (t.to(torch.int32) for t in (fn, fs, lv, ids))
        want_f = pool_free_round(pcfg, trees, fn, fs, fa)
        got_f = nbbs_alloc.pool_free(pcfg, trees, fn, fs, fa)
        assert torch.equal(want_f[0], got_f[0]) and torch.equal(want_f[3], got_f[1])
        assert int(want_f[3].sum()) == int(got_f[2]["freed"])
        want = pool_wavefront_step(pcfg, trees, fn, fs, fa, lv, act, 64, ids)
        got = nbbs_alloc.pool_step(pcfg, trees, fn, fs, fa, lv, act, ids)
        for a, b, what in zip(want[:4], got[:4], ("trees", "nodes", "shard", "ok")):
            assert torch.equal(a, b), what
        for k in want[4]:
            assert int(want[4][k]) == int(got[4][k]), k
        overflows += int(got[4]["overflows"])
        trees = got[0]
    if S > 1:
        assert overflows > 0


def test_pool_step_kernel_refuses_large_pools(cuda_device):
    pcfg = PoolConfig(TreeConfig(depth=13), 1)
    z = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="4096 pages"):
        nbbs_alloc.pool_step(pcfg, pcfg.empty_trees(cuda_device), z, z, z, z, z.bool())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("Hq,Hkv,D,page,softcap", [
    (8, 8, 80, 4, None), (8, 2, 128, 16, 50.0), (4, 4, 16, 8, None),
])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, tol, Hq, Hkv, D,
                                              page, softcap):
    dev = cuda_device
    g = torch.Generator().manual_seed(D + page)
    B, P, MP = 12, 64, 6
    q = torch.randn((B, Hq, D), generator=g).to(dev, dtype)
    k = torch.randn((P, page, Hkv, D), generator=g).to(dev, dtype)
    v = torch.randn((P, page, Hkv, D), generator=g).to(dev, dtype)
    lens = torch.randint(0, MP * page + 1, (B,), generator=g)
    lens[::4] = 0
    tables = torch.full((B, MP), -1, dtype=torch.int32)
    for b in range(B):
        n = max(-(-int(lens[b]) // page), 1 if b % 8 == 4 else 0)
        tables[b, :n] = torch.randperm(P, generator=g)[:n].to(torch.int32)
    tables, lens = tables.to(dev), lens.to(torch.int32).to(dev)
    before = pa.launches
    out = pa.paged_attention(q, k, v, tables, lens, softcap=softcap)
    assert pa.launches == before + 1
    want = pa.paged_attention_plain(q, k, v, tables, lens, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert (out[lens == 0] == 0).all()


def test_engine_decode_has_no_host_sync(cuda_device):
    """A few decode chunks of the reduced model under
    set_sync_debug_mode("error"), launching both kernels."""
    cfg = get_config("stablelm-3b").reduced()
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                         device=cuda_device)
    eng = JitServeEngine(cfg, params, num_pages=64, page_tokens=4, max_batch=4,
                         max_lane_pages=8, max_out=8, device=cuda_device,
                         n_shards=2)
    decode = eng.decode_steps

    def decode_without_sync(n):
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(n)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng.decode_steps = decode_without_sync
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(Request(i, rng.integers(0, 256, int(rng.integers(2, 9))).astype(np.int32),
                           int(rng.integers(2, 8))))
    a0, b0 = nbbs_alloc.launches, pa.launches
    eng.run_to_completion(max_steps=100, chunk=4)
    assert len(eng.completed) == 6
    assert nbbs_alloc.launches > a0 and pa.launches > b0
    assert eng.device_free_pages() == 64
