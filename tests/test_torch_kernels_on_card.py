"""The port's CUDA kernels against their plain versions, on the card.

These tests import torch, numpy and the port only (the machine with the
card has no JAX).  Without a card each test skips with its reason; on
one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_on_card.py

The three NBBS launchers of `csrc/nbbs_pool_step.cu` must be
bit-identical to their plain versions in both tree layouts and both
memory tiers: kernel A (the pooled step) to the lockstep router,
overflow included, and its release half alone to `pool_free_round`,
per-handle freed flags included, with and without the fastpath slab;
the magazine path of `ops.nbbs_pool_wavefront_step` on CUDA tensors
to the same path on CPU tensors; kernel 3 to `wavefront_step` and
`wavefront_free`; kernel 4 to `wavefront_alloc`.  Kernel B (paged
attention) must agree within fp32 2e-5 and, in bf16, within one
rounding of the output (2^-7 |want| + 1e-4), and give zeros on rows
with no live position, at the serving models' widths and on the edges
of its order of work (holes, contexts ending mid-page, one warp's share,
tables over several windows), on one layer of an engine pool and on a
view off a 16-byte boundary.  Kernel 5 (flash attention) must agree with
`flash_attention_plain` within fp32 2e-5 / bf16 2e-2 over the sweep of
tests/test_kernels.py (shapes, variants, block sizes), at D=80 and
D=128 and with a ragged Sk, every bf16 output also within one rounding
(2^-7 |want| + 1e-4), its tensor-core body at S = 1024-2048 over D in
{16, 24, 64, 80, 128, 256}, GQA groups 1-4, windows, softcaps, ragged
S and Sk and B = 2, its fp32 body (3xTF32 at D <= 128, the CUDA cores
above) within 2e-5 + 2e-5 |want| at S and Sk off its 32-row tiles, D in
{8, 16, 72, 80, 128, 256}, the window's first live tile and GQA 40/10
at S=2048, and the gradient of `ops.flash_attention` must equal
autograd through the plain version.  The engine's decode
step must run with no host sync in both layouts, with and without the
front ends and the event ring.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import concurrent as conc
from repro_torch.core.concurrent import BUNCH_PACKED, UNPACKED, TreeConfig
from repro_torch.core.fastpath import FastPathConfig
from repro_torch.core.magazine import MagazineConfig
from repro_torch.core.pool import (
    PoolConfig,
    pool_free_round,
    pool_init_magazines,
    pool_wavefront_step,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import nbbs_alloc, ops, paged_attention as pa
from repro_torch.models.transformer import init_params
from repro_torch.obs.trace_export import validate_snapshot
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import JitServeEngine
from torch_card import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda

LAYOUTS = {"unpacked": UNPACKED, "packed": BUNCH_PACKED}


def _pool_churn(dev, pcfg, seed, steps=8, K=64, F=32):
    """Seeded mixed steps of kernel A against the lockstep router.
    Returns the overflow and fastpath-hit counts."""
    S, depth = pcfg.n_shards, pcfg.tree.depth
    rng = np.random.default_rng(seed)
    trees = pcfg.empty_trees(dev)
    N = pcfg.n_words
    overflows = hits = 0
    for _ in range(steps):
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
        hits += int(got[4]["fastpath_hits"])
        trees = got[0]
    return overflows, hits


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("S,depth", [(1, 6), (4, 5), (1, 12), (4, 10)])
def test_pool_step_kernel_matches_plain(cuda_device, S, depth, layout):
    pcfg = PoolConfig(TreeConfig(depth=depth, layout=LAYOUTS[layout]), S)
    assert nbbs_alloc.tier(pcfg.tree, S, 64) == "shared"
    overflows, _ = _pool_churn(cuda_device, pcfg, S * 100 + depth)
    if S > 1 and depth < 10:
        assert overflows > 0


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("S,depth,tier", [
    (1, 6, "shared"), (4, 5, "shared"), (1, 12, "shared"), (4, 10, "shared"),
    (1, 14, "shared"), (2, 13, "shared"), (1, 16, "device"), (4, 14, "device"),
])
def test_pool_step_slab_kernel_matches_plain(cuda_device, S, depth, tier, layout):
    """Kernel A with the fastpath slab: routed release, slab claims in
    every round, exhaustion into the buddy round, in both tiers."""
    pcfg = PoolConfig(TreeConfig(depth=depth, layout=LAYOUTS[layout]), S,
                      fastpath=FastPathConfig(slab_level=2))
    assert nbbs_alloc.tier(pcfg.tree, S, 64, pcfg.fp_state_words) == tier
    before = nbbs_alloc.tier_launches[tier]
    _, hits = _pool_churn(cuda_device, pcfg, S * 100 + depth, steps=8 if tier == "shared" else 3)
    assert hits > 0
    assert nbbs_alloc.tier_launches[tier] > before


@pytest.mark.parametrize("fastpath", [False, True])
@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_magazine_path_on_card_matches_cpu(cuda_device, layout, fastpath):
    """`ops.nbbs_pool_wavefront_step(mags=)` on CUDA tensors (stash and
    claim ops, kernel A, the masked spill-back and retry launch) equals
    its plain path on CPU tensors: trees, magazines, nodes, shards and
    every stat slot, exhaustion spill-backs included."""
    depth, S, L, K, F = 5, 2, 6, 24, 24
    pcfg = PoolConfig(TreeConfig(depth=depth, layout=LAYOUTS[layout]), S,
                      fastpath=FastPathConfig() if fastpath else None,
                      magazines=MagazineConfig(mag_cap=3))
    cpu = torch.device("cpu")
    state = {d: (pcfg.empty_trees(d), pool_init_magazines(pcfg, L, d)) for d in (cpu, cuda_device)}
    rng = np.random.default_rng(S + depth)
    live, spills = [], 0
    for step in range(12):
        lv = np.where(rng.random(K) < 0.8, depth, rng.integers(1, depth + 1, K))
        take = [live[i] for i in rng.permutation(len(live))[:F - 2]]
        fn, fs = np.zeros(F, np.int64), np.zeros(F, np.int64)
        if take:
            fn[:len(take)], fs[:len(take)] = np.array(take).T
        fn[len(take)], fs[len(take)] = fn[0], fs[0]          # a duplicate
        fa = np.arange(F) <= len(take)
        arrays = [fn, fs, fa, lv, rng.random(K) < 0.9, rng.integers(0, 1000, K),
                  rng.integers(-1, L, F), rng.integers(-1, L, K)]
        out = {}
        for d, (trees, mags) in state.items():
            a = [torch.from_numpy(np.asarray(x)).to(d) for x in arrays]
            a = [t.to(torch.int32) if t.dtype == torch.int64 else t for t in a]
            before = nbbs_alloc.launches
            out[d] = ops.nbbs_pool_wavefront_step(
                pcfg, trees, a[0], a[1], a[2], a[3], active=a[4], lane_ids=a[5],
                mags=mags, free_mag_lane=a[6], alloc_mag_lane=a[7])
            assert nbbs_alloc.launches == before + (2 if d.type == "cuda" else 0)
        want, got = out[cpu], out[cuda_device]
        for a, b, what in zip(want[:5], got[:5], ("trees", "mags", "nodes", "shard", "ok")):
            for x, y in zip(a if what == "mags" else (a,), b if what == "mags" else (b,)):
                assert torch.equal(x, y.cpu()), (step, what)
        for k in want[5]:
            assert int(want[5][k]) == int(got[5][k]), (step, k)
        spills += int(got[5]["magazine_spills"])
        state = {d: (out[d][0], out[d][1]) for d in out}
        gone = set(zip(fn[fa].tolist(), fs[fa].tolist()))
        live = [h for h in live if h not in gone]
        live += [(int(n), int(s)) for n, s, o in zip(got[2].tolist(), got[3].tolist(),
                                                     got[4].tolist()) if o]
    assert spills > 0


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("S,depth,tier", [
    (1, 14, "shared"), (2, 13, "shared"), (1, 16, "device"), (4, 14, "device"),
])
def test_pool_step_device_tier_matches_plain(cuda_device, S, depth, tier, layout):
    """Stacks of 2^15 nodes run from shared memory; above one block's
    shared memory the same kernel runs from a device-memory workspace.
    Both stay bit-identical."""
    pcfg = PoolConfig(TreeConfig(depth=depth, layout=LAYOUTS[layout]), S)
    assert nbbs_alloc.tier(pcfg.tree, S, 64) == tier
    before = nbbs_alloc.tier_launches[tier]
    _pool_churn(cuda_device, pcfg, depth, steps=3)
    assert nbbs_alloc.tier_launches[tier] >= before + 6


def test_pool_step_kernel_refuses_large_pools(cuda_device):
    """The kernel takes up to 2^19 tree nodes in all (both tiers); a
    larger stack raises before any launch."""
    z = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for pcfg in (PoolConfig(TreeConfig(depth=19), 1), PoolConfig(TreeConfig(depth=18), 2)):
        with pytest.raises(ValueError, match="tree nodes"):
            nbbs_alloc.pool_step(pcfg, pcfg.empty_trees(cuda_device), z, z, z, z, z.bool())
    cfg = TreeConfig(depth=19, layout=BUNCH_PACKED)
    with pytest.raises(ValueError, match="tree nodes"):
        nbbs_alloc.wavefront_alloc(cfg, cfg.empty_tree(cuda_device), z, z.bool())


def _single_tree(dev, cfg, seed, steps, K, F):
    """Kernels 3 and 4 against wavefront_step / wavefront_alloc /
    wavefront_free on a churn of mixed octaves, frees from the live set
    plus junk and duplicate handles."""
    depth = cfg.depth
    rng = np.random.default_rng(seed)
    tree = cfg.empty_tree(dev)
    live = np.zeros(0, np.int32)
    for step in range(steps):
        levels = torch.from_numpy(rng.integers(max(depth - 8, 0), depth + 1, size=K)
                                  .astype(np.int32)).to(dev)
        act = torch.from_numpy(rng.random(K) < 0.9).to(dev)
        take = rng.permutation(live)[:F - 4]
        fn = np.r_[take, rng.integers(0, cfg.n_words + 4, size=3), take[:1]]
        fn = np.r_[fn, np.zeros(F - len(fn), np.int64)].astype(np.int32)
        fa = np.arange(F) < len(take) + 4
        fn, fa = torch.from_numpy(fn).to(dev), torch.from_numpy(fa).to(dev)
        if step % 2 == 0:
            want = conc.wavefront_alloc(cfg, tree, levels, act)
            got = nbbs_alloc.wavefront_alloc(cfg, tree, levels, act)
            slots = ("rounds", "merged_writes", "logical_rmws")
        else:
            want = conc.wavefront_step(cfg, tree, fn, fa, levels, act)
            got = nbbs_alloc.wavefront_step(cfg, tree, fn, fa, levels, act)
            slots = ("rounds", "merged_writes", "logical_rmws",
                     "free_merged_writes", "free_logical_rmws", "freed")
            wf = conc.wavefront_free(cfg, tree, fn, fa)
            gf = nbbs_alloc.wavefront_free(cfg, tree, fn, fa)
            assert torch.equal(wf[0], gf[0]) and torch.equal(wf[1], gf[1])
            for k in wf[2]:
                assert int(wf[2][k]) == int(gf[2][k]), k
            gone = set(fn[fa].tolist())
            live = np.array([n for n in live if n not in gone], np.int32)
        for a, b, what in zip(want[:3], got[:3], ("tree", "nodes", "ok")):
            assert torch.equal(a, b), (step, what)
        assert [int(want[3][k]) for k in slots] == got[3].tolist(), step
        live = np.r_[live, got[1][got[2]].cpu().numpy()].astype(np.int32)
        tree = got[0]


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("depth,K,tier", [
    (6, 16, "shared"), (12, 128, "shared"), (14, 256, "shared"), (14, 2048, "shared"),
    (16, 256, "device"), (18, 64, "device"),
])
def test_single_tree_kernels_match_plain(cuda_device, depth, K, tier, layout):
    cfg = TreeConfig(depth=depth, layout=LAYOUTS[layout])
    assert nbbs_alloc.tier(cfg, 1, K) == tier
    counts = (nbbs_alloc.wavefront_alloc_launches, nbbs_alloc.wavefront_step_launches,
              nbbs_alloc.tier_launches[tier])
    _single_tree(cuda_device, cfg, depth, steps=4, K=K, F=K // 2)
    assert nbbs_alloc.wavefront_alloc_launches == counts[0] + 2
    assert nbbs_alloc.wavefront_step_launches == counts[1] + 4
    assert nbbs_alloc.tier_launches[tier] >= counts[2] + 6


def test_out_of_range_levels_stay_pending_on_card(cuda_device):
    cfg = TreeConfig(depth=6, max_level=1, layout=BUNCH_PACKED)
    levels = torch.tensor([3, 0, 6, 9, 2, -1], dtype=torch.int32, device=cuda_device)
    act = torch.ones(6, dtype=torch.bool, device=cuda_device)
    tree = cfg.empty_tree(cuda_device)
    want = conc.wavefront_alloc(cfg, tree, levels, act, 9)
    got = nbbs_alloc.wavefront_alloc(cfg, tree, levels, act, 9)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert got[3].tolist() == [9, int(want[3]["merged_writes"]),
                               int(want[3]["logical_rmws"])]


def _paged_inputs(dev, dtype, B, Hq, Hkv, D, page, MP, P, seed, pool=None):
    """Seeded q, K/V pages, tables and lengths.  Rows 0-5 sit on the edges
    of the kernel's order of work: a -1 hole mid-table, a context ending
    mid-page, one item only (the other warps' shares empty), pages with
    zero context, no page with a context, a context past the table; the
    rest take random lengths, every fourth zero.  `pool` = (layers,
    layer) gives K/V as one layer's view of an engine pool
    [layers, P + 1, page, Hkv, D], whose sink page P the tables use."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Hq, D), generator=g).to(dev, dtype)
    if pool is None:
        k, v = (torch.randn((P, page, Hkv, D), generator=g).to(dev, dtype)
                for _ in range(2))
    else:
        layers, li = pool
        k, v = (torch.randn((layers, P + 1, page, Hkv, D), generator=g).to(dev, dtype)[li]
                for _ in range(2))
    lens = torch.randint(0, MP * page + 1, (B,), generator=g)
    lens[::4] = 0
    n_pages = [-(-int(n) // page) for n in lens]
    for b, (n, ctx) in enumerate([(MP, MP * page - 3), (5, 4 * page + 1), (1, min(page, 4)),
                                  (3, 0), (0, 2 * page), (MP, MP * page + 7)]):
        n_pages[b], lens[b] = n, ctx
    tables = torch.full((B, MP), -1, dtype=torch.int32)
    for b, n in enumerate(n_pages):
        tables[b, :n] = torch.randperm(P, generator=g)[:n].to(torch.int32)
    tables[0, MP // 2] = -1
    if pool is not None:
        tables[6:, 0] = P        # the sink page
    return q, k, v, tables.to(dev), lens.to(torch.int32).to(dev)


def _paged_check(dev, dtype, q, k, v, tables, lens, softcap=None, dead_rows=True):
    """Kernel B against its plain version: bf16 within one rounding of the
    output (both round one fp32 value once), fp32 within 2e-5, exact
    zeros on rows with no live position (some row has none unless
    `dead_rows` is False).  Returns the worst element's error over its
    limit (<= 0)."""
    before = pa.launches
    out = pa.paged_attention(q, k, v, tables, lens, softcap=softcap)
    assert pa.launches == before + 1
    want = pa.paged_attention_plain(q, k, v, tables, lens, softcap=softcap)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    w = want.float().abs()
    limit = w * 2.0 ** -7 + 1e-4 if dtype == torch.bfloat16 else w * 2e-5 + 2e-5
    over = float(((out.float() - want.float()).abs() - limit).max())
    assert over <= 0, f"worst element {over:.3e} over its limit"
    page = k.shape[1]
    pos = torch.arange(tables.shape[1] * page, device=dev)
    live = ((tables >= 0).repeat_interleave(page, dim=1)
            & (pos[None, :] < lens[:, None])).any(dim=1)
    assert (~live).any() or not dead_rows
    assert (out[~live] == 0).all()
    return over


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,page,softcap", [
    (8, 8, 80, 4, None), (8, 2, 128, 16, 50.0), (4, 4, 16, 8, None),
    (32, 32, 80, 4, None),      # stablelm-3b
    (40, 10, 128, 4, None),     # phi3-medium-14b
    (32, 16, 128, 4, 50.0),     # gemma2-27b
    (24, 8, 128, 4, None),      # minitron-4b: group 3
    (40, 8, 128, 4, None),      # llama4-scout: group 5, two CTAs per kv head
    (56, 8, 128, 8, None),      # llava-next-34b: group 7
    (32, 32, 64, 4, None),      # musicgen-large
    (16, 1, 32, 4, None),       # one kv head, group 16
    (4, 1, 8, 2, 30.0),         # D = 8, pages of 2
])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, Hq, Hkv, D, page,
                                              softcap):
    args = _paged_inputs(cuda_device, dtype, 24, Hq, Hkv, D, page, 32, 512, seed=D + page)
    _paged_check(cuda_device, dtype, *args, softcap=softcap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_on_engine_layer_view(cuda_device, dtype):
    """K/V as the engine passes them: one layer of [layers, P + 1, ...],
    the sink page P addressable."""
    args = _paged_inputs(cuda_device, dtype, 24, 32, 32, 80, 4, 32, 256, seed=7,
                         pool=(3, 1))
    assert args[1].shape[0] == 257 and int((args[3] == 256).sum()) == 18
    _paged_check(cuda_device, dtype, *args)


def test_paged_attention_kernel_over_several_windows(cuda_device):
    """A table longer than the 1024 entries the kernel compacts at once."""
    args = _paged_inputs(cuda_device, torch.bfloat16, 8, 4, 2, 64, 1, 2600, 4096, seed=3)
    assert int(args[4].max()) > 2048
    _paged_check(cuda_device, torch.bfloat16, *args, softcap=30.0)


def test_paged_attention_kernel_takes_unaligned_pages(cuda_device):
    """A K/V view off a 16-byte boundary is copied, not misread."""
    P, page, Hkv, D = 64, 4, 4, 32
    q, k, v, tables, lens = _paged_inputs(cuda_device, torch.bfloat16, 8, 8, Hkv, D,
                                          page, 8, P, seed=5)
    n = P * page * Hkv * D
    flat = torch.zeros(n + 4, dtype=torch.bfloat16, device=cuda_device)
    k_off = flat[4:].view(P, page, Hkv, D)
    k_off.copy_(k)
    assert k_off.data_ptr() % 16 == 8
    _paged_check(cuda_device, torch.bfloat16, q, k_off, v, tables, lens)


def _host_loop_inputs(dev, dtype, B, page, width, seed, Hq=32, Hkv=32, D=80):
    """Kernel B's inputs as `ServeEngine.step` gives them: a pool of
    `width` pages (plus the sink page), B live sequences admitted by a
    `PagedKVManager` (each table row a concatenation of contiguous buddy
    runs), padded to the next power of two with empty rows (table -1,
    context 0)."""
    from repro_torch.memory.kv_cache import PagedKVManager

    g = torch.Generator().manual_seed(seed)
    kv = PagedKVManager(width, page, max_run_pages=8)
    rng = np.random.default_rng(seed)
    tokens = []
    for sid in range(B):
        n = int(rng.integers(1, 24 * page))
        assert kv.add_sequence(sid, n)
        kv.append_tokens(sid, int(rng.integers(0, 4 * page)))   # grow by doubling
        tokens.append(kv.seqs[sid].n_tokens)
    B2 = 1 << max(B - 1, 0).bit_length()
    tables = np.full((B2, width), -1, np.int32)
    tables[:B] = kv.block_tables(list(range(B)), width)
    lens = np.zeros(B2, np.int32)
    lens[:B] = tokens
    assert max(len(kv.seqs[s].runs) for s in range(B)) > 1
    q = torch.randn((B2, Hq, D), generator=g).to(dev, dtype)
    k, v = (torch.randn((width + 1, page, Hkv, D), generator=g).to(dev, dtype)
            for _ in range(2))
    return q, k, v, torch.from_numpy(tables).to(dev), torch.from_numpy(lens).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("width", [256, 4096])
def test_paged_attention_kernel_at_host_loop_shapes(cuda_device, dtype, B, page, width):
    """stablelm-3b's widths (32/32 heads, D=80) at the host-loop engine's
    shapes: 1 row, or 5 rows padded to 8; pages of 8 (the launcher) or
    16 (the engine's default); tables as wide as the pool."""
    args = _host_loop_inputs(cuda_device, dtype, B, page, width, seed=B + page + width)
    assert args[0].shape[0] == (1 if B == 1 else 8)
    _paged_check(cuda_device, dtype, *args, dead_rows=B > 1)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("layout", ["unpacked", "bunch-packed"])
def test_pool_kernel_on_kv_manager_config_admits_host_pages(cuda_device, S, layout):
    """Kernel A on `PagedKVManager.device_pool_config()`: one chunk per
    sequence, homed by its id, lands on the shard and page the host
    manager gives it, overflow and failure included."""
    from repro_torch.core.nbbs import init_pool_state, nb_pool_alloc
    from repro_torch.memory.kv_cache import PagedKVManager

    host = PagedKVManager(256, 4, n_shards=S, layout=layout, max_run_pages=16)
    pcfg = host.device_pool_config()
    state = init_pool_state(pcfg, cuda_device)
    rng = np.random.default_rng(S)
    before, failed = nbbs_alloc.launches, 0
    for sid in range(60):
        pages = int(2 ** rng.integers(0, 5))
        ok_host = host.add_sequence(sid, pages * 4)
        level = pcfg.tree.depth - (pages.bit_length() - 1)
        state, shard, off, ok = nb_pool_alloc(pcfg, state, level, lane_id=sid)
        assert bool(ok) == ok_host, sid
        failed += not ok_host
        if ok_host:
            s = host.seqs[sid]
            assert (int(shard), int(off)) == (
                s.shard, s.runs[0].start - s.shard * host.pages_per_shard), sid
    assert nbbs_alloc.launches == before + 60
    assert failed > 0


def _flash_inputs(dev, dtype, B, Hq, Hkv, S, D, Sk=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    Sk = S if Sk is None else Sk
    return [torch.randn(shape, generator=g).to(dev, dtype)
            for shape in ((B, Hq, S, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


def _flash_check(dev, dtype, B, Hq, Hkv, S, D, Sk=None, block=64, **variant):
    q, k, v = _flash_inputs(dev, dtype, B, Hq, Hkv, S, D, Sk, seed=S + D)
    before = fa.launches
    out = fa.flash_attention_fwd(q, k, v, block_q=block, block_k=block, **variant)
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, **variant)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        # both round one fp32 value to bf16: at most one ulp apart
        err = (out.float() - want.float()).abs()
        assert bool((err <= want.float().abs() * 2.0 ** -7 + 1e-4).all()), float(err.max())
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,Hq,Hkv", [(128, 32, 4, 4), (256, 64, 8, 2), (192, 16, 2, 1)])
def test_flash_kernel_shapes_match_plain(cuda_device, S, D, Hq, Hkv, dtype):
    _flash_check(cuda_device, dtype, 2, Hq, Hkv, S, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", [
    dict(causal=False), dict(causal=True, window=64), dict(causal=True, softcap=30.0),
    dict(causal=True, window=96, softcap=50.0), dict(causal=True, window=0),
    dict(causal=True, window=-7),
], ids=["noncausal", "window64", "softcap30", "window96-softcap50", "window0",
        "window-negative"])
def test_flash_kernel_variants_match_plain(cuda_device, variant, dtype):
    """A degenerate window (0 or negative) leaves no live column: zeros."""
    out = _flash_check(cuda_device, dtype, 1, 4, 2, 256, 32, **variant)
    if variant.get("window", 1) <= 0:
        assert not out.any()


@pytest.mark.parametrize("block", [32, 128])
def test_flash_kernel_block_sizes_match_plain(cuda_device, block):
    _flash_check(cuda_device, torch.float32, 1, 2, 2, 256, 32, block=block)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,variant", [
    (8, 8, 80, dict(causal=True)),                             # stablelm-3b
    (8, 2, 128, dict(causal=True)),                            # phi3-medium
    (8, 4, 128, dict(causal=True, window=100, softcap=50.0)),  # gemma2 local
    (4, 2, 256, dict(causal=False, softcap=30.0)),             # D at its limit
], ids=["d80", "d128-gqa4", "d128-window-softcap", "d256"])
def test_flash_kernel_model_widths_match_plain(cuda_device, dtype, Hq, Hkv, D, variant):
    """The repo's head widths, S=320 (a partial q tile of the kernel)."""
    _flash_check(cuda_device, dtype, 1, Hq, Hkv, 320, D, **variant)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Sk,variant", [
    (100, 200, dict(causal=True)), (200, 100, dict(causal=True, window=30)),
    (60, 132, dict(causal=False, softcap=20.0)),
])
def test_flash_kernel_ragged_kv_matches_plain(cuda_device, S, Sk, variant, dtype):
    """Sk and S off the kernel's tiles (blocks of 4 pass the JAX check)."""
    _flash_check(cuda_device, dtype, 2, 4, 2, S, 80, Sk=Sk, block=4, **variant)


_CAUSAL = dict(causal=True)
_TC_CASES = [
    # (B, Hq, Hkv, S, Sk, D, block, variant): several kv tiles, interior
    # and diagonal, at the repo's head widths and GQA groups 1, 2 and 4
    *[(1, 4, 4 // group, 1024, None, D, 64, _CAUSAL)
      for D in (64, 80, 128) for group in (1, 2, 4)],
    (1, 4, 2, 1024, None, 128, 64, dict(causal=True, window=100)),  # ends inside a tile
    (1, 4, 2, 1024, None, 128, 64, dict(causal=True, softcap=50.0)),
    (1, 4, 1, 2048, None, 80, 64, dict(causal=True, window=700, softcap=50.0)),
    (1, 4, 2, 1024, None, 128, 64, dict(causal=False)),
    (1, 4, 2, 1020, 1100, 80, 4, _CAUSAL),                    # Sk != S, both ragged
    (1, 4, 2, 1100, 1020, 128, 4, dict(causal=True, window=250)),
    (2, 4, 2, 1024, None, 80, 64, _CAUSAL),                   # B = 2
    # contraction padding (16, 24) and the register budget (256)
    *[(1, 4, 2, 1024, None, D, 64, dict(causal=True, window=300)) for D in (16, 24, 256)],
    (1, 2, 1, 1024, None, 256, 64, dict(causal=False, softcap=30.0)),
]
_TC_IDS = [
    *[f"d{D}-group{g}" for D in (64, 80, 128) for g in (1, 2, 4)],
    "d128-window100", "d128-softcap50", "d80-s2048-window700-softcap50",
    "d128-noncausal", "d80-sk1100-s1020", "d128-sk1020-s1100-window250", "d80-b2",
    "d16-window300", "d24-window300", "d256-window300", "d256-noncausal-softcap30",
]


@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,D,block,variant", _TC_CASES, ids=_TC_IDS)
def test_flash_bf16_tensor_core_tiles_match_plain(cuda_device, B, Hq, Hkv, S, Sk, D,
                                                   block, variant):
    """The bf16 body (tensor cores, P as a hi/lo bf16 pair) within one
    rounding of the output at S = 1024-2048: many kv tiles, with and
    without masks."""
    _flash_check(cuda_device, torch.bfloat16, B, Hq, Hkv, S, D, Sk=Sk, block=block,
                 **variant)


_TF32_CASES = [
    # (B, Hq, Hkv, S, Sk, D, block, variant): the fp32 body's edges
    (1, 4, 2, 100, 200, 80, 4, _CAUSAL),                      # S, Sk off the 32-row tiles
    (1, 4, 2, 1020, 1100, 128, 4, _CAUSAL),
    (2, 4, 2, 1100, 1020, 80, 4, dict(causal=True, window=250)),
    (1, 4, 4, 333, 333, 80, 333, dict(causal=False, softcap=20.0)),
    # D: 8 and 16 (one panel, mostly zero fill), 72 and 80 (the third
    # panel half used), 128 (four panels, two stages), 256 (the CUDA-core body)
    *[(1, 4, 2, 1024, None, D, 64, _CAUSAL) for D in (8, 16, 72, 80, 128, 256)],
    # the window's first live tile: starting inside a tile, on a tile's
    # edge, one column wide, and wider than the q tile
    *[(1, 4, 2, 1024, None, 80, 64, dict(causal=True, window=w))
      for w in (1, 31, 32, 33, 100, 700)],
    (1, 4, 1, 2048, None, 128, 64, dict(causal=True, window=1024, softcap=50.0)),
    (1, 4, 2, 1024, None, 128, 64, dict(causal=True, softcap=50.0)),
    (1, 40, 10, 2048, None, 128, 64, _CAUSAL),                # phi3-medium's GQA 40/10
    (1, 4, 2, 1024, None, 80, 64, dict(causal=False)),
    (1, 2, 2, 1024, None, 80, 64, dict(causal=True, window=0)),   # no live column
]
_TF32_IDS = [
    "d80-s100-sk200", "d128-s1020-sk1100", "d80-b2-s1100-sk1020-window250",
    "d80-s333-noncausal-softcap20",
    *[f"d{D}" for D in (8, 16, 72, 80, 128, 256)],
    *[f"d80-window{w}" for w in (1, 31, 32, 33, 100, 700)],
    "d128-s2048-window1024-softcap50", "d128-softcap50", "d128-gqa40-10-s2048",
    "d80-noncausal", "d80-window0",
]


@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,D,block,variant", _TF32_CASES, ids=_TF32_IDS)
def test_flash_fp32_tensor_core_tiles_match_plain(cuda_device, B, Hq, Hkv, S, Sk, D,
                                                   block, variant):
    """The fp32 body (3xTF32 on the tensor cores at D <= 128, the CUDA
    cores above) within 2e-5 + 2e-5 |want| of the plain version at the
    edges of its tiling: ragged S and Sk, every D dispatch, the window's
    first live tile, GQA 40/10 at S=2048."""
    out = _flash_check(cuda_device, torch.float32, B, Hq, Hkv, S, D, Sk=Sk, block=block,
                       **variant)
    if variant.get("window", 1) <= 0:
        assert not out.any()


def test_flash_kernel_refuses_unsupported(cuda_device):
    q, k, v = _flash_inputs(cuda_device, torch.float16, 1, 2, 2, 64, 32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _flash_inputs(cuda_device, torch.float32, 1, 2, 2, 64, 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("variant", [
    dict(causal=True), dict(causal=True, window=48, softcap=30.0),
], ids=["causal", "window-softcap"])
def test_flash_gradient_on_card_matches_plain(cuda_device, variant):
    """`ops.flash_attention` launches the kernel forward and its backward
    recomputes the reference: its gradients equal autograd through the
    plain version (atol 1e-5, tests/test_kernels.py's).  This checks the
    autograd wiring; the kernel's own output is checked above."""
    q, k, v = _flash_inputs(cuda_device, torch.float32, 1, 4, 2, 256, 80)
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    grads = []
    for fn in (ops.flash_attention, fa.flash_attention_plain):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = fa.launches
        out = fn(*leaves, **variant)
        assert fa.launches == before + (fn is ops.flash_attention)
        grads.append(torch.autograd.grad((out * w).sum(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout,frontends", [
    ("unpacked", {}), ("bunch-packed", {}),
    ("unpacked", {"fastpath": True}), ("bunch-packed", {"fastpath": True, "magazines": 2}),
    ("unpacked", {"ring_capacity": 16}), ("bunch-packed", {"ring_capacity": 4}),
])
def test_engine_decode_has_no_host_sync(cuda_device, layout, frontends):
    """A few decode chunks of the reduced model under
    set_sync_debug_mode("error"), launching both kernels, with and
    without the fastpath, the magazines and the event ring."""
    cfg = get_config("stablelm-3b").reduced()
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                         device=cuda_device)
    eng = JitServeEngine(cfg, params, num_pages=64, page_tokens=4, max_batch=4,
                         max_lane_pages=8, max_out=8, device=cuda_device,
                         n_shards=2, layout=layout, **frontends)
    decode = eng.decode_steps

    def decode_without_sync(n, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(n, **kw)
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
    tot = eng.stat_totals()
    if frontends.get("fastpath"):
        assert tot["fastpath_hits"] > 0
    if frontends.get("magazines"):
        assert tot["magazine_hits"] > 0
    cap = frontends.get("ring_capacity", 0)
    if cap:
        snap = eng.snapshot()
        validate_snapshot(snap)
        assert len(snap["events"]) == min(tot["ring_events"], cap)
        assert tot["ring_dropped"] == max(tot["ring_events"] - cap, 0)
