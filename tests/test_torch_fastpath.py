"""The port's fastpath slab against the JAX package, bit for bit.

`core/fastpath.py` (geometry, the carve, routing masks, slab claim and
release, bit 31 included) and the fastpath half of `core/pool.py`
(rounds with the slab claim, release routed by node range, occupancy
with the slab terms) get the same seeded numpy inputs as
`repro.core.fastpath` / `repro.core.pool`; trees, slab words, nodes,
shards, ok masks and every stat slot must be identical.  The pool's
behaviour against an uncarved pool (address identity on leaf traffic,
capacity on mixed octaves, exhaustion, full fill) is checked on the
port as tests/test_fastpath.py checks it on JAX.

Kernel A's slab phase is held against the same plain rounds on the card
by tests/test_torch_kernels_on_card.py and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import concurrent as jconc
from repro.core import fastpath as jfp
from repro.core import pool as jpool
from repro_torch.core import concurrent as tconc
from repro_torch.core import fastpath as tfp
from repro_torch.core import pool as tpool
from repro_torch.kernels import nbbs_alloc

LAYOUTS = ["unpacked", "bunch-packed"]

_j_step = jax.jit(jpool.pool_wavefront_step, static_argnums=(0, 7))
_j_claim = jax.jit(jfp.slab_claim, static_argnums=(0, 1))
_j_release = jax.jit(jfp.slab_release, static_argnums=(0, 1))
_j_carve = jax.jit(jfp.carved_empty_tree, static_argnums=(0, 1))
_j_empty = jax.jit(lambda p: p.empty_trees(), static_argnums=0)
_j_free_units = jax.jit(jpool.pool_free_units, static_argnums=0)
_j_largest_run = jax.jit(jpool.pool_largest_run, static_argnums=0)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _eq(a, b, what):
    """Equal 32-bit patterns: JAX's uint32 slab words against the port's
    int32 words with the same bits."""
    a, b = np.asarray(a), np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    mask = 0xFFFFFFFF
    assert ((a.astype(np.int64) & mask) == (b.astype(np.int64) & mask)).all(), what


def _trees(depth, layout, max_level=0):
    jl = jconc.BUNCH_PACKED if layout == "bunch-packed" else jconc.UNPACKED
    tl = tconc.BUNCH_PACKED if layout == "bunch-packed" else tconc.UNPACKED
    return (jconc.TreeConfig(depth=depth, max_level=max_level, layout=jl),
            tconc.TreeConfig(depth=depth, max_level=max_level, layout=tl))


def _pools(depth, S, layout, slab_level=2, level=None):
    jt, tt = _trees(depth, layout)
    return (
        jpool.PoolConfig(jt, S, fastpath=jfp.FastPathConfig(level, slab_level)),
        tpool.PoolConfig(tt, S, fastpath=tfp.FastPathConfig(level, slab_level)),
    )


# ---------------------------------------------------------------------------
# Config, geometry, carve, routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth,max_level,level,slab_level", [
    (3, 0, None, 0), (3, 0, None, 4), (3, 0, 1, 2), (4, 3, None, 2),
    (3, 0, None, 2), (8, 1, 6, 1), (12, 0, None, 2),
])
def test_config_validation_matches_jax(depth, max_level, level, slab_level):
    jt, tt = _trees(depth, "unpacked", max_level)
    outcomes = []
    for tree, pc, fc in ((jt, jpool.PoolConfig, jfp.FastPathConfig),
                         (tt, tpool.PoolConfig, tfp.FastPathConfig)):
        try:
            pc(tree, 1, fastpath=fc(level, slab_level))
            outcomes.append("ok")
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("depth,level,slab_level", [
    (3, None, 2), (6, 4, 1), (12, None, 2), (9, 9, 9),
])
def test_geometry_and_carve_match_jax(layout, depth, level, slab_level):
    jt, tt = _trees(depth, layout)
    jf, tf = jfp.FastPathConfig(level, slab_level), tfp.FastPathConfig(level, slab_level)
    for name in ("fp_level", "fp_n_slots", "fp_node_base", "fp_units_per_slot",
                 "fp_state_words"):
        assert getattr(jfp, name)(jt, jf) == getattr(tfp, name)(tt, tf), name
    assert jfp.fp_carve_node(jf) == tfp.fp_carve_node(tf)
    _eq(_j_carve(jt, jf), tfp.carved_empty_tree(tt, tf, "cpu"), "carve")
    for S in (1, 3):
        jp, tp = (jpool.PoolConfig(jt, S, fastpath=jf), tpool.PoolConfig(tt, S, fastpath=tf))
        assert jp.n_state_words == tp.n_state_words
        assert jp.fp_state_words == tp.fp_state_words
        jtr, ttr = _j_empty(jp), tp.empty_trees("cpu")
        _eq(jtr, ttr, "empty_trees")
        _eq(_j_free_units(jp, jtr), tpool.pool_free_units(tp, ttr), "free_units")
        assert int(_j_largest_run(jp, jtr)) == int(tpool.pool_largest_run(tp, ttr))


@pytest.mark.parametrize("depth,level,slab_level", [(5, None, 2), (7, 5, 1), (6, None, 6)])
def test_routing_masks_match_jax(depth, level, slab_level):
    jt, tt = _trees(depth, "unpacked")
    jf, tf = jfp.FastPathConfig(level, slab_level), tfp.FastPathConfig(level, slab_level)
    nodes = np.arange(-3, (2 << depth) + 3, dtype=np.int32)
    _eq(jfp.in_slab_leaf(jt, jf, jnp.asarray(nodes)), tfp.in_slab_leaf(tt, tf, _t(nodes)),
        "in_slab_leaf")
    _eq(jfp.in_carved_junk(jt, jf, jnp.asarray(nodes)), tfp.in_carved_junk(tt, tf, _t(nodes)),
        "in_carved_junk")


# ---------------------------------------------------------------------------
# Slab claim / release units
# ---------------------------------------------------------------------------


def _slab_words(rng, n_words, p_set):
    bits = rng.random((n_words, 32)) < p_set
    u = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(axis=1)
    return u.astype(np.uint32)


@pytest.mark.parametrize("depth,slab_level,p_set", [
    (5, 2, 0.3), (9, 2, 0.5), (9, 2, 0.97), (4, 2, 0.0), (8, 1, 0.8),
])
def test_slab_claim_and_release_match_jax(depth, slab_level, p_set):
    jt, tt = _trees(depth, "unpacked")
    jf, tf = jfp.FastPathConfig(None, slab_level), tfp.FastPathConfig(None, slab_level)
    n_slots = jfp.fp_n_slots(jt, jf)
    SW = jfp.fp_state_words(jt, jf)
    rng = np.random.default_rng(depth * 10 + slab_level)
    for trial in range(4):
        u = _slab_words(rng, SW, p_set)
        if n_slots < 32:
            u &= np.uint32((1 << n_slots) - 1)
        ju, tu = jnp.asarray(u), _t(u.view(np.int32))
        K = 40
        want = rng.random(K) < 0.6
        got_j = _j_claim(jt, jf, ju, jnp.asarray(want))
        got_t = tfp.slab_claim(tt, tf, tu, _t(want))
        for a, b, what in zip(got_j, got_t, ("slab", "nodes", "got", "merged", "hits")):
            _eq(a, b, ("claim", trial, what))
        base = jfp.fp_node_base(jt, jf)
        nodes = rng.integers(base - 3, base + n_slots + 3, size=K).astype(np.int32)
        nodes[5:9] = nodes[0]                  # duplicates
        active = rng.random(K) < 0.8
        rel_j = _j_release(jt, jf, got_j[0], jnp.asarray(nodes), jnp.asarray(active))
        rel_t = tfp.slab_release(tt, tf, got_t[0], _t(nodes), _t(active))
        for a, b, what in zip(rel_j, rel_t, ("slab", "freed", "merged", "logical")):
            _eq(a, b, ("release", trial, what))
        assert int(tfp.slab_free_slots(tt, tf, rel_t[0])) == int(
            jfp.slab_free_slots(jt, jf, rel_j[0]))


def test_slab_bit_31_is_claimed_and_released():
    """Slot 31 (and 63) is bit 31 of its word: int32 with uint32's bits
    sets and clears it exactly as JAX's uint32 words do."""
    jt, tt = _trees(8, "unpacked")
    jf, tf = jfp.FastPathConfig(None, 2), tfp.FastPathConfig(None, 2)
    base = tfp.fp_node_base(tt, tf)
    u = np.array([0x7FFFFFFF, 0xFFFFFFFF], np.uint32)   # only slot 31 free
    tslab, nodes, got, merged, hits = tfp.slab_claim(tt, tf, _t(u.view(np.int32)),
                                                     torch.tensor([False, True, True]))
    jslab, *_ = jfp.slab_claim(jt, jf, jnp.asarray(u), jnp.asarray([False, True, True]))
    _eq(jslab, tslab, "slab")
    assert nodes.tolist() == [0, base + 31, 0] and got.tolist() == [False, True, False]
    assert tslab.tolist() == [-1, -1] and int(merged) == 1 and int(hits) == 1
    # release slots 31 and 63 (bit 31 of both words), slot 63 twice
    rel = torch.tensor([base + 31, base + 63, base + 63])
    tslab2, freed, merged2, logical = tfp.slab_release(tt, tf, tslab, rel, torch.ones(3, dtype=torch.bool))
    jslab2, *_ = jfp.slab_release(jt, jf, jslab, jnp.asarray(rel.numpy()), jnp.ones(3, bool))
    _eq(jslab2, tslab2, "released")
    assert tslab2.tolist() == [0x7FFFFFFF, 0x7FFFFFFF]
    assert freed.tolist() == [True, True, False] and int(merged2) == 2 and int(logical) == 2


# ---------------------------------------------------------------------------
# Pool rounds with the slab, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("S,depth,slab_level", [
    (1, 3, 2), (4, 6, 1), (2, 8, 3), (1, 12, 2),
])
def test_pool_steps_match_jax(layout, S, depth, slab_level):
    """Seeded mixed steps: mostly leaf lanes (slab hits, exhaustion,
    spills into the climb, overflow), frees of live handles with
    duplicates, junk inside the carve and out-of-range shards."""
    jp, tp = _pools(depth, S, layout, slab_level)
    jtr, ttr = _j_empty(jp), tp.empty_trees("cpu")
    rng = np.random.default_rng(S * 100 + depth)
    N = 2 << depth
    K, F = 24, 24
    live = []
    hits = 0
    for step in range(5):
        lv = np.where(rng.random(K) < 0.75, depth,
                      rng.integers(max(1, depth - 3), depth + 1, K)).astype(np.int32)
        act = rng.random(K) < 0.9
        ids = rng.integers(0, 2**31 - 1, K).astype(np.int32)
        take = [live[i] for i in rng.permutation(len(live))[: F - 8]]
        fn = np.zeros(F, np.int32)
        fs = np.zeros(F, np.int32)
        fa = np.zeros(F, bool)
        n = len(take)
        if n:
            fn[:n], fs[:n] = np.array(take).T
        fn[n : n + 4] = rng.integers(0, N, 4)           # junk, carved junk
        fs[n : n + 4] = rng.integers(-1, S + 1, 4)      # out-of-range shards
        fn[n + 4 : n + 6] = [1 << slab_level, 1]        # the carve and the root
        fn[n + 6 : n + 8], fs[n + 6 : n + 8] = fn[:2], fs[:2]   # duplicates
        fa[: n + 8] = True
        j = _j_step(jp, jtr, *(jnp.asarray(a) for a in (fn, fs, fa, lv, act)), 64,
                    jnp.asarray(ids))
        t = tpool.pool_wavefront_step(tp, ttr, *(_t(a) for a in (fn, fs, fa, lv, act)), 64,
                                      _t(ids))
        for a, b, what in zip(j[:4], t[:4], ("trees", "nodes", "shard", "ok")):
            _eq(a, b, (step, what))
        assert set(j[4]) <= set(t[4])
        for k in j[4]:
            assert int(j[4][k]) == int(t[4][k]), (step, k)
        hits += int(t[4]["fastpath_hits"])
        jtr, ttr = j[0], t[0]
        gone = set(zip(fn[fa].tolist(), fs[fa].tolist()))
        live = [h for h in live if h not in gone]
        live += [(int(a), int(b)) for a, b, o in zip(t[1], t[2], t[3]) if o]
        _eq(_j_free_units(jp, jtr), tpool.pool_free_units(tp, ttr), "free_units")
        assert int(_j_largest_run(jp, jtr)) == int(tpool.pool_largest_run(tp, ttr))
    assert hits > 0


# ---------------------------------------------------------------------------
# The port's fastpath pool against an uncarved pool
# ---------------------------------------------------------------------------


def _alloc(pcfg, trees, levels, ids):
    K = len(levels)
    return tpool.pool_wavefront_alloc(
        pcfg, trees, _t(np.asarray(levels, np.int32)), torch.ones(K, dtype=torch.bool), 64,
        _t(np.asarray(ids, np.int32)),
    )


def _free(pcfg, trees, live):
    fn = torch.tensor([n for n, _ in live], dtype=torch.int32)
    fs = torch.tensor([s for _, s in live], dtype=torch.int32)
    return tpool.pool_wavefront_free(pcfg, trees, fn, fs, torch.ones(len(live), dtype=torch.bool))


def _pair(depth, S, layout):
    _, tt = _trees(depth, layout)
    return tpool.PoolConfig(tt, S, fastpath=tfp.FastPathConfig()), tpool.PoolConfig(tt, S)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_leaf_traffic_is_address_identical_to_uncarved(layout, S):
    depth = 5
    fpc, plain = _pair(depth, S, layout)
    ta, tb = fpc.empty_trees("cpu"), plain.empty_trees("cpu")
    rng = np.random.default_rng(S)
    live, hits = [], 0
    for step in range(8):
        K = int(rng.integers(4, 12))
        ids = rng.integers(0, 100, K)
        ta, na, sa, oka, st = _alloc(fpc, ta, [depth] * K, ids)
        tb, nb, sb, okb, _ = _alloc(plain, tb, [depth] * K, ids)
        assert torch.equal(na, nb) and torch.equal(sa, sb) and torch.equal(oka, okb)
        hits += int(st["fastpath_hits"])
        live += [(int(n), int(s)) for n, s, o in zip(na, sa, oka) if o]
        if step % 3 == 2 and live:
            rng.shuffle(live)
            drop, live = live[: len(live) // 2], live[len(live) // 2:]
            ta, fa, _ = _free(fpc, ta, drop)
            tb, fb, _ = _free(plain, tb, drop)
            assert bool(fa.all()) and bool(fb.all())
        assert int(tpool.pool_free_units(fpc, ta).sum()) == int(
            tpool.pool_free_units(plain, tb).sum())
    assert hits > 0
    if live:
        ta, _, _ = _free(fpc, ta, live)
        tb, _, _ = _free(plain, tb, live)
    assert torch.equal(ta, fpc.empty_trees("cpu")) and torch.equal(tb, plain.empty_trees("cpu"))


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mixed_octave_capacity_equality(layout, S):
    """Coarse requests spill around the carve, so addresses may differ,
    but per-lane success and pages outstanding match the uncarved pool
    while coarse demand fits outside the slab."""
    depth = 5
    fpc, plain = _pair(depth, S, layout)
    ta, tb = fpc.empty_trees("cpu"), plain.empty_trees("cpu")
    rng = np.random.default_rng(7 * S)
    live_a, live_b = [], []
    for step in range(10):
        K = int(rng.integers(3, 9))
        lv = [depth if rng.random() < 0.7 else int(rng.integers(3, depth)) for _ in range(K)]
        ids = rng.integers(0, 100, K)
        ta, na, sa, oka, _ = _alloc(fpc, ta, lv, ids)
        tb, nb, sb, okb, _ = _alloc(plain, tb, lv, ids)
        assert torch.equal(oka, okb), step
        live_a += [(int(n), int(s)) for n, s, o in zip(na, sa, oka) if o]
        live_b += [(int(n), int(s)) for n, s, o in zip(nb, sb, okb) if o]
        assert int(tpool.pool_free_units(fpc, ta).sum()) == int(
            tpool.pool_free_units(plain, tb).sum())
        if step % 4 == 3 and live_a:
            idx = set(rng.choice(len(live_a), size=max(1, len(live_a) // 2), replace=False))
            ta, fa, _ = _free(fpc, ta, [h for i, h in enumerate(live_a) if i in idx])
            tb, fb, _ = _free(plain, tb, [h for i, h in enumerate(live_b) if i in idx])
            assert bool(fa.all()) and bool(fb.all())
            live_a = [h for i, h in enumerate(live_a) if i not in idx]
            live_b = [h for i, h in enumerate(live_b) if i not in idx]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_slab_exhaustion_spills_into_the_climb(layout):
    depth = 5
    fpc, _ = _pair(depth, 1, layout)
    n_slots = tfp.fp_n_slots(fpc.tree, fpc.fastpath)
    K = n_slots + 10
    _, nodes, _, ok, stats = _alloc(fpc, fpc.empty_trees("cpu"), [depth] * K, np.arange(K))
    assert bool(ok.all())
    assert int(stats["fastpath_hits"]) == n_slots
    assert int(stats["fastpath_spills"]) == K - n_slots
    assert len(set(nodes.tolist())) == K


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_full_fill_no_aliasing(layout, S):
    depth = 4
    fpc, _ = _pair(depth, S, layout)
    per = 1 << depth
    total = S * per
    trees, nodes, shard, ok, _ = _alloc(fpc, fpc.empty_trees("cpu"), [depth] * total,
                                        np.arange(total))
    assert bool(ok.all())
    pages = sorted(int(s) * per + int(n) - per for n, s in zip(nodes, shard))
    assert pages == list(range(total))
    assert int(tpool.pool_free_units(fpc, trees).sum()) == 0
    _, _, _, ok1, _ = _alloc(fpc, trees, [depth], [0])
    assert not bool(ok1[0])


def test_largest_run_and_free_units_see_the_slab():
    fpc, _ = _pair(4, 1, "unpacked")
    trees = fpc.empty_trees("cpu")
    assert int(tpool.pool_largest_run(fpc, trees)) == 8
    assert int(tpool.pool_free_units(fpc, trees).sum()) == 16
    trees, nodes, _, ok, _ = _alloc(fpc, trees, [4] * 16, np.arange(16))
    assert bool(ok.all()) and int(tpool.pool_largest_run(fpc, trees)) == 0
    trees, freed, _ = _free(fpc, trees, [(int(nodes.min()), 0)])  # a slab page
    assert bool(freed.all())
    assert int(tpool.pool_free_units(fpc, trees).sum()) == 1
    assert int(tpool.pool_largest_run(fpc, trees)) == 1


def test_kernel_sizing_counts_the_slab():
    """Kernel A's workspace and tier count the slab words and their
    scratch (three words per slab word, a rank count per warp of lanes
    and shard); the engine's pools and the depth-14 slab pool stay in
    the shared-memory tier, larger stacks go to device memory."""
    for S, depth, sw in ((1, 12, 32), (4, 10, 8), (1, 14, 128)):
        _, tp = _pools(depth, S, "unpacked")
        assert tp.fp_state_words == sw
        plain = tpool.PoolConfig(tp.tree, S)
        assert nbbs_alloc.smem_bytes(tp, 256) == (
            nbbs_alloc.smem_bytes(plain, 256) + 12 * S * sw + 4 * (256 // 32 + 1) * S)
        assert nbbs_alloc.tier(tp.tree, S, 256, sw) == "shared"
    for S, depth in ((1, 16), (4, 14)):
        _, tp = _pools(depth, S, "unpacked")
        assert nbbs_alloc.tier(tp.tree, S, 256, tp.fp_state_words) == "device"
