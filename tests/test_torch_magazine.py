"""The port's per-lane magazines against the JAX package, bit for bit.

`core/magazine.py` (config, LIFO claim and stash, drop-through,
underflow, `group_rank`) and the magazine half of `core/pool.py` (both
forms of the stash phase, the `*_mag` pool steps with and without the
fastpath, exhaustion spill-back, unowned and duplicate handles, refill
and drain) get the same seeded numpy inputs as the JAX modules; trees,
magazine pages and depths, nodes, shards, ok masks and every stat slot
must be identical.  The card's magazine path (`ops._pool_step_mag`:
one claim ahead of kernel A, then the masked spill-back and retry
launch) runs here on CPU tensors, where its launches take the plain
pool step, and is held against JAX's `pool_wavefront_step_mag` too.
Last, the port's plain path reproduces every counter of
`BENCH_FASTPATH.json` and `BENCH_MAGAZINE.json`.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import concurrent as jconc
from repro.core import fastpath as jfp
from repro.core import magazine as jmag
from repro.core import nbbs_jax as jnbbs
from repro.core import pool as jpool
from repro_torch.core import concurrent as tconc
from repro_torch.core import fastpath as tfp
from repro_torch.core import magazine as tmag
from repro_torch.core import nbbs as tnbbs
from repro_torch.core import pool as tpool
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = ["unpacked", "bunch-packed"]

_j_step_mag = jax.jit(jpool.pool_wavefront_step_mag, static_argnums=(0, 8))
_j_stash = jax.jit(jpool._mag_stash_phase, static_argnums=(0, 8))
_j_alloc_mag = jax.jit(jnbbs.nb_pool_alloc_pages_mag, static_argnums=(0, 5))
_j_free_mag = jax.jit(jnbbs.nb_pool_free_pages_mag, static_argnums=(0, 8))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _eq(a, b, what):
    """Equal 32-bit patterns (JAX's uint32 words against int32)."""
    a, b = np.asarray(a), np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    mask = 0xFFFFFFFF
    assert ((a.astype(np.int64) & mask) == (b.astype(np.int64) & mask)).all(), what


def _eq_mags(jm, tm, what):
    _eq(jm.pages, tm.pages, (what, "pages"))
    _eq(jm.depth, tm.depth, (what, "depth"))


def _eq_stats(js, ts, what):
    assert set(js) <= set(ts), (what, set(js) - set(ts))
    for k in js:
        assert int(js[k]) == int(ts[k]), (what, k, int(js[k]), int(ts[k]))


def _pools(depth, S, layout, fastpath=False, mag_cap=4, refill=0):
    packed = layout == "bunch-packed"
    jt = jconc.TreeConfig(depth=depth, layout=jconc.BUNCH_PACKED if packed else jconc.UNPACKED)
    tt = tconc.TreeConfig(depth=depth, layout=tconc.BUNCH_PACKED if packed else tconc.UNPACKED)
    return (
        jpool.PoolConfig(jt, S, fastpath=jfp.FastPathConfig() if fastpath else None,
                         magazines=jmag.MagazineConfig(mag_cap, refill)),
        tpool.PoolConfig(tt, S, fastpath=tfp.FastPathConfig() if fastpath else None,
                         magazines=tmag.MagazineConfig(mag_cap, refill)),
    )


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mag_cap,refill", [(0, 0), (-2, 0), (4, -1), (1, 0), (8, 3)])
def test_config_validation_matches_jax(mag_cap, refill):
    outcomes = []
    for mod in (jmag, tmag):
        try:
            mod.MagazineConfig(mag_cap, refill).validate()
            outcomes.append("ok")
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]
    if outcomes[1] == "ok":
        mags = tmag.init_magazines(tmag.MagazineConfig(mag_cap, refill), 5, "cpu")
        assert tuple(mags.pages.shape) == (5, mag_cap) and (mags.pages == -1).all()
        assert int(tmag.mag_total(mags)) == 0


def test_lifo_claim_and_stash():
    mcfg = tmag.MagazineConfig(mag_cap=4)
    mags = tmag.init_magazines(mcfg, 2, "cpu")
    mags, stashed = tmag.mag_stash(mcfg, mags, torch.tensor([10, 11, 20, 21]),
                                   torch.ones(4, dtype=torch.bool), torch.tensor([0, 0, 1, 1]))
    assert stashed.all() and mags.depth.tolist() == [2, 2]
    assert mags.pages[0, :2].tolist() == [10, 11]
    mags, pages, got, hits = tmag.mag_claim(mcfg, mags, torch.ones(3, dtype=torch.bool),
                                            torch.tensor([0, 0, 1]))
    assert int(hits) == 3 and pages.tolist() == [11, 10, 21]
    assert mags.depth.tolist() == [0, 1] and int(mags.pages[1, 0]) == 20


def test_stash_drop_through_and_claim_underflow():
    mcfg = tmag.MagazineConfig(mag_cap=2)
    mags = tmag.init_magazines(mcfg, 1, "cpu")
    mags, stashed = tmag.mag_stash(mcfg, mags, torch.tensor([1, 2, 3]),
                                   torch.ones(3, dtype=torch.bool), torch.zeros(3, dtype=torch.int32))
    assert stashed.tolist() == [True, True, False] and int(mags.depth[0]) == 2
    mags, pages, got, hits = tmag.mag_claim(mcfg, mags, torch.ones(3, dtype=torch.bool),
                                            torch.zeros(3, dtype=torch.int32))
    assert got.tolist() == [True, True, False] and pages.tolist() == [2, 1, -1]
    assert int(hits) == 2 and int(mags.depth[0]) == 0


@pytest.mark.parametrize("seed", range(4))
def test_group_rank_and_ops_match_jax(seed):
    rng = np.random.default_rng(seed)
    K, L, C = 48, 7, 3
    keys = rng.integers(-2, L + 2, K).astype(np.int32)
    cand = rng.random(K) < 0.7
    _eq(jmag.group_rank(jnp.asarray(keys), jnp.asarray(cand), L),
        tmag.group_rank(_t(keys), _t(cand), L), "group_rank")
    jcfg, tcfg = jmag.MagazineConfig(C), tmag.MagazineConfig(C)
    jm, tm = jmag.init_magazines(jcfg, L), tmag.init_magazines(tcfg, L, "cpu")
    for step in range(4):
        pages = rng.integers(0, 1000, K).astype(np.int32)
        want = rng.random(K) < 0.6
        jm, js = jmag.mag_stash(jcfg, jm, jnp.asarray(pages), jnp.asarray(want), jnp.asarray(keys))
        tm, ts = tmag.mag_stash(tcfg, tm, _t(pages), _t(want), _t(keys))
        _eq_mags(jm, tm, ("stash", step))
        _eq(js, ts, "stashed")
        want = rng.random(K) < 0.5
        ja = jmag.mag_claim(jcfg, jm, jnp.asarray(want), jnp.asarray(keys))
        ta = tmag.mag_claim(tcfg, tm, _t(want), _t(keys))
        _eq_mags(ja[0], ta[0], ("claim", step))
        for a, b, what in zip(ja[1:], ta[1:], ("pages", "got", "hits")):
            _eq(a, b, (what, step))
        jm, tm = ja[0], ta[0]
    _eq(jmag.mag_free_per_shard(jm, 3, 300), tmag.mag_free_per_shard(tm, 3, 300), "per_shard")


def test_precomputed_rank_matches_group_rank():
    """The engine's fast paths: a caller-computed rank (column index on
    a lane-major block table, zeros for distinct lanes) gives the same
    result as the sort."""
    mcfg = tmag.MagazineConfig(mag_cap=4)
    B, MP = 8, 4
    mags = tmag.init_magazines(mcfg, B, "cpu")
    lane = torch.arange(B).repeat_interleave(MP)
    pages = torch.arange(B * MP, dtype=torch.int32)
    cand = (torch.arange(B * MP) % MP) < 2
    rank = torch.arange(MP, dtype=torch.int32).repeat(B)
    m1, s1 = tmag.mag_stash(mcfg, mags, pages, cand, lane)
    m2, s2 = tmag.mag_stash(mcfg, mags, pages, cand, lane, rank=rank)
    assert torch.equal(s1, s2) and torch.equal(m1.pages, m2.pages) and torch.equal(m1.depth, m2.depth)
    want, ml = torch.ones(B, dtype=torch.bool), torch.arange(B)
    a1 = tmag.mag_claim(mcfg, m1, want, ml)
    a2 = tmag.mag_claim(mcfg, m1, want, ml, rank=torch.zeros(B, dtype=torch.int32))
    for x, y in zip([*a1[0], *a1[1:]], [*a2[0], *a2[1:]]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Pool magazine steps against JAX
# ---------------------------------------------------------------------------


def _churn_arrays(rng, live, depth, S, L, K, F):
    lv = np.where(rng.random(K) < 0.8, depth, rng.integers(1, depth + 1, K)).astype(np.int32)
    act = rng.random(K) < 0.9
    ids = rng.integers(0, 1000, K).astype(np.int32)
    take = [live[i] for i in rng.permutation(len(live))[: F - 4]]
    fn, fs = np.zeros(F, np.int32), np.zeros(F, np.int32)
    n = len(take)
    if n:
        fn[:n], fs[:n] = np.array(take).T
        fn[n : n + 2], fs[n : n + 2] = fn[0], fs[0]          # duplicates
    fn[n + 2 : n + 4] = rng.integers(0, 2 << depth, 2)      # junk / unowned
    fs[n + 2 : n + 4] = rng.integers(-1, S + 1, 2)
    fa = np.arange(F) < n + 4
    fl = rng.integers(-1, L, F).astype(np.int32)
    al = rng.integers(-1, L, K).astype(np.int32)
    return fn, fs, fa, lv, act, ids, fl, al


@pytest.mark.parametrize("S,layout,fastpath", [
    (1, "unpacked", False), (1, "bunch-packed", True), (2, "unpacked", True),
    (2, "bunch-packed", False), (4, "unpacked", False), (4, "bunch-packed", True),
])
def test_pool_mag_steps_match_jax(S, layout, fastpath):
    """Mixed churn through `pool_wavefront_step_mag` (the plain version)
    and through the card path on CPU tensors, both against JAX:
    stashes, drop-throughs, claims shared by several lanes, exhaustion
    spill-backs, junk and duplicate handles."""
    depth = 5 if S < 4 else 4
    jp, tp = _pools(depth, S, layout, fastpath, mag_cap=3)
    L, K, F = 6, 20, 20
    jst = (jpool.PoolConfig.empty_trees(jp), jpool.pool_init_magazines(jp, L))
    pst = (tp.empty_trees("cpu"), tpool.pool_init_magazines(tp, L, "cpu"))
    dst = pst
    rng = np.random.default_rng(S * 10 + depth + fastpath)
    live, spills, hits = [], 0, 0
    for step in range(8):
        arrays = _churn_arrays(rng, live, depth, S, L, K, F)
        fn, fs, fa, lv, act, ids, fl, al = arrays
        j = _j_step_mag(jp, *jst, *(jnp.asarray(a) for a in (fn, fs, fa, lv, act)), 64,
                        jnp.asarray(ids), jnp.asarray(fl), jnp.asarray(al))
        ta = [_t(a) for a in arrays]
        p = tpool.pool_wavefront_step_mag(tp, *pst, *ta[:5], 64, *ta[5:])
        d = tops._pool_step_mag(tp, *dst, *ta[:5], 64, *ta[5:], None, None, False)
        for r, name in ((p, "plain"), (d, "card path")):
            _eq(j[0], r[0], (name, step, "trees"))
            _eq_mags(j[1], r[1], (name, step))
            for a, b, what in zip(j[2:5], r[2:5], ("nodes", "shard", "ok")):
                _eq(a, b, (name, step, what))
            _eq_stats(j[5], r[5], (name, step))
        spills += int(p[5]["magazine_spills"])
        hits += int(p[5]["magazine_hits"])
        jst, pst, dst = (j[0], j[1]), (p[0], p[1]), (d[0], d[1])
        gone = set(zip(fn[fa].tolist(), fs[fa].tolist()))
        live = [h for h in live if h not in gone]
        live += [(int(a), int(b)) for a, b, o in zip(p[2], p[3], p[4]) if o]
    assert hits > 0 and spills > 0


@pytest.mark.parametrize("fastpath", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_stash_phase_forms_match_jax(layout, fastpath):
    """Both forms of the stash pre-pass against JAX: the generic one
    (ownership and dedup predicates) on a burst with unowned, junk and
    duplicate handles, and `assume_owned` with a column rank on a
    lane-major burst of distinct owned pages."""
    depth, S, L = 5, 2, 4
    jp, tp = _pools(depth, S, layout, fastpath, mag_cap=3)
    K = 16
    lv = np.full(K, depth, np.int32)
    ids = np.arange(K, dtype=np.int32)
    z = np.zeros(0, np.int32)
    jtr, jm = jpool.PoolConfig.empty_trees(jp), jpool.pool_init_magazines(jp, L)
    ttr, tm = tp.empty_trees("cpu"), tpool.pool_init_magazines(tp, L, "cpu")
    jtr, jm, nodes, shard, ok, _ = _j_step_mag(
        jp, jtr, jm, jnp.asarray(z), jnp.asarray(z), jnp.asarray(z, bool), jnp.asarray(lv),
        jnp.ones(K, bool), 64, jnp.asarray(ids))
    ttr, tm, tn, ts, tok, _ = tpool.pool_wavefront_step_mag(
        tp, ttr, tm, _t(z), _t(z), _t(np.zeros(0, bool)), _t(lv), torch.ones(K, dtype=torch.bool),
        64, _t(ids))
    _eq(jtr, ttr, "trees")
    nodes, shard = np.asarray(nodes), np.asarray(shard)
    lane = (np.arange(K) // (K // L)).astype(np.int32)
    rank = (np.arange(K) % (K // L)).astype(np.int32)
    act = np.asarray(ok) & (np.arange(K) % 3 != 1)
    for owned in (True, False):
        fn, fsh, fa = nodes.copy(), shard.copy(), act.copy()
        r = rank
        if not owned:
            fn[1], fn[2], fsh[3] = fn[0], 2, S + 1          # duplicate, junk, bad shard
            fn[4] = (1 << depth) + (1 << depth) - 1        # maybe unowned
            r = None
        jr = _j_stash(jp, jtr, jm, jnp.asarray(fn), jnp.asarray(fsh), jnp.asarray(fa),
                      jnp.asarray(lane), None if r is None else jnp.asarray(r), owned)
        tr = tpool._mag_stash_phase(tp, ttr, tm, _t(fn), _t(fsh), _t(fa), _t(lane),
                                    mag_rank=None if r is None else _t(r), assume_owned=owned)
        _eq_mags(jr[0], tr[0], owned)
        for a, b, what in zip(jr[1:], tr[1:], ("active_out", "stashed", "spills")):
            _eq(a, b, (owned, what))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_exhaustion_spills_magazines_back(layout):
    """All free capacity parked in one magazine: a magazine-less lane is
    served by the spill-back and retry, on the plain path and through
    the card path, as in JAX."""
    jp, tp = _pools(3, 1, layout, mag_cap=8)
    K = 8
    tr, tm = tp.empty_trees("cpu"), tpool.pool_init_magazines(tp, 1, "cpu")
    tr, tm, nodes, shard, ok, _ = tpool.pool_wavefront_alloc_mag(
        tp, tr, tm, torch.full((K,), 3), torch.ones(K, dtype=torch.bool), 64, None,
        torch.zeros(K, dtype=torch.int32))
    assert bool(ok.all())
    tr, tm, _, _ = tpool.pool_wavefront_free_mag(tp, tr, tm, nodes, shard, ok,
                                                 torch.zeros(K, dtype=torch.int32))
    assert int(tmag.mag_total(tm)) == K and int(tpool.pool_free_units(tp, tr).sum()) == 0
    lv, act = torch.full((4,), 3), torch.ones(4, dtype=torch.bool)
    none = torch.zeros(0, dtype=torch.int32)
    for out in (
        tpool.pool_wavefront_alloc_mag(tp, tr, tm, lv, act, 64, None, torch.full((4,), -1)),
        tops._pool_step_mag(tp, tr, tm, none, none, none.bool(), lv, act, 64,
                            torch.arange(4, dtype=torch.int32), None, None, None, None, False),
    ):
        assert bool(out[4].all())
        assert int(out[5]["magazine_hits"]) == 0 and int(out[5]["magazine_spills"]) == K
        assert int(tmag.mag_total(out[1])) == 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_unowned_and_duplicate_handles(layout):
    _, tp = _pools(4, 2, layout)
    tr, tm = tp.empty_trees("cpu"), tpool.pool_init_magazines(tp, 4, "cpu")
    total = int(tpool.pool_free_units(tp, tr).sum())
    lo = 1 << tp.tree.depth
    # never-allocated leaf, out-of-range node, junk shard: nothing stashes
    tr2, tm2, _, _ = tpool.pool_wavefront_free_mag(
        tp, tr, tm, torch.tensor([lo + 3, 2, lo + 1]), torch.tensor([0, 0, 9]),
        torch.ones(3, dtype=torch.bool), torch.zeros(3, dtype=torch.int32))
    assert int(tmag.mag_total(tm2)) == 0 and int(tpool.pool_free_units(tp, tr2).sum()) == total
    # duplicates of one page in a burst stash once and never also free
    tr, tm, nodes, shard, ok, _ = tpool.pool_wavefront_alloc_mag(
        tp, tr, tm, torch.full((2,), 4), torch.ones(2, dtype=torch.bool), 64, None,
        torch.tensor([0, 1]))
    burst = torch.tensor([int(nodes[0])] * 3 + [int(nodes[1])])
    bshard = torch.tensor([int(shard[0])] * 3 + [int(shard[1])])
    tr, tm, _, _ = tpool.pool_wavefront_free_mag(
        tp, tr, tm, burst, bshard, torch.ones(4, dtype=torch.bool), torch.tensor([0, 1, 2, 3]))
    assert int(tmag.mag_total(tm)) == 2
    assert int(tpool.pool_free_units(tp, tr).sum()) + int(tmag.mag_total(tm)) == total


@pytest.mark.parametrize("fastpath", [False, True])
def test_refill_and_drain_match_jax(fastpath):
    jp, tp = _pools(4, 2, "unpacked", fastpath, mag_cap=4, refill=2)
    jtr, jm = jpool.PoolConfig.empty_trees(jp), jpool.pool_init_magazines(jp, 3)
    ttr, tm = tp.empty_trees("cpu"), tpool.pool_init_magazines(tp, 3, "cpu")
    for want in ([True, True, True], [True, False, False], [True, True, False]):
        jtr, jm, js = jpool.pool_magazine_refill(jp, jtr, jm, jnp.asarray(want))
        ttr, tm, ts = tpool.pool_magazine_refill(tp, ttr, tm, torch.tensor(want))
        _eq(jtr, ttr, "trees")
        _eq_mags(jm, tm, "refill")
        _eq_stats(js, ts, "refill")
    assert tm.depth.tolist() == [4, 4, 2]
    jtr, jm, js = jpool.pool_magazine_drain(jp, jtr, jm)
    ttr, tm, ts = tpool.pool_magazine_drain(tp, ttr, tm)
    _eq(jtr, ttr, "drained trees")
    _eq_mags(jm, tm, "drain")
    _eq_stats(js, ts, "drain")
    assert torch.equal(ttr, tp.empty_trees("cpu"))
    with pytest.raises(ValueError):
        _, tp0 = _pools(4, 1, "unpacked", refill=0)
        tpool.pool_magazine_refill(tp0, tp0.empty_trees("cpu"),
                                   tpool.pool_init_magazines(tp0, 1, "cpu"), torch.ones(1, dtype=torch.bool))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_page_calls_match_jax(layout):
    """`nb_pool_alloc_pages_mag` / `nb_pool_free_pages_mag` against
    nbbs_jax, with the engine's zero rank, column rank and
    `assume_owned` retirement burst."""
    jp, tp = _pools(5, 2, layout, fastpath=True, mag_cap=2)
    B, MP = 6, 3
    jtr, jm = jpool.PoolConfig.empty_trees(jp), jpool.pool_init_magazines(jp, B)
    ttr, tm = tp.empty_trees("cpu"), tpool.pool_init_magazines(tp, B, "cpu")
    rng = np.random.default_rng(3)
    jtab = np.full((B, MP), -1, np.int32), np.full((B, MP), -1, np.int32)
    for step in range(8):
        need = rng.random(B) < 0.7
        seq = rng.integers(0, 50, B).astype(np.int32)
        j = _j_alloc_mag(jp, jtr, jm, jnp.asarray(need), jnp.asarray(seq), 64,
                         jnp.arange(B, dtype=jnp.int32), jnp.zeros(B, jnp.int32))
        t = tnbbs.nb_pool_alloc_pages_mag(tp, ttr, tm, _t(need), _t(seq), 64,
                                          mag_lane=torch.arange(B),
                                          mag_rank=torch.zeros(B, dtype=torch.int32))
        _eq(j[0], t[0], (step, "trees"))
        _eq_mags(j[1], t[1], step)
        for a, b, what in zip(j[2:5], t[2:5], ("shard", "off", "ok")):
            _eq(a, b, (step, what))
        _eq_stats(j[5], t[5], step)
        jtr, jm, ttr, tm = j[0], j[1], t[0], t[1]
        sh, off, ok = (np.asarray(x) for x in j[2:5])
        col = (jtab[0] >= 0).sum(axis=1)
        for b in np.nonzero(ok & (col < MP))[0]:
            jtab[0][b, col[b]], jtab[1][b, col[b]] = sh[b], off[b]
        retire = rng.random(B) < 0.4
        f_act = (retire[:, None] & (jtab[0] >= 0)).reshape(-1)
        lane = np.repeat(np.arange(B, dtype=np.int32), MP)
        rank = np.tile(np.arange(MP, dtype=np.int32), B)
        j = _j_free_mag(jp, jtr, jm, jnp.asarray(jtab[0].reshape(-1)),
                        jnp.asarray(jtab[1].reshape(-1)), jnp.asarray(f_act), jnp.asarray(lane),
                        jnp.asarray(rank), True)
        t = tnbbs.nb_pool_free_pages_mag(tp, ttr, tm, _t(jtab[0].reshape(-1)),
                                         _t(jtab[1].reshape(-1)), _t(f_act), mag_lane=_t(lane),
                                         mag_rank=_t(rank), assume_owned=True)
        _eq(j[0], t[0], (step, "freed trees"))
        _eq_mags(j[1], t[1], ("free", step))
        _eq(j[2], t[2], (step, "freed"))
        _eq_stats(j[3], t[3], ("free", step))
        jtr, jm, ttr, tm = j[0], j[1], t[0], t[1]
        jtab[0][retire], jtab[1][retire] = -1, -1


# ---------------------------------------------------------------------------
# The committed benchmark counters, reproduced by the port's plain path
# ---------------------------------------------------------------------------


def _records(name):
    return json.loads((ROOT / name).read_text())["records"]


def test_bench_fastpath_counters_reproduced():
    """`bench_constant_occupancy.fastpath_sweep`'s churn (depth 8, 16
    steps, W = S*2^8/8 leaf lanes) on the port: every counter equal."""
    for rec in _records("BENCH_FASTPATH.json"):
        d, want = rec["dims"], rec["metrics"]
        S, depth, W, churn = d["n_shards"], d["depth"], d["width"], d["churn_steps"]
        fp = tfp.FastPathConfig(level=None, slab_level=2) if d["fastpath"] else None
        pcfg = tpool.PoolConfig(tconc.TreeConfig(depth=depth), S, fastpath=fp)
        levels = torch.full((W,), depth, dtype=torch.int32)
        active = torch.ones(W, dtype=torch.bool)
        zeros = torch.zeros(W, dtype=torch.int32)
        trees, nodes, shard, ok, _ = tpool.pool_wavefront_step(
            pcfg, pcfg.empty_trees("cpu"), zeros, zeros, zeros.bool(), levels, active)
        tot = dict.fromkeys(("merged_writes", "logical_rmws", "free_merged_writes",
                             "free_logical_rmws", "fastpath_hits", "fastpath_spills"), 0)
        for _ in range(churn):
            trees, nodes, shard, ok, st = tpool.pool_wavefront_step(
                pcfg, trees, nodes, shard, ok, levels, active)
            for k in tot:
                tot[k] += int(st[k])
        assert bool(ok.all())
        for k, v in tot.items():
            assert v == want[k], (d, k, v, want[k])
        ops = churn * W
        assert (tot["merged_writes"] + tot["free_merged_writes"]) / ops == want["merged_per_op"]
        assert tot["logical_rmws"] / ops == want["logical_per_alloc"]


def test_bench_magazine_counters_reproduced():
    """`bench_constant_occupancy.magazine_sweep`'s churn (16 leaf lanes,
    four per magazine, depth 8, 16 steps) on the port: every counter
    equal, through the plain step and through the card path."""
    for rec in _records("BENCH_MAGAZINE.json"):
        d, want = rec["dims"], rec["metrics"]
        cap, S, depth, W, churn = (d["mag_cap"], d["n_shards"], d["depth"], d["width"],
                                   d["churn_steps"])
        L = W // d["lanes_per_mag"]
        mcfg = tmag.MagazineConfig(mag_cap=cap) if cap else None
        pcfg = tpool.PoolConfig(tconc.TreeConfig(depth=depth), S, magazines=mcfg)
        levels = torch.full((W,), depth, dtype=torch.int32)
        active = torch.ones(W, dtype=torch.bool)
        zeros = torch.zeros(W, dtype=torch.int32)
        mag_lane = torch.arange(W, dtype=torch.int32) % L
        for step_fn in ((tpool.pool_wavefront_step_mag, tops._pool_step_mag) if cap else (None,)):
            tot = dict.fromkeys(("logical_rmws", "free_logical_rmws", "magazine_hits",
                                 "magazine_spills"), 0)
            if cap:
                mags = tpool.pool_init_magazines(pcfg, L, "cpu")
                trees, mags, nodes, shard, ok, _ = tpool.pool_wavefront_step_mag(
                    pcfg, pcfg.empty_trees("cpu"), mags, zeros, zeros, zeros.bool(), levels,
                    active)
                ids = torch.arange(W, dtype=torch.int32)
                for _ in range(churn):
                    args = (pcfg, trees, mags, nodes, shard, ok, levels, active, 64, ids,
                            mag_lane, mag_lane)
                    if step_fn is tops._pool_step_mag:
                        args += (None, None, False)
                    trees, mags, nodes, shard, ok, st = step_fn(*args)
                    for k in tot:
                        tot[k] += int(st[k])
            else:
                trees, nodes, shard, ok, _ = tpool.pool_wavefront_step(
                    pcfg, pcfg.empty_trees("cpu"), zeros, zeros, zeros.bool(), levels, active)
                for _ in range(churn):
                    trees, nodes, shard, ok, st = tpool.pool_wavefront_step(
                        pcfg, trees, nodes, shard, ok, levels, active)
                    tot["logical_rmws"] += int(st["logical_rmws"])
                    tot["free_logical_rmws"] += int(st["free_logical_rmws"])
            assert bool(ok.all())
            for k, v in tot.items():
                assert v == want[k], (d, step_fn, k, v, want[k])
            rmws = (tot["logical_rmws"] + tot["free_logical_rmws"]) / (2 * churn * W)
            assert rmws == want["rmws_per_op"]
