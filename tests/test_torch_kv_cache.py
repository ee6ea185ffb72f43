"""The port's paged KV managers against the JAX package's, bit for bit.

`PagedKVManager` (the host-loop engine's run-granularity manager) and
`PageOracle` (the page-granularity oracle of the jit-resident engine) of
`src/repro_torch/memory/kv_cache.py` replay seeded numpy traces beside
their originals in `src/repro/memory/kv_cache.py`, at 1, 2 and 4
shards, with and without the fastpath slab and the magazines: every
return value, block table, shard tree, slab bitmap, magazine stack,
counter and `fragmentation()` must be equal after every op.  Then the
port halves of tests/test_magazine.py's `TestManagerMagazines` and
`TestOracleMagazines`, and burst admission through the port's pool on
the exported `device_pool_config()` (tests/test_serving.py's twin).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pool as jpool
from repro.memory import kv_cache as jkv
from repro_torch.core import layout as tlayout
from repro_torch.core import nbbs as tnbbs
from repro_torch.core import pool as tpool
from repro_torch.memory import kv_cache as tkv
from repro_torch.memory.kv_cache import PageOracle, PagedKVManager

# (n_shards, fastpath, magazines, magazine_refill)
VARIANTS = [
    (1, False, 0, 0), (2, False, 0, 0), (4, False, 0, 0),
    (1, True, 0, 0), (2, True, 0, 0), (4, True, 0, 0),
    (2, False, 4, 0), (4, True, 4, 2),
]
VIDS = [f"S{s}-fp{int(f)}-mag{m}-refill{r}" for s, f, m, r in VARIANTS]


def _mgr_state(kv):
    return dict(
        seqs={i: ([tuple(r) for r in s.runs], s.n_tokens, s.shard) for i, s in kv.seqs.items()},
        trees=[b.tree for b in kv.buddies],
        index=[b.index for b in kv.buddies],
        slab=[f.tolist() for f in kv._slab_free],
        mags=kv._mags,
        frag=kv.fragmentation(),
        free=kv.free_pages(),
    )


def _same_call(fn_j, fn_t):
    """Both calls' results, or both calls' exception types."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(("ok", fn()))
        except (ValueError, KeyError) as e:
            out.append(("raise", type(e).__name__))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("variant", VARIANTS, ids=VIDS)
def test_paged_kv_manager_matches_jax(variant):
    S, fp, mags, refill = variant
    kw = dict(n_shards=S, fastpath=fp, magazines=mags, magazine_refill=refill, mag_lanes=4,
              max_run_pages=16)
    j, t = jkv.PagedKVManager(64, 4, **kw), PagedKVManager(64, 4, **kw)
    assert _mgr_state(t) == _mgr_state(j)
    rng = np.random.default_rng(S * 100 + fp * 10 + mags)
    next_id, live = 0, []
    for _ in range(160):
        r = rng.random()
        if r < 0.4 or not live:
            n_tokens = int(rng.integers(0, 9 if rng.random() < 0.5 else 50))
            n_tokens = n_tokens if rng.random() > 0.03 else 400
            sid = next_id
            got = _same_call(lambda: j.add_sequence(sid, n_tokens),
                             lambda: t.add_sequence(sid, n_tokens))
            if got == ("ok", True):
                live.append(sid)
                next_id += 1
        elif r < 0.7:
            sid = live[int(rng.integers(len(live)))]
            n = int(rng.integers(1, 24))
            assert t.append_tokens(sid, n) == j.append_tokens(sid, n)
        elif r < 0.85:
            sid = live.pop(int(rng.integers(len(live))))
            j.free_sequence(sid)
            t.free_sequence(sid)
        else:
            k = int(rng.integers(1, min(len(live), 4) + 1))
            burst = [live.pop(int(rng.integers(len(live)))) for _ in range(k)]
            if rng.random() < 0.2:
                burst = burst + burst[:1] + [10_000]   # a repeat and an unknown id
            got = _same_call(lambda: j.free_sequences(burst), lambda: t.free_sequences(burst))
            if got[0] == "raise":   # validated first: nothing was released
                live += [i for i in dict.fromkeys(burst) if i in t.seqs]
        if live:
            width = 64
            assert (t.block_tables(live, width) == j.block_tables(live, width)).all()
            assert t.block_tables(live, width).dtype == np.int32
        assert _mgr_state(t) == _mgr_state(j)
    for s in range(S):
        assert t._largest_run_on(s) == j._largest_run_on(s)
        assert t.home_shard(s + 77) == j.home_shard(s + 77)
    if not mags:
        t.free_sequences(list(t.seqs))
        assert t.free_pages() == 64
        for b in t.buddies:
            if not b.max_level:   # the check needs climbs that reach the root
                b.check_invariants()


def test_paged_kv_manager_geometry_errors_match_jax():
    bad = [dict(num_pages=48, page_tokens=4), dict(num_pages=64, page_tokens=4, n_shards=3),
           dict(num_pages=64, page_tokens=4, n_shards=0),
           dict(num_pages=64, page_tokens=4, layout="zip-packed"),
           dict(num_pages=64, page_tokens=4, magazines=-1),
           dict(num_pages=8, page_tokens=4, n_shards=4, fastpath=True, fastpath_slab_level=2)]
    for kw in bad:
        with pytest.raises(ValueError):
            jkv.PagedKVManager(**kw)
        with pytest.raises(ValueError):
            PagedKVManager(**kw)
    kv = PagedKVManager(64, page_tokens=1, n_shards=4)
    with pytest.raises(ValueError):
        kv.add_sequence(1, 17)   # larger than a shard: an error, not "pool full"
    assert 1 not in kv.seqs and kv.free_pages() == 64


def _oracle_state(o):
    return dict(
        trees=[b.tree for b in o.buddies],
        slab=[f.tolist() for f in o._slab_free],
        mag=o.mag,
        counters=(o.fastpath_hits, o.fastpath_spills, o.magazine_hits, o.magazine_spills,
                  o.magazine_refills),
        frag=o.fragmentation(),
        per_shard=o.per_shard_free(),
        free=o.free_pages(),
    )


@pytest.mark.parametrize("variant", VARIANTS, ids=VIDS)
def test_page_oracle_matches_jax(variant):
    S, fp, mags, _ = variant
    kw = dict(n_shards=S, fastpath=fp, magazines=mags, mag_lanes=4 if mags else 0)
    j, t = jkv.PageOracle(32, 4, **kw), PageOracle(32, 4, **kw)
    rng = np.random.default_rng(S * 7 + fp + mags)
    live = []
    for step in range(120):
        if rng.random() < 0.55 or not live:
            K = int(rng.integers(1, 12))
            reqs = [(k, int(rng.integers(0, 2**31 - 1))) for k in range(K)]
            lanes = [int(x) for x in rng.integers(-1, 4, size=K)] if mags else None
            got_j = j.alloc_wavefront(reqs, mag_lanes=lanes)
            got_t = t.alloc_wavefront(reqs, mag_lanes=lanes)
            assert got_t == got_j, step
            live += [p for p in got_t.values() if p is not None]
        else:
            k = int(rng.integers(1, len(live) + 1))
            burst = [live.pop(int(rng.integers(len(live)))) for _ in range(k)]
            if rng.random() < 0.3:
                burst += burst[:2]   # duplicates: stashed once, freed once
            lanes = [int(x) for x in rng.integers(-1, 4, size=len(burst))] if mags else None
            j.free_burst(burst, stash_lanes=lanes)
            t.free_burst(burst, stash_lanes=lanes)
        assert _oracle_state(t) == _oracle_state(j), step
    assert t.home_shard(2**31 - 1) == j.home_shard(2**31 - 1)
    t.free_burst(live)
    t.check_invariants()


def test_largest_free_run_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        j, t = jkv.NBBSRef(256, 1), tkv.NBBSRef(256, 1)
        for _ in range(int(rng.integers(1, 40))):
            size = int(2 ** rng.integers(0, 5))
            assert t.nb_alloc(size, scattered=True) == j.nb_alloc(size, scattered=True)
        for probe in (1, 8, 64, 256):
            assert tkv._largest_free_run(t, probe) == jkv._largest_free_run(j, probe)
        assert [tkv._occupied_ancestor(t, n) for n in range(1, 512)] == [
            jkv._occupied_ancestor(j, n) for n in range(1, 512)]


# ---------------------------------------------------------------------------
# The port halves of tests/test_magazine.py's manager and oracle classes
# ---------------------------------------------------------------------------


class TestManagerMagazines:
    """Host mirror: PagedKVManager with per-(lane,shard) magazines."""

    def test_recycle_hit_and_conservation(self):
        kv = PagedKVManager(
            64, 16, n_shards=2, fastpath=True, magazines=4, mag_lanes=4
        )
        assert kv.add_sequence(7, 16)
        kv.free_sequence(7)
        assert kv.mag_stashed() == 1
        assert kv.free_pages() == 64  # stashed page counts as free
        assert kv.add_sequence(7, 16)
        assert kv.magazine_hits == 1
        assert kv.mag_stashed() == 0
        frag = kv.fragmentation()
        for key in ("magazine_hits", "magazine_spills",
                    "magazine_refills", "magazine_stashed"):
            assert key in frag

    def test_append_rollback_mirrors_pr1_leak_test(self):
        kv = PagedKVManager(16, 1, max_run_pages=2, magazines=4, mag_lanes=2)
        assert kv.add_sequence(1, 2)
        assert kv.add_sequence(2, 8)
        assert kv.add_sequence(3, 4)
        assert kv.free_pages() == 2
        assert not kv.append_tokens(1, 6)
        s = kv.seqs[1]
        assert s.n_tokens == 2 and s.n_pages == 2
        assert kv.free_pages() == 2
        kv.free_sequence(2)
        kv.free_sequence(3)
        assert kv.append_tokens(1, 6)

    def test_rollback_returns_magazine_page_to_same_lane(self):
        kv = PagedKVManager(4, 1, max_run_pages=1, magazines=4, mag_lanes=1)
        assert kv.add_sequence(0, 1)
        assert kv.add_sequence(1, 1)
        assert kv.add_sequence(2, 1)
        kv.free_sequence(2)             # parks one page in lane 0's mag
        assert kv.mag_stashed() == 1
        stashed_page = kv._mags[0][0][-1]
        free_before = kv.free_pages()
        # grow needs 3 pages: magazine pop + tree page, then failure
        assert not kv.append_tokens(0, 3)
        assert kv.seqs[0].n_tokens == 1 and kv.seqs[0].n_pages == 1
        assert kv.free_pages() == free_before
        assert stashed_page in kv._mags[0][0]  # back on its own lane
        assert kv.mag_stashed() == 2
        kv.free_sequence(0)
        kv.free_sequence(1)
        assert kv.free_pages() == 4
        assert kv.add_sequence(9, 4)  # full capacity reclaimable

    def test_admission_spills_magazines_when_full(self):
        kv = PagedKVManager(4, 1, max_run_pages=1, magazines=4, mag_lanes=2)
        for i in range(4):
            assert kv.add_sequence(i, 1)
        kv.free_sequences([0, 1, 2, 3])
        assert kv.mag_stashed() == 4  # all capacity parked
        assert kv.add_sequence(8, 4)  # lane 0: 2 pops, then spill-retry
        assert kv.magazine_hits == 2
        assert kv.magazine_spills >= 2
        assert kv.mag_stashed() == 0
        assert kv.free_pages() == 0

    def test_device_pool_config_threads_magazines(self):
        kv = PagedKVManager(64, 16, n_shards=2, magazines=4, magazine_refill=2)
        pcfg = kv.device_pool_config()
        assert isinstance(pcfg, tpool.PoolConfig)
        assert pcfg.magazines is not None
        assert pcfg.magazines.mag_cap == 4
        assert pcfg.magazines.refill_batch == 2
        assert PagedKVManager(64, 16).device_pool_config().magazines is None


class TestOracleMagazines:
    """PageOracle mirrors the device claim/stash/spill exactly."""

    def test_claim_stash_lifo_and_duplicates(self):
        o = PageOracle(16, 16, magazines=4, mag_lanes=2)
        got = o.alloc_wavefront(
            [(k, k) for k in range(4)], mag_lanes=[0, 0, 1, 1]
        )
        pages = [got[k] for k in range(4)]
        o.free_burst(pages, stash_lanes=[0, 0, 1, 1])
        assert o.mag_stashed() == 4
        assert o.free_pages() == 16
        # duplicate instances: stash once, never double-free
        o2 = PageOracle(16, 16, magazines=4, mag_lanes=2)
        g = o2.alloc_wavefront([(0, 0)], mag_lanes=[0])
        p = g[0]
        o2.free_burst([p, p, p], stash_lanes=[0, 1, -1])
        assert o2.mag_stashed() == 1
        assert o2.free_pages() == 16
        o2.check_invariants()

    def test_exhaustion_spill_back(self):
        o = PageOracle(8, 16, magazines=8, mag_lanes=1)
        got = o.alloc_wavefront(
            [(k, k) for k in range(8)], mag_lanes=[0] * 8
        )
        o.free_burst(list(got.values()), stash_lanes=[0] * 8)
        assert o.mag_stashed() == 8
        got2 = o.alloc_wavefront([(k, 50 + k) for k in range(4)])
        assert all(v is not None for v in got2.values())
        assert o.magazine_spills == 8
        assert o.mag_stashed() == 0


# ---------------------------------------------------------------------------
# The exported device pool config (tests/test_serving.py::TestLayoutKnob)
# ---------------------------------------------------------------------------


def test_kv_manager_exports_device_pool_config():
    kv = PagedKVManager(256, 16, n_shards=4)
    pcfg = kv.device_pool_config()
    jcfg = jkv.PagedKVManager(256, 16, n_shards=4).device_pool_config()
    assert isinstance(pcfg.tree.layout, tlayout.Unpacked)
    assert (pcfg.n_shards, pcfg.total_units, pcfg.tree.depth, pcfg.tree.max_level) == (
        jcfg.n_shards, jcfg.total_units, jcfg.tree.depth, jcfg.tree.max_level)
    kvp = PagedKVManager(256, 16, n_shards=4, layout="bunch-packed")
    pp = kvp.device_pool_config()
    assert isinstance(pp.tree.layout, tlayout.BunchPacked)
    assert pp.tree.depth == pcfg.tree.depth
    assert pp.n_state_words * 4 <= pcfg.n_state_words
    assert kvp.add_sequence(1, 64)
    assert kv.add_sequence(1, 64)
    assert kv.seqs[1].runs == kvp.seqs[1].runs
    fp = PagedKVManager(256, 16, n_shards=2, fastpath=True).device_pool_config()
    jfp = jkv.PagedKVManager(256, 16, n_shards=2, fastpath=True).device_pool_config()
    assert fp.n_state_words == jfp.n_state_words
    assert fp.fastpath.slab_level == jfp.fastpath.slab_level


@pytest.mark.parametrize("layout", ["unpacked", "bunch-packed"])
def test_device_admission_on_exported_config_matches_host(layout):
    """Burst admission through the port's pool on the exported config
    returns JAX's (shard, page) handles in both layouts; and one chunk
    per sequence through `nb_pool_alloc` (kernel A on the card) admits
    the pages the host manager admits."""
    kv_u = jkv.PagedKVManager(128, 16, n_shards=2)
    kv_t = PagedKVManager(128, 16, n_shards=2, layout=layout)
    pu, pt = kv_u.device_pool_config(), kv_t.device_pool_config()
    K = 8
    lv = np.full(K, pu.tree.depth - 1, np.int32)  # 2-page runs
    ids = np.arange(K, dtype=np.int32)
    tu, nu, su, oku, _ = jpool.pool_wavefront_alloc(
        pu, pu.empty_trees(), jnp.asarray(lv), jnp.ones(K, bool), 64, jnp.asarray(ids))
    tt, nt, st, okt, _ = tpool.pool_wavefront_alloc(
        pt, pt.empty_trees("cpu"), torch.from_numpy(lv), torch.ones(K, dtype=torch.bool), 64,
        torch.from_numpy(ids))
    assert nt.tolist() == np.asarray(nu).tolist()
    assert st.tolist() == np.asarray(su).tolist()
    assert bool(oku.all()) and bool(okt.all())

    host = PagedKVManager(64, 4, n_shards=2, layout=layout, max_run_pages=8)
    pcfg = host.device_pool_config()
    state = tnbbs.init_pool_state(pcfg, "cpu")
    rng = np.random.default_rng(5)
    for sid in range(24):
        pages = int(2 ** rng.integers(0, 4))
        ok_host = host.add_sequence(sid, pages * 4)
        level = pcfg.tree.depth - (pages.bit_length() - 1)
        state, shard, off, ok = tnbbs.nb_pool_alloc(pcfg, state, level, lane_id=sid)
        assert bool(ok) == ok_host, sid
        if ok_host:
            s = host.seqs[sid]
            assert (int(shard), int(off)) == (s.shard, s.runs[0].start
                                               - s.shard * host.pages_per_shard), sid
