"""The port's rounds and pool in the `BunchPacked` layout against the
JAX package, bit for bit.

Seeded numpy traces go through both packages: `wavefront_alloc`,
`wavefront_free` and `wavefront_step` on one packed tree, and the pool
at S in {1, 2, 4} with overflow, junk and duplicate frees.  Then packed
against unpacked on valid traces (same nodes), and the stale-handle case
where the layouts differ.  Words are compared through int64 (uint32 in
JAX, int32 with the same bits in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import concurrent as jconc
from repro.core import pool as jpool
from repro_torch.core import concurrent as tconc
from repro_torch.core import pool as tpool
from test_torch_layout import JP, TP, _cfgs, _eq, _eq_stats, _t

_j_free_units = jax.jit(jpool.pool_free_units, static_argnums=0)
_j_largest_run = jax.jit(jpool.pool_largest_run, static_argnums=0)


# ---------------------------------------------------------------------------
# Wavefront rounds in the packed layout
# ---------------------------------------------------------------------------


def _trace(depth, seed, steps, K, F, max_level=0):
    """Mixed free+alloc steps on one packed tree, both packages step for
    step: wavefront_step, then wavefront_alloc and wavefront_free alone."""
    jt, tt = _cfgs(depth, max_level)
    rng = np.random.default_rng(seed)
    jtree, ttree = jt.empty_tree(), tt.empty_tree("cpu")
    live = []
    N = jt.n_words
    for _ in range(steps):
        fn = np.zeros(F, np.int32)
        fa = np.zeros(F, bool)
        take = rng.permutation(len(live))[: F - 3] if live else []
        for i, j in enumerate(take):
            fn[i], fa[i] = live[j], True
        fn[F - 3], fa[F - 3] = rng.integers(1, N), True      # junk
        fn[F - 2], fa[F - 2] = N + 3, True                    # out of range
        fn[F - 1], fa[F - 1] = fn[0], bool(fa[0])             # duplicate
        levels = rng.integers(max(max_level, depth - 4), depth + 1, size=K).astype(np.int32)
        act = rng.random(K) < 0.85
        jr = jconc.wavefront_step(jt, jtree, jnp.asarray(fn), jnp.asarray(fa),
                                  jnp.asarray(levels), jnp.asarray(act))
        tr = tconc.wavefront_step(tt, ttree, _t(fn), _t(fa), _t(levels), _t(act))
        for a, b, what in zip(jr[:3], tr[:3], ("tree", "nodes", "ok")):
            _eq(a, b, what)
        _eq_stats(jr[3], tr[3])
        freed = set(int(x) for x in fn[fa])
        live = [n for n in live if n not in freed]
        live += [int(n) for n in np.asarray(jr[1]) if n > 0]
        jtree, ttree = jr[0], tr[0]
    ja = jconc.wavefront_alloc(jt, jtree, jnp.asarray(levels), jnp.asarray(act))
    ta = tconc.wavefront_alloc(tt, ttree, _t(levels), _t(act))
    for a, b, what in zip(ja[:3], ta[:3], ("tree", "nodes", "ok")):
        _eq(a, b, what)
    _eq_stats(ja[3], ta[3])
    nodes = np.asarray(ja[1])
    jf = jconc.wavefront_free(jt, ja[0], jnp.asarray(nodes), jnp.asarray(nodes > 0))
    tf = tconc.wavefront_free(tt, ta[0], _t(nodes), _t(nodes > 0))
    _eq(jf[0], tf[0], "free tree")
    _eq(jf[1], tf[1], "freed")
    _eq_stats(jf[2], tf[2])


@pytest.mark.parametrize("depth,seed,max_level", [
    (3, 0, 0), (4, 1, 0), (5, 2, 1), (7, 3, 0), (9, 4, 2),
])
def test_packed_wavefront_trace(depth, seed, max_level):
    _trace(depth, seed, steps=4, K=16, F=10, max_level=max_level)


def test_out_of_range_levels_stay_pending():
    """A lane whose level lies outside [max_level, depth] never gets a
    target and stays pending until max_rounds, as in JAX."""
    jt, tt = _cfgs(5, max_level=1)
    levels = np.array([0, 3, 9, 5, -1], np.int32)
    act = np.ones(5, bool)
    ja = jconc.wavefront_alloc(jt, jt.empty_tree(), jnp.asarray(levels), jnp.asarray(act), 7)
    ta = tconc.wavefront_alloc(tt, tt.empty_tree("cpu"), _t(levels), _t(act), 7)
    for a, b, what in zip(ja[:3], ta[:3], ("tree", "nodes", "ok")):
        _eq(a, b, what)
    _eq_stats(ja[3], ta[3])
    assert int(ta[3]["rounds"]) == 7
    assert ta[2].tolist() == [False, True, False, True, False]


@pytest.mark.parametrize("S,depth,seed", [(1, 4, 0), (2, 4, 1), (4, 3, 2), (4, 6, 3)])
def test_packed_pool_trace(S, depth, seed):
    """The pool with packed trees: routing, overflow, junk and duplicate
    frees, free units and the largest run."""
    jp = jpool.PoolConfig(jconc.TreeConfig(depth=depth, layout=JP), S)
    tp = tpool.PoolConfig(tconc.TreeConfig(depth=depth, layout=TP), S)
    assert tuple(tp.empty_trees("cpu").shape) == (S, tp.tree.n_state_words)
    rng = np.random.default_rng(seed)
    jtrees, ttrees = jp.empty_trees(), tp.empty_trees("cpu")
    N = jp.n_words
    K, F = min(40, (S << depth) // 2 + 3), 16
    live, saw_overflow = [], False
    for _ in range(4):
        fn, fs, fa = np.zeros(F, np.int32), np.zeros(F, np.int32), np.zeros(F, bool)
        take = rng.permutation(len(live))[: (F - 4) // 2] if live else []
        for i, j in enumerate(take):
            fs[i], fn[i] = live[j]
            fa[i] = True
        fn[F - 4], fs[F - 4], fa[F - 4] = rng.integers(1, N), rng.integers(0, S), True
        fn[F - 3], fs[F - 3], fa[F - 3] = 2, S + 1, True
        fn[F - 2], fs[F - 2], fa[F - 2] = N, 0, True
        fn[F - 1], fs[F - 1], fa[F - 1] = fn[0], fs[0], bool(fa[0])
        levels = np.where(rng.random(K) < 0.5, depth,
                          rng.integers(max(depth - 3, 0), depth + 1, size=K)).astype(np.int32)
        act = rng.random(K) < 0.9
        ids = rng.integers(0, 1000, size=K).astype(np.int32)
        jr = jpool.pool_wavefront_step(jp, jtrees, jnp.asarray(fn), jnp.asarray(fs),
                                       jnp.asarray(fa), jnp.asarray(levels),
                                       jnp.asarray(act), 64, jnp.asarray(ids))
        tr = tpool.pool_wavefront_step(tp, ttrees, _t(fn), _t(fs), _t(fa), _t(levels),
                                       _t(act), 64, _t(ids))
        for a, b, what in zip(jr[:4], tr[:4], ("trees", "nodes", "shard", "ok")):
            _eq(a, b, what)
        _eq_stats(jr[4], tr[4])
        saw_overflow |= int(jr[4]["overflows"]) > 0
        _eq(_j_free_units(jp, jr[0]), tpool.pool_free_units(tp, tr[0]), "free units")
        _eq(_j_largest_run(jp, jr[0]), tpool.pool_largest_run(tp, tr[0]), "run")
        jtrees, ttrees = jr[0], tr[0]
        freed = set(zip(fs[fa].tolist(), fn[fa].tolist()))
        live = [h for h in live if h not in freed]
        live += [(int(s), int(n)) for s, n in zip(np.asarray(jr[2]), np.asarray(jr[1])) if n > 0]
    if S > 1:
        assert saw_overflow


# ---------------------------------------------------------------------------
# Packed against unpacked, and where they differ
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth,seed", [(6, 0), (10, 1)])
def test_packed_and_unpacked_give_the_same_nodes(depth, seed):
    """On valid traces (every free matches a live allocation) the two
    layouts serve identical nodes; only the word counts differ."""
    ut, pt = _cfgs(depth, layout="unpacked")[1], _cfgs(depth)[1]
    rng = np.random.default_rng(seed)
    utree, ptree = ut.empty_tree("cpu"), pt.empty_tree("cpu")
    live = []
    for _ in range(4):
        fn = np.array(live[: len(live) // 2] + [0] * 16, np.int32)[:16]
        fa = fn > 0
        levels = _t(rng.integers(2, depth + 1, size=24).astype(np.int32))
        act = torch.ones(24, dtype=torch.bool)
        ur = tconc.wavefront_step(ut, utree, _t(fn), _t(fa), levels, act)
        pr = tconc.wavefront_step(pt, ptree, _t(fn), _t(fa), levels, act)
        assert torch.equal(ur[1], pr[1]) and torch.equal(ur[2], pr[2])
        assert int(ur[3]["freed"]) == int(pr[3]["freed"])
        assert int(pr[3]["merged_writes"]) <= int(ur[3]["merged_writes"])
        utree, ptree = ur[0], pr[0]
        live = [n for n in live if n not in set(fn[fa].tolist())]
        live += [int(n) for n in ur[1] if n > 0]
    assert pt.n_state_words * 5 < ut.n_state_words


def test_stale_handle_semantics_differ_by_layout():
    """A junk free of a node whose two children were allocated
    separately: Unpacked drops it, BunchPacked releases both children,
    exactly as JAX's packed layout does."""
    depth = 4
    jt, tt = _cfgs(depth)
    _, ut = _cfgs(depth, layout="unpacked")
    kids = np.array([10, 11], np.int32)       # the two children of node 5
    levels = np.full(2, 3, np.int32)
    # allocate exactly nodes 10 and 11: fill level 3 up to them first
    fill = np.full(2, 3, np.int32)
    ja = jconc.wavefront_alloc(jt, jt.empty_tree(), jnp.asarray(np.r_[fill, levels]),
                               jnp.ones(4, bool))
    assert np.asarray(ja[1])[2:].tolist() == kids.tolist()
    ta = tconc.wavefront_alloc(tt, tt.empty_tree("cpu"), _t(np.r_[fill, levels]),
                               torch.ones(4, dtype=torch.bool))
    ua = tconc.wavefront_alloc(ut, ut.empty_tree("cpu"), _t(np.r_[fill, levels]),
                               torch.ones(4, dtype=torch.bool))
    junk = np.array([5], np.int32)
    jf = jconc.wavefront_free(jt, ja[0], jnp.asarray(junk), jnp.ones(1, bool))
    tf = tconc.wavefront_free(tt, ta[0], _t(junk), torch.ones(1, dtype=torch.bool))
    uf = tconc.wavefront_free(ut, ua[0], _t(junk), torch.ones(1, dtype=torch.bool))
    _eq(jf[0], tf[0], "packed tree")
    _eq(jf[1], tf[1], "packed freed")
    _eq_stats(jf[2], tf[2])
    assert bool(tf[1][0]) and not bool(uf[1][0])
    # packed: both children are free again; unpacked: both still held
    free_p = tconc.wavefront_alloc(tt, tf[0], _t(levels), torch.ones(2, dtype=torch.bool))
    free_u = tconc.wavefront_alloc(ut, uf[0], _t(levels), torch.ones(2, dtype=torch.bool))
    assert free_p[1].tolist() == kids.tolist()
    assert not set(free_u[1].tolist()) & set(kids.tolist())
