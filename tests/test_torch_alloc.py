"""The port's allocator against the JAX package, bit for bit.

Seeded numpy traces go through both packages: tree rounds
(`alloc_round`/`free_round`/`wavefront_step`), the sharded pool
(`pool_wavefront_alloc`/`pool_free_round`/`pool_wavefront_step`) and
the leaf-page API (`nb_pool_alloc_pages`/`nb_pool_free_pages`).  The
traces mix octaves and include overflow probing, exhaustion, duplicate
and junk frees, and lane ids whose Fibonacci hash wraps in uint32.
Trees, nodes, shards, ok masks and every stat slot must be identical.

The CUDA kernel of the pooled step is held against the same plain
version by tests/test_torch_kernels_on_card.py and `chip_smoke.py`.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import concurrent as jconc
from repro.core import nbbs_jax as jnbbs
from repro.core import pool as jpool
from repro.core import bits as jbits
from repro.kernels import ops as jops
from repro.obs import schema as jschema
from repro_torch.core import bits as tbits
from repro_torch.core import concurrent as tconc
from repro_torch.core import nbbs as tnbbs
from repro_torch.core import pool as tpool
from repro_torch.kernels import nbbs_alloc, ops as tops
from repro_torch.obs import schema as tschema

# eager JAX runs these op by op; jit them once per geometry
_j_alloc_round = jax.jit(jconc.alloc_round, static_argnums=0)
_j_free_round = jax.jit(jconc.free_round, static_argnums=0)
_j_pool_free_round = jax.jit(jpool.pool_free_round, static_argnums=0)
_j_alloc_pages = jax.jit(jnbbs.nb_pool_alloc_pages, static_argnums=(0, 4))
_j_free_pages = jax.jit(jnbbs.nb_pool_free_pages, static_argnums=0)

BIG_IDS = [2**31 - 1, 2**31 - 2, 2**30 + 7, 123456789, 5, 2, -1]


def _t(x, dtype=None):
    a = np.asarray(x)
    t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert (a.astype(np.int64) == b.astype(np.int64)).all(), what


def _eq_stats(js, ts):
    assert set(js) <= set(ts), set(js) - set(ts)
    for k in js:
        assert int(js[k]) == int(ts[k]), (k, int(js[k]), int(ts[k]))


def _cfgs(depth, S=None, max_level=0):
    jt = jconc.TreeConfig(depth=depth, max_level=max_level)
    tt = tconc.TreeConfig(depth=depth, max_level=max_level)
    if S is None:
        return jt, tt
    return jpool.PoolConfig(jt, S), tpool.PoolConfig(tt, S)


def _lane_ids(rng, K):
    ids = rng.integers(0, 1000, size=K).astype(np.int64)
    picks = rng.integers(0, K, size=min(K, len(BIG_IDS)))
    ids[picks] = BIG_IDS[: len(picks)]
    return ids.astype(np.int32)


# ---------------------------------------------------------------------------
# Copied constants
# ---------------------------------------------------------------------------


def test_copied_constants_match():
    for name in ("OCC_RIGHT", "OCC_LEFT", "COAL_RIGHT", "COAL_LEFT", "OCC",
                 "BUSY", "STATUS_MASK", "FIB_HASH"):
        assert getattr(tbits, name) == getattr(jbits, name), name
    assert {k: dataclasses.asdict(v) for k, v in tschema.REGISTRY.items()} == {
        k: dataclasses.asdict(v) for k, v in jschema.REGISTRY.items()
    }
    assert tschema.POOL_STEP_SLOTS == jschema.POOL_STEP_SLOTS
    assert tschema.WAVEFRONT_ALLOC_SLOTS == jschema.WAVEFRONT_ALLOC_SLOTS
    assert tschema.WAVEFRONT_STEP_SLOTS == jschema.WAVEFRONT_STEP_SLOTS
    assert tschema.ENGINE_METRICS == jschema.ENGINE_METRICS
    src = (Path(tbits.__file__).parents[1] / "csrc" / "nbbs_pool_step.cu").read_text()
    for name in ("OCC_RIGHT", "OCC_LEFT", "COAL_RIGHT", "COAL_LEFT", "OCC"):
        m = re.search(rf"constexpr int {name} = (0x[0-9a-fA-F]+);", src)
        assert int(m.group(1), 16) == getattr(tbits, name), name
    assert f"FIB_HASH = {tbits.FIB_HASH}u" in src


@pytest.mark.parametrize("S", [1, 3, 4])
def test_home_shard_matches_uint32_hash(S):
    ids = np.array(BIG_IDS + list(range(40)) + [-(2**31), -7], np.int32)
    jp, tp = _cfgs(4, S)
    _eq(jpool.home_shard(jp, jnp.asarray(ids)),
        tpool.home_shard(tp, _t(ids)), "home")


def test_levels_from_sizes():
    jt, tt = _cfgs(10)
    sizes = np.array([1, 2, 3, 7, 64, 1000, 1024, 4096, 0, 5000], np.int32)
    _eq(jconc.levels_from_sizes(jt, 1 << 20, jnp.asarray(sizes)),
        tconc.levels_from_sizes(tt, 1 << 20, _t(sizes)), "levels")


# ---------------------------------------------------------------------------
# Single-tree rounds
# ---------------------------------------------------------------------------


def _single_tree_trace(depth, seed, steps, K, F):
    """Mixed free+alloc steps on one tree, both packages step for step."""
    jt, tt = _cfgs(depth, max_level=1 if depth > 5 else 0)
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
        # junk, out of range, and a duplicate of the first free
        fn[F - 3], fa[F - 3] = rng.integers(1, N), True
        fn[F - 2], fa[F - 2] = N + 3, True
        fn[F - 1], fa[F - 1] = fn[0], bool(fa[0])
        levels = rng.integers(max(jt.max_level, depth - 3), depth + 1, size=K).astype(np.int32)
        act = rng.random(K) < 0.85
        jr = jconc.wavefront_step(jt, jtree, jnp.asarray(fn), jnp.asarray(fa),
                                  jnp.asarray(levels), jnp.asarray(act))
        tr = tconc.wavefront_step(tt, ttree, _t(fn), _t(fa), _t(levels), _t(act))
        for a, b, what in zip(jr[:3], tr[:3], ("tree", "nodes", "ok")):
            _eq(a, b, what)
        _eq_stats(jr[3], tr[3])
        jtree, ttree = jr[0], tr[0]
        freed = set(int(x) for x in fn[fa])
        live = [n for n in live if n not in freed]
        live += [int(n) for n in np.asarray(jr[1]) if n > 0]


@pytest.mark.parametrize("depth,seed", [(3, 0), (5, 1), (6, 2), (8, 3)])
def test_wavefront_step_trace(depth, seed):
    _single_tree_trace(depth, seed, steps=5, K=12, F=10)


def test_alloc_and_free_round_single():
    jt, tt = _cfgs(6)
    rng = np.random.default_rng(9)
    K = 20
    levels = rng.integers(2, 7, size=K).astype(np.int32)
    pend = rng.random(K) < 0.9
    nodes0 = np.zeros(K, np.int32)
    jr = _j_alloc_round(jt, jt.empty_tree(), jnp.asarray(levels),
                           jnp.asarray(pend), jnp.asarray(nodes0))
    tr = tconc.alloc_round(tt, tt.empty_tree("cpu"), _t(levels), _t(pend), _t(nodes0))
    for a, b, what in zip(jr, tr, ("tree", "nodes", "pending", "merged",
                                   "logical", "won")):
        _eq(a, b, what)
    fn = np.asarray(jr[1])
    fa = fn > 0
    jf = _j_free_round(jt, jr[0], jnp.asarray(fn), jnp.asarray(fa))
    tf = tconc.free_round(tt, tr[0], _t(fn), _t(fa))
    for a, b, what in zip(jf, tf, ("tree", "merged", "logical", "freed")):
        _eq(a, b, what)


# ---------------------------------------------------------------------------
# Sharded pool
# ---------------------------------------------------------------------------


def _pool_trace(S, depth, seed, steps, K, F, leaf_frac=0.5):
    """Pooled steps on both packages; bursts big enough to exhaust a
    home shard so lanes overflow, plus junk and duplicate frees."""
    jp, tp = _cfgs(depth, S)
    rng = np.random.default_rng(seed)
    jtrees, ttrees = jp.empty_trees(), tp.empty_trees("cpu")
    N = jp.n_words
    live = []   # (shard, node)
    saw_overflow = False
    for _ in range(steps):
        fn = np.zeros(F, np.int32)
        fs = np.zeros(F, np.int32)
        fa = np.zeros(F, bool)
        take = rng.permutation(len(live))[: max(F - 4, 0) // 2] if live else []
        for i, j in enumerate(take):
            fs[i], fn[i] = live[j]
            fa[i] = True
        fn[F - 4], fs[F - 4], fa[F - 4] = rng.integers(1, N), rng.integers(0, S), True
        fn[F - 3], fs[F - 3], fa[F - 3] = 2, S + 1, True          # shard out of range
        fn[F - 2], fs[F - 2], fa[F - 2] = N, 0, True               # node out of range
        fn[F - 1], fs[F - 1], fa[F - 1] = fn[0], fs[0], bool(fa[0])  # duplicate
        levels = np.where(
            rng.random(K) < leaf_frac, depth,
            rng.integers(max(depth - 3, 0), depth + 1, size=K),
        ).astype(np.int32)
        act = rng.random(K) < 0.9
        ids = _lane_ids(rng, K)
        jr = jpool.pool_wavefront_step(
            jp, jtrees, jnp.asarray(fn), jnp.asarray(fs), jnp.asarray(fa),
            jnp.asarray(levels), jnp.asarray(act), 64, jnp.asarray(ids),
        )
        tr = tpool.pool_wavefront_step(
            tp, ttrees, _t(fn), _t(fs), _t(fa), _t(levels), _t(act), 64, _t(ids)
        )
        for a, b, what in zip(jr[:4], tr[:4], ("trees", "nodes", "shard", "ok")):
            _eq(a, b, what)
        _eq_stats(jr[4], tr[4])
        saw_overflow |= int(jr[4]["overflows"]) > 0
        jtrees, ttrees = jr[0], tr[0]
        freed = set(zip(fs[fa].tolist(), fn[fa].tolist()))
        live = [h for h in live if h not in freed]
        nodes, shard = np.asarray(jr[1]), np.asarray(jr[2])
        live += [(int(s), int(n)) for s, n in zip(shard, nodes) if n > 0]
    return saw_overflow


@pytest.mark.parametrize("S,depth,seed", [(1, 3, 0), (1, 6, 1), (4, 3, 2),
                                          (4, 5, 3), (4, 8, 4)])
def test_pool_wavefront_step_trace(S, depth, seed):
    K = max(8, (S << depth) // 2 + 3)
    overflowed = _pool_trace(S, depth, seed, steps=5, K=min(K, 40), F=24)
    if S > 1 and depth <= 5:
        assert overflowed  # the trace must exercise re-routing


@pytest.mark.parametrize("S", [1, 4])
def test_pool_alloc_and_free_round(S):
    jp, tp = _cfgs(5, S)
    rng = np.random.default_rng(S)
    K = 40
    levels = rng.integers(3, 6, size=K).astype(np.int32)
    ids = _lane_ids(rng, K)
    act = np.ones(K, bool)
    jr = jpool.pool_wavefront_alloc(jp, jp.empty_trees(), jnp.asarray(levels),
                                    jnp.asarray(act), 64, jnp.asarray(ids))
    tr = tpool.pool_wavefront_alloc(tp, tp.empty_trees("cpu"), _t(levels),
                                    _t(act), 64, _t(ids))
    for a, b, what in zip(jr[:4], tr[:4], ("trees", "nodes", "shard", "ok")):
        _eq(a, b, what)
    _eq_stats(jr[4], tr[4])
    fn, fs = np.asarray(jr[1]), np.asarray(jr[2])
    fa = rng.random(K) < 0.7
    jf = _j_pool_free_round(jp, jr[0], jnp.asarray(fn), jnp.asarray(fs), jnp.asarray(fa))
    tf = tpool.pool_free_round(tp, tr[0], _t(fn), _t(fs), _t(fa))
    for a, b, what in zip(jf, tf, ("trees", "merged", "logical", "freed")):
        _eq(a, b, what)
    _eq(jpool.pool_free_units(jp, jf[0]), tpool.pool_free_units(tp, tf[0]), "free units")
    _eq(jpool.pool_largest_run(jp, jf[0]), tpool.pool_largest_run(tp, tf[0]), "run")


# ---------------------------------------------------------------------------
# Leaf-page API and the ops dispatcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,depth", [(1, 4), (4, 3)])
def test_nb_pool_pages_trace(S, depth):
    jp, tp = _cfgs(depth, S)
    rng = np.random.default_rng(depth + S)
    jtrees, ttrees = jp.empty_trees(), tp.empty_trees("cpu")
    K = (S << depth) // 2 + 2
    handles = []
    for _ in range(4):
        act = rng.random(K) < 0.9
        ids = _lane_ids(rng, K)
        ja = _j_alloc_pages(jp, jtrees, jnp.asarray(act), jnp.asarray(ids))
        ta = tnbbs.nb_pool_alloc_pages(tp, ttrees, _t(act), _t(ids))
        for a, b, what in zip(ja[:4], ta[:4], ("trees", "shard", "off", "ok")):
            _eq(a, b, what)
        _eq_stats(ja[4], ta[4])
        ok = np.asarray(ja[3])
        handles += list(zip(np.asarray(ja[1])[ok], np.asarray(ja[2])[ok]))
        # free about half, plus junk shard, junk offset and a duplicate
        rng.shuffle(handles)
        burst, handles = handles[: len(handles) // 2], handles[len(handles) // 2 :]
        sh = [int(s) for s, _ in burst] + [S + 2, 0, -1]
        of = [int(o) for _, o in burst] + [0, 1 << depth, 0]
        if burst:
            sh.append(sh[0])
            of.append(of[0])
        fa = np.zeros(2 * K, bool)
        fa[: len(sh)] = True
        sh = np.array(sh + [0] * (2 * K - len(sh)), np.int32)  # fixed width:
        of = np.array(of + [0] * (2 * K - len(of)), np.int32)  # one compile
        jf = _j_free_pages(jp, ja[0], jnp.asarray(sh), jnp.asarray(of), jnp.asarray(fa))
        tf = tnbbs.nb_pool_free_pages(tp, ta[0], _t(sh), _t(of), _t(fa))
        _eq(jf[0], tf[0], "trees")
        _eq(jf[1], tf[1], "freed")
        _eq_stats(jf[2], tf[2])
        jtrees, ttrees = jf[0], tf[0]


@pytest.mark.parametrize("S,depth,seed", [(1, 6, 0), (2, 6, 1), (4, 5, 2)])
def test_ops_pool_step_matches_interpret_without_overflow(S, depth, seed):
    """The port's dispatcher on CPU against the JAX Pallas dispatcher in
    interpret mode, on traces with no overflow (where the dispatcher's
    attempt-granular routing equals the lockstep router)."""
    jp, tp = _cfgs(depth, S)
    rng = np.random.default_rng(seed)
    K = 16
    levels = rng.integers(depth - 2, depth + 1, size=K).astype(np.int32)
    fz = np.zeros(4, np.int32)
    j = jops.nbbs_pool_wavefront_step(
        jp, jp.empty_trees(), jnp.asarray(fz), jnp.asarray(fz),
        jnp.asarray(fz.astype(bool)), jnp.asarray(levels), impl="interpret",
    )
    t = tops.nbbs_pool_wavefront_step(
        tp, tp.empty_trees("cpu"), _t(fz), _t(fz), _t(fz.astype(bool)), _t(levels)
    )
    for a, b, what in zip(j[:4], t[:4], ("trees", "nodes", "shard", "ok")):
        _eq(a, b, what)
    assert int(j[4]["overflows"]) == int(t[4]["overflows"]) == 0
    for k in ("merged_writes", "logical_rmws", "free_merged_writes", "freed"):
        assert int(j[4][k]) == int(t[4][k]), k


def test_kernel_geometry_limit():
    """The main path's pools (4096 pages at S=1 and S=4, 256 lanes) and
    every stack of up to 2^15 nodes (one depth-14 tree, S=2 at depth 13)
    run from shared memory; larger ones from device memory, up to 2^19
    tree nodes in all."""
    for S, depth in ((1, 12), (4, 10), (1, 14), (2, 13)):
        _, tp = _cfgs(depth, S)
        assert nbbs_alloc.smem_bytes(tp, 256) <= nbbs_alloc.SMEM_LIMIT
        assert nbbs_alloc.tier(tp.tree, S, 256) == "shared"
    for S, depth in ((1, 16), (4, 14)):
        _, big = _cfgs(depth, S)
        assert nbbs_alloc.smem_bytes(big, 256) > nbbs_alloc.SMEM_LIMIT
        assert nbbs_alloc.tier(big.tree, S, 256) == "device"
    assert nbbs_alloc.MAX_NODES == 1 << 19     # one depth-18 tree


@pytest.mark.parametrize("slots", ["WAVEFRONT_ALLOC_SLOTS", "WAVEFRONT_STEP_SLOTS",
                                   "POOL_STEP_SLOTS"])
def test_stat_rows_pack_and_unpack_like_jax(slots):
    """The port's copies of `pack_slots` / `unpack_slots` lay a stats
    dict out in the schema's order, as JAX's do."""
    names = getattr(tschema, slots)
    values = {name: i * 7 + 1 for i, name in enumerate(names)}
    trow = tschema.pack_slots(names, {k: torch.tensor(v) for k, v in values.items()})
    jrow = jschema.pack_slots(names, {k: jnp.int32(v) for k, v in values.items()})
    _eq(jrow, trow, slots)
    assert {k: int(v) for k, v in tschema.unpack_slots(names, trow).items()} == values
    with pytest.raises(ValueError, match="stat row width"):
        tschema.unpack_slots(names, trow[:-1])
