"""The port's single-op allocator API and the quickstart, against JAX.

`core/nbbs.py`'s `nb_alloc`, `nb_free`, `nb_free_batch`, `nb_alloc_size`,
`nb_pool_alloc` and `nb_pool_free_batch` run a seeded mixed trace (with
junk offsets, stale handles and double frees) next to
`repro/core/nbbs_jax.py`, in both tree layouts: tree words (through
int64), index[], offsets, shards, ok and freed flags must be identical
after every call.  Then `examples/quickstart.py` §3-§6 through the port,
with the numbers JAX gives and what the example asserts, and the
numbers the port's quickstart twin returns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import concurrent as jconc
from repro.core import nbbs_jax as jnbbs
from repro.core import pool as jpool
from repro.kernels.nbbs_alloc import wavefront_alloc_pallas
from repro_torch.core import concurrent as tconc
from repro_torch.core import nbbs as tnbbs
from repro_torch.core import pool as tpool
from repro_torch.examples import quickstart
from repro_torch.kernels import ops as tops
from test_torch_layout import _eq, _t
from test_torch_single_tree import cfgs

_j_alloc = jax.jit(jnbbs.nb_alloc, static_argnums=0)
_j_alloc_size = jax.jit(jnbbs.nb_alloc_size, static_argnums=(0, 2))
_j_free = jax.jit(jnbbs.nb_free, static_argnums=0)
_j_free_batch = jax.jit(jnbbs.nb_free_batch, static_argnums=0)
_j_pool_alloc = jax.jit(jnbbs.nb_pool_alloc, static_argnums=0)
_j_pool_free_batch = jax.jit(jnbbs.nb_pool_free_batch, static_argnums=0)

DEPTH = 6
TOTAL = 1 << 10   # bytes, 16 per unit at depth 6


def _same_state(js, ts, what):
    for a, b, part in zip(js, ts, ("tree", "index")):
        _eq(a, b, f"{what}: {part}")


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_single_tree_api_trace(layout):
    jt, tt = cfgs(DEPTH, layout)
    rng = np.random.default_rng(11)
    js, ts = jnbbs.init_state(jt), tnbbs.init_state(tt, "cpu")
    live, dead = [], []
    for step in range(40):
        r = rng.random()
        if r < 0.35:
            lev = int(rng.integers(2, DEPTH + 1))
            js, joff, jok = _j_alloc(jt, js, jnp.int32(lev))
            ts, toff, tok = tnbbs.nb_alloc(tt, ts, lev)
            _eq(joff, toff, "nb_alloc off")
            _eq(jok, tok, "nb_alloc ok")
        elif r < 0.5:
            size = int(rng.integers(1, TOTAL // 2))
            js, joff, jok = _j_alloc_size(jt, js, TOTAL, jnp.int32(size))
            ts, toff, tok = tnbbs.nb_alloc_size(tt, ts, TOTAL, size)
            _eq(joff, toff, "nb_alloc_size off")
            _eq(jok, tok, "nb_alloc_size ok")
        elif r < 0.65 and (live or dead):
            off = (live + dead)[int(rng.integers(0, len(live) + len(dead)))]
            js = _j_free(jt, js, jnp.int32(off))
            ts = tnbbs.nb_free(tt, ts, off)
            if off in live:
                live.remove(off)
                dead.append(off)
            _same_state(js, ts, f"step {step} nb_free")
            continue
        else:
            burst = list(rng.permutation(live)[: len(live) // 2]) + dead[-2:]
            burst += [-1, 1 << DEPTH, int(rng.integers(0, 1 << DEPTH))]
            burst += burst[:1]                                 # a double free
            offs = np.array(burst + [0] * (16 - len(burst)), np.int32)[:16]
            act = np.arange(16) < len(burst)
            js, jfreed = _j_free_batch(jt, js, jnp.asarray(offs), jnp.asarray(act))
            ts, tfreed = tnbbs.nb_free_batch(tt, ts, _t(offs), _t(act))
            _eq(jfreed, tfreed, f"step {step} nb_free_batch freed")
            gone = {int(o) for o in offs[act]}
            dead += [o for o in live if o in gone]
            live = [o for o in live if o not in gone]
            _same_state(js, ts, f"step {step} nb_free_batch")
            continue
        if bool(tok):
            live.append(int(toff))
        _same_state(js, ts, f"step {step}")
    assert live and dead


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_pool_api_trace(layout):
    S = 2
    jt, tt = cfgs(4, layout)
    jp, tp = jpool.PoolConfig(jt, S), tpool.PoolConfig(tt, S)
    rng = np.random.default_rng(12)
    js, ts = jnbbs.init_pool_state(jp), tnbbs.init_pool_state(tp, "cpu")
    live = []
    for step in range(24):
        if step % 4 != 3:
            lev, lane = int(rng.integers(2, 5)), int(rng.integers(0, 2**31 - 1))
            js, jsh, joff, jok = _j_pool_alloc(jp, js, jnp.int32(lev), jnp.int32(lane))
            ts, tsh, toff, tok = tnbbs.nb_pool_alloc(tp, ts, lev, lane)
            for a, b, what in zip((jsh, joff, jok), (tsh, toff, tok),
                                  ("shard", "off", "ok")):
                _eq(a, b, f"step {step} nb_pool_alloc {what}")
            if bool(tok):
                live.append((int(tsh), int(toff)))
        else:
            burst = live[::2] + [(S, 0), (0, 16), (1, -3)] + live[:1]
            sh = np.array([b[0] for b in burst] + [0] * 16, np.int32)[:16]
            of = np.array([b[1] for b in burst] + [0] * 16, np.int32)[:16]
            act = np.arange(16) < len(burst)
            js, jfreed = _j_pool_free_batch(jp, js, jnp.asarray(sh), jnp.asarray(of),
                                            jnp.asarray(act))
            ts, tfreed = tnbbs.nb_pool_free_batch(tp, ts, _t(sh), _t(of), _t(act))
            _eq(jfreed, tfreed, f"step {step} nb_pool_free_batch freed")
            live = live[1::2]
        _same_state(js, ts, f"step {step}")


def test_node_to_unit_offset():
    jt, tt = cfgs(DEPTH, "unpacked")
    nodes = np.arange(0, 1 << (DEPTH + 1), dtype=np.int32)
    _eq(jnbbs._node_to_unit_offset(jt, jnp.asarray(nodes)),
        tnbbs._node_to_unit_offset(tt, _t(nodes)), "unit offsets")


def test_quickstart_through_the_port():
    """examples/quickstart.py §3-§6 with repro_torch: the same numbers
    as JAX, and what the example asserts; the port's twin
    (`repro_torch.examples.quickstart`) returns those numbers."""
    levels_np = np.random.default_rng(0).integers(5, 11, 32).astype(np.int32)
    # §3: 32 concurrent allocations on a depth-10 tree
    jcfg = jconc.TreeConfig(depth=10, max_level=0)
    tcfg = tconc.TreeConfig(depth=10, max_level=0)
    jtree, jnodes, jok, jst = jconc.wavefront_alloc(
        jcfg, jcfg.empty_tree(), jnp.asarray(levels_np), jnp.ones(32, bool))
    tree, nodes, ok, st = tconc.wavefront_alloc(
        tcfg, tcfg.empty_tree("cpu"), _t(levels_np), torch.ones(32, dtype=torch.bool))
    _eq(jtree, tree, "§3 tree")
    _eq(jnodes, nodes, "§3 nodes")
    for k in ("rounds", "merged_writes", "logical_rmws"):
        assert int(jst[k]) == int(st[k]), k
    assert int(ok.sum()) == int(jok.sum())
    # §4: the kernel's op is bit-identical to the plain rounds
    j4 = wavefront_alloc_pallas(jcfg, jcfg.empty_tree(), jnp.asarray(levels_np))
    t4 = tops.nbbs_wavefront_alloc(tcfg, tcfg.empty_tree("cpu"), _t(levels_np))
    assert torch.equal(t4[0], tree) and torch.equal(t4[1], nodes)
    _eq(j4[0], t4[0], "§4 tree")
    # §5: sharded pool, 4 trees of depth 8, overflow routing
    jp = jpool.PoolConfig(jconc.TreeConfig(depth=8, max_level=0), n_shards=4)
    tp = tpool.PoolConfig(tconc.TreeConfig(depth=8, max_level=0), n_shards=4)
    j5 = jpool.pool_wavefront_alloc(jp, jp.empty_trees(), jnp.asarray(levels_np - 2),
                                    jnp.ones(32, bool))
    t5 = tpool.pool_wavefront_alloc(tp, tp.empty_trees("cpu"), _t(levels_np - 2),
                                    torch.ones(32, dtype=torch.bool))
    for a, b, what in zip(j5[:4], t5[:4], ("trees", "nodes", "shard", "ok")):
        _eq(a, b, f"§5 {what}")
    for k in ("rounds", "overflows"):
        assert int(j5[4][k]) == int(t5[4][k]), k
    per_shard = np.bincount(t5[2].numpy()[t5[3].numpy()], minlength=4)
    assert per_shard.tolist() == np.bincount(
        np.asarray(j5[2])[np.asarray(j5[3])], minlength=4).tolist()
    trees, _, _ = tpool.pool_wavefront_free(tp, t5[0], t5[1], t5[2], t5[3])
    assert not trees.any()
    # §6: the packed layout gives the same nodes and drains to zero
    jp6 = jconc.TreeConfig(depth=10, max_level=0, layout=jconc.BUNCH_PACKED)
    tp6 = tconc.TreeConfig(depth=10, max_level=0, layout=tconc.BUNCH_PACKED)
    j6 = jconc.wavefront_alloc(jp6, jp6.empty_tree(), jnp.asarray(levels_np),
                               jnp.ones(32, bool))
    t6 = tconc.wavefront_alloc(tp6, tp6.empty_tree("cpu"), _t(levels_np),
                               torch.ones(32, dtype=torch.bool))
    assert torch.equal(t6[1], nodes)
    _eq(j6[0], t6[0], "§6 packed tree")
    assert tp6.n_state_words == jp6.n_state_words
    assert int(j6[3]["merged_writes"]) == int(t6[3]["merged_writes"])
    assert int(t6[3]["merged_writes"]) < int(st["merged_writes"])
    ptree, _, _ = tconc.wavefront_free(tp6, t6[0], t6[1], t6[2])
    assert not ptree.any()
    # the port's quickstart twin returns the numbers JAX gives here
    nums = quickstart.run("cpu", out=lambda *a: None)
    assert nums == dict(
        cas_attempts=nums["cas_attempts"], word_rmws=nums["word_rmws"],
        committed=int(jok.sum()), rounds=int(jst["rounds"]),
        merged_writes=int(jst["merged_writes"]), logical_rmws=int(jst["logical_rmws"]),
        pool_committed=int(j5[3].sum()), pool_rounds=int(j5[4]["rounds"]),
        pool_overflows=int(j5[4]["overflows"]), per_shard=per_shard.tolist(),
        packed_words=jp6.n_state_words, unpacked_words=jcfg.n_state_words,
        packed_merged_writes=int(j6[3]["merged_writes"]))
