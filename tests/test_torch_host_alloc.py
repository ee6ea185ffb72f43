"""The port's host allocators against the JAX package's, bit for bit.

`NBBSRef`, `BunchBuddy`, `SpinlockTreeBuddy` and `FreeListBuddy` of
`src/repro_torch/core/` replay seeded numpy op traces (allocations of
mixed sizes, scattered and first-fit, single and burst frees, requests
that fail) beside their originals in `src/repro/core/`: every address,
every tree word, the index, and every stat and lock count must be equal
after every op.  Then the port's `free_batch_sequential` (the faithful
FREENODE/UNMARK scan) against JAX's on random trees and bursts, and
against the port's merged `free_round`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import bunch as jbunch
from repro.core import concurrent as jconc
from repro.core import ref as jref
from repro_torch.core import baselines as tbase
from repro_torch.core import bunch as tbunch
from repro_torch.core import concurrent as tconc
from repro_torch.core import ref as tref

# (total_memory, min_size, max_size, base_address)
GEOMS = [(1024, 8, None, 0), (4096, 1, 256, 0), (512, 4, 64, 4096)]


def _trace(rng, total, min_size, max_size, n_ops=300):
    """Seeded ops: ("alloc", size, scattered) or ("free", pick) where pick
    selects a live allocation, or ("burst", picks)."""
    cap = max_size or total
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.55:
            size = int(rng.integers(0, 2 * cap + 1)) if rng.random() < 0.05 else int(
                min_size * 2 ** rng.integers(0, max(1, (cap // min_size).bit_length())))
            if rng.random() < 0.2:
                size = max(0, size - int(rng.integers(0, max(1, size))))  # not a power of two
            ops.append(("alloc", size, bool(rng.random() < 0.5)))
        elif r < 0.85:
            ops.append(("free", float(rng.random())))
        else:
            ops.append(("burst", [float(x) for x in rng.random(int(rng.integers(1, 6)))]))
    return ops


def _replay(pair, ops, check):
    """Run `ops` on both allocators of `pair`, calling check() after each."""
    live = []
    for op in ops:
        if op[0] == "alloc":
            out = [a.nb_alloc(op[1], scattered=op[2]) if op[2] is not None else a.nb_alloc(op[1])
                   for a in pair]
            assert out[0] == out[1], op
            if out[0] is not None:
                live.append(out[0])
        elif op[0] == "free" and live:
            addr = live.pop(int(op[1] * len(live)))
            for a in pair:
                a.nb_free(addr)
        elif op[0] == "burst" and live:
            picks = sorted({int(p * len(live)) for p in op[1]}, reverse=True)
            addrs = [live.pop(i) for i in picks]
            for a in pair:
                if hasattr(a, "nb_free_many"):
                    a.nb_free_many(addrs)
                else:
                    for x in addrs:
                        a.nb_free(x)
        check()
    return live


def _invariants(a):
    """check_invariants' message, or None when it passes."""
    try:
        a.check_invariants()
    except AssertionError as e:
        return str(e)
    return None


def _same_ref(j, t):
    assert t.tree == j.tree
    assert t.index == j.index
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t._scan_hint == j._scan_hint


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "x".join(map(str, g[:3])))
@pytest.mark.parametrize("seed", [0, 1])
def test_nbbs_ref_matches_jax(geom, seed):
    total, min_size, max_size, base = geom
    j = jref.NBBSRef(total, min_size, max_size, base_address=base)
    t = tref.NBBSRef(total, min_size, max_size, base_address=base)
    assert (t.depth, t.max_level) == (j.depth, j.max_level)
    ops = _trace(np.random.default_rng(seed), total, min_size, max_size)
    _replay((j, t), ops, lambda: _same_ref(j, t))
    assert t.allocated_ranges() == j.allocated_ranges()
    assert t.free_bytes() == j.free_bytes()
    # the quiescent-state check holds where climbs reach the root
    assert _invariants(t) == _invariants(j)
    if not t.max_level:
        assert _invariants(t) is None


def test_nbbs_ref_helpers_match_jax():
    j, t = jref.NBBSRef(1 << 12, 4, base_address=64), tref.NBBSRef(1 << 12, 4, base_address=64)
    for size in (0, 1, 3, 4, 5, 100, 4096):
        assert t.level_for_size(size) == j.level_for_size(size)
    for n in (1, 2, 3, 17, 1023, 1024):
        assert t.starting_address(n) == j.starting_address(n)
    assert [tref._ilog2(x) for x in range(1, 70)] == [jref._ilog2(x) for x in range(1, 70)]
    for bad in ((1000, 8), (1024, 3), (1024, 8, 2048)):
        with pytest.raises(ValueError):
            tref.NBBSRef(*bad)
    # a junk tree: the invariant check raises as the original does
    for a in (j, t):
        a.tree[2] = 0x10
        with pytest.raises(AssertionError):
            a.check_invariants()


@pytest.mark.parametrize("B,bits", [(4, 64), (3, 32)])
@pytest.mark.parametrize("geom", GEOMS[:2], ids=lambda g: "x".join(map(str, g[:3])))
def test_bunch_buddy_matches_jax(B, bits, geom):
    total, min_size, max_size, base = geom
    j = jbunch.BunchBuddy(total, min_size, max_size, base, bunch_levels=B, word_bits=bits)
    t = tbunch.BunchBuddy(total, min_size, max_size, base, bunch_levels=B, word_bits=bits)

    def same():
        assert t.words == j.words
        assert t.index == j.index
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)

    ops = _trace(np.random.default_rng(B), total, min_size, max_size, n_ops=200)
    _replay((j, t), ops, same)
    assert t.allocated_ranges() == j.allocated_ranges()
    assert t.free_bytes() == j.free_bytes()
    assert [t.node_state(n) for n in range(1, 2 << t.depth)] == [
        j.node_state(n) for n in range(1, 2 << j.depth)]
    with pytest.raises(ValueError):
        tbunch.BunchBuddy(1024, 8, bunch_levels=5, word_bits=64)


def test_spinlock_buddy_matches_jax():
    j, t = jbase.SpinlockTreeBuddy(2048, 4), tbase.SpinlockTreeBuddy(2048, 4)
    ops = _trace(np.random.default_rng(5), 2048, 4, None)

    def same():
        _same_ref(j, t)
        assert t.lock_acquisitions == j.lock_acquisitions

    _replay((j, t), ops, same)
    assert t.lock_acquisitions > 0


@pytest.mark.parametrize("geom", [(1024, 8, None, 0), (4096, 16, 512, 256)],
                         ids=["1024x8", "4096x16x512"])
def test_free_list_buddy_matches_jax(geom):
    total, min_size, max_size, base = geom
    j = jbase.FreeListBuddy(total, min_size, max_size, base)
    t = tbase.FreeListBuddy(total, min_size, max_size, base)
    ops = [(o[0], o[1], None) if o[0] == "alloc" else o
           for o in _trace(np.random.default_rng(7), total, min_size, max_size)]

    def same():
        assert t.free_lists == j.free_lists
        assert t.alloc_order == j.alloc_order
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)

    _replay((j, t), ops, same)
    assert sorted(map(tuple, t.allocated_ranges())) == sorted(map(tuple, j.allocated_ranges()))
    assert t.free_bytes() == j.free_bytes()


# ---------------------------------------------------------------------------
# free_batch_sequential
# ---------------------------------------------------------------------------


def _random_tree(rng, depth, max_level):
    """A quiescent tree from host allocations: (tree words, live nodes)."""
    a = tref.NBBSRef(1 << depth, 1, max_size=1 << (depth - max_level))
    for _ in range(int(rng.integers(4, 40))):
        a.nb_alloc(int(2 ** rng.integers(0, depth - max_level + 1)), scattered=True)
    live = [n for n in range(1, len(a.tree)) if a.tree[n] & 0x10]
    return a.tree, live


@pytest.mark.parametrize("depth,max_level", [(5, 0), (7, 0), (8, 2)])
def test_free_batch_sequential_matches_jax(depth, max_level):
    """Random trees and bursts, duplicates, node 0 and inactive lanes
    included: tree and writes exact."""
    rng = np.random.default_rng(depth * 10 + max_level)
    jcfg = jconc.TreeConfig(depth=depth, max_level=max_level)
    tcfg = tconc.TreeConfig(depth=depth, max_level=max_level)
    for _ in range(6):
        tree, live = _random_tree(rng, depth, max_level)
        K = 12
        nodes = rng.choice(live + [0], size=K).astype(np.int32)
        active = rng.random(K) < 0.8
        jt, jw = jconc.free_batch_sequential(jcfg, jnp.asarray(tree, jnp.int32),
                                             jnp.asarray(nodes), jnp.asarray(active))
        tt, tw = tconc.free_batch_sequential(tcfg, torch.tensor(tree, dtype=torch.int32),
                                             torch.from_numpy(nodes), torch.from_numpy(active))
        assert tt.dtype == torch.int32 and tw.dtype == torch.int32
        assert tt.tolist() == np.asarray(jt).tolist()
        assert int(tw) == int(jw)


@pytest.mark.parametrize("depth,max_level", [(5, 0), (7, 0), (6, 2)])
def test_free_batch_sequential_matches_free_round(depth, max_level):
    """On quiescent batches of distinct live nodes the merged pass gives
    the faithful scan's tree, with no more writes."""
    rng = np.random.default_rng(11 + depth)
    cfg = tconc.TreeConfig(depth=depth, max_level=max_level)
    for _ in range(6):
        tree, live = _random_tree(rng, depth, max_level)
        k = int(rng.integers(1, len(live) + 1))
        sel = torch.tensor(rng.choice(live, size=k, replace=False), dtype=torch.int32)
        act = torch.ones(k, dtype=torch.bool)
        t0 = torch.tensor(tree, dtype=torch.int32)
        t_seq, w_seq = tconc.free_batch_sequential(cfg, t0, sel, act)
        t_vec, merged, logical, freed = tconc.free_round(cfg, t0, sel, act)
        assert torch.equal(t_seq, t_vec)
        assert bool(freed.all())
        assert int(merged) <= int(w_seq)
        assert int(logical) <= int(w_seq)


def test_free_batch_sequential_rejects_packed_layout():
    """The scan replays unpacked bit ops: both packages refuse packed
    state with the same message."""
    tcfg = tconc.TreeConfig(depth=6, max_level=0, layout=tconc.BUNCH_PACKED)
    jcfg = jconc.TreeConfig(depth=6, max_level=0, layout=jconc.BUNCH_PACKED)
    with pytest.raises(ValueError, match="requires the Unpacked layout"):
        tconc.free_batch_sequential(tcfg, tcfg.empty_tree("cpu"), torch.tensor([64]),
                                    torch.tensor([True]))
    with pytest.raises(ValueError, match="requires the Unpacked layout"):
        jconc.free_batch_sequential(jcfg, jcfg.empty_tree(), jnp.asarray([64]),
                                    jnp.asarray([True]))
