"""The port's `BunchPacked` layout against the JAX package, bit for bit.

Seeded numpy inputs go through both packages: the layout's passes
(`_bunch_layers`, `n_state_words`, `derive`, `allocatable`,
`node_occ_at`, `commit_allocs`, `apply_frees` and both logical counts)
at every depth from 3 to 14, so each way depth+1 can fall modulo 3 (the
partial top layer) is covered.  The rounds and the pool in the packed
layout are in tests/test_torch_layout_rounds.py.

JAX keeps packed words as uint32 and the port as int32 with the same
bits: both sides are compared through int64.  Words, nodes, ok masks
and every stat slot must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import concurrent as jconc
from repro.core import layout as jlayout
from repro_torch.core import concurrent as tconc
from repro_torch.core import layout as tlayout

JP, TP = jlayout.BUNCH_PACKED, tlayout.BUNCH_PACKED

# JAX's packed passes, compiled once per geometry (eager dispatch of
# their many small ops is slower than one compile)
_J = {name: jax.jit(getattr(JP, name), static_argnums=0) for name in (
    "commit_allocs", "apply_frees", "derive", "allocatable", "node_occ_at",
    "alloc_logical_rmws", "free_logical_rmws")}


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert (a.astype(np.int64) == b.astype(np.int64)).all(), what


def _eq_stats(js, ts):
    assert set(js) <= set(ts), set(js) - set(ts)
    for k in js:
        assert int(js[k]) == int(ts[k]), (k, int(js[k]), int(ts[k]))


def _cfgs(depth, max_level=0, layout="packed"):
    jl, tl = (JP, TP) if layout == "packed" else (jlayout.UNPACKED, tlayout.UNPACKED)
    return (jconc.TreeConfig(depth=depth, max_level=max_level, layout=jl),
            tconc.TreeConfig(depth=depth, max_level=max_level, layout=tl))


def _disjoint_nodes(rng, depth, n, taken=(), lo_level=0):
    """Up to n random nodes, none inside or above another or `taken`."""
    out = list(taken)

    def overlaps(a, b):
        la, lb = a.bit_length(), b.bit_length()
        return (a >> max(la - lb, 0)) == b if la >= lb else (b >> (lb - la)) == a

    for _ in range(4 * n):
        lev = int(rng.integers(lo_level, depth + 1))
        node = int((1 << lev) + rng.integers(0, 1 << lev))
        if not any(overlaps(node, o) for o in out):
            out.append(node)
        if len(out) >= len(taken) + n:
            break
    return out[len(taken):]


def _mask(depth, nodes):
    m = np.zeros(1 << (depth + 1), bool)
    m[list(nodes)] = True
    return m


# ---------------------------------------------------------------------------
# Layout passes, depths 3..14
# ---------------------------------------------------------------------------

DEPTHS = list(range(3, 15))


@pytest.mark.parametrize("depth", DEPTHS)
def test_layers_and_word_count(depth):
    jt, tt = _cfgs(depth)
    assert tlayout._bunch_layers(depth, 3) == jlayout._bunch_layers(depth, 3)
    assert TP.layers(tt) == JP.layers(jt)
    assert tt.n_state_words == jt.n_state_words
    assert TP.state_dtype == torch.int32
    layers = TP.layers(tt)
    assert layers[-1][1] == depth and layers[0][0] == 0   # bottom-aligned
    assert all(F - L == 2 for L, F, _ in layers[1:])       # partial layer on top


@pytest.mark.parametrize("depth", DEPTHS)
def test_layout_passes_match(depth):
    """commit_allocs twice (winners at every level), then derive,
    allocatable, node_occ_at, both logical counts and apply_frees on the
    resulting canonical state."""
    jt, tt = _cfgs(depth, max_level=depth % 3)
    rng = np.random.default_rng(depth)
    jstate, tstate = JP.empty_tree(jt), TP.empty_tree(tt, "cpu")[None]
    live = []
    for rnd in range(2):
        wins = _disjoint_nodes(rng, depth, 12 + 8 * rnd, live, jt.max_level)
        live += wins
        m = _mask(depth, wins)
        jstate, jm = _J["commit_allocs"](jt, jstate, jnp.asarray(m))
        tstate, tm = TP.commit_allocs(tt, tstate, _t(m)[None])
        _eq(jstate, tstate[0], "commit words")
        _eq(jm, tm[0], "commit merged")
        win = np.zeros(24, bool)
        win[: min(len(wins), 24)] = True
        lv = np.array([n.bit_length() - 1 for n in wins[:24]] + [0] * 24, np.int32)[:24]
        _eq(_J["alloc_logical_rmws"](jt, jnp.asarray(win), jnp.asarray(lv)),
            TP.alloc_logical_rmws(tt, _t(win)[None], _t(lv)[None])[0], "alloc logical")
    for j, t, what in zip(_J["derive"](jt, jstate), TP.derive(tt, tstate),
                          ("any5", "occ", "busy")):
        _eq(j, t[0], what)
    _eq(_J["allocatable"](jt, jstate), TP.allocatable(tt, tstate)[0], "allocatable")
    probe = rng.integers(1, 1 << (depth + 1), size=32).astype(np.int32)
    probe[: min(len(live), 16)] = live[:16]
    _eq(_J["node_occ_at"](jt, jstate, jnp.asarray(probe)),
        TP.node_occ_at(tt, tstate, _t(probe)[None])[0], "node_occ_at")
    # frees: half the live nodes, one ancestor of a live node (a junk
    # handle that still has derived OCC when both halves are live)
    tgt = np.zeros(24, np.int32)
    valid = np.zeros(24, bool)
    pick = rng.permutation(len(live))[: len(live) // 2][:20]
    tgt[: len(pick)] = np.array(live, np.int32)[pick]
    valid[: len(pick)] = True
    _eq(_J["free_logical_rmws"](jt, jstate, jnp.asarray(tgt), jnp.asarray(valid)),
        TP.free_logical_rmws(tt, tstate, _t(tgt)[None], _t(valid)[None])[0],
        "free logical")
    fm = _mask(depth, tgt[valid])
    fm[0] = False
    js, jmerged = _J["apply_frees"](jt, jstate, jnp.asarray(fm))
    ts, tmerged = TP.apply_frees(tt, tstate, _t(fm)[None])
    _eq(js, ts[0], "apply_frees words")
    _eq(jmerged, tmerged[0], "apply_frees merged")
    # the rebuild is the identity on a canonical state with nothing freed
    ts2, tm2 = TP.apply_frees(tt, ts, torch.zeros_like(_t(fm)[None]))
    assert torch.equal(ts2, ts) and int(tm2[0]) == 0
