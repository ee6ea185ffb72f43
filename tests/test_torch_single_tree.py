"""The port's single-tree alloc op against the Pallas kernel it replaces.

`ops.nbbs_wavefront_alloc` on CPU tensors (the plain version of kernel
4) against JAX's `wavefront_alloc_pallas` run with `interpret=True`, on
the parameter grid of tests/test_kernels.py::TestNBBSKernel and its
fragmented-tree case, each in both tree layouts.  Words (through int64:
uint32 in JAX, int32 with the same bits in the port), nodes, ok and
every slot of the stat row must be identical.  The mixed step (kernel 3)
is in tests/test_torch_single_tree_step.py; the card runs the kernels
themselves in tests/test_torch_kernels_on_card.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import concurrent as jconc
from repro.core import layout as jlayout
from repro.kernels.nbbs_alloc import wavefront_alloc_pallas
from repro.obs.schema import WAVEFRONT_ALLOC_SLOTS
from repro_torch.core import concurrent as tconc
from repro_torch.core import layout as tlayout
from repro_torch.kernels import ops as tops
from test_torch_layout import _eq, _t

LAYOUTS = {
    "unpacked": (jlayout.UNPACKED, tlayout.UNPACKED),
    "packed": (jlayout.BUNCH_PACKED, tlayout.BUNCH_PACKED),
}


def cfgs(depth, layout, max_level=0):
    jl, tl = LAYOUTS[layout]
    return (jconc.TreeConfig(depth=depth, max_level=max_level, layout=jl),
            tconc.TreeConfig(depth=depth, max_level=max_level, layout=tl))


def check_alloc(jt, tt, jtree, ttree, levels, active=None):
    """One alloc wavefront through both; returns the port's result."""
    j = wavefront_alloc_pallas(
        jt, jtree, jnp.asarray(levels),
        active=None if active is None else jnp.asarray(active), interpret=True,
    )
    t = tops.nbbs_wavefront_alloc(tt, ttree, _t(levels),
                                  active=None if active is None else _t(active))
    for a, b, what in zip(j[:3], t[:3], ("tree", "nodes", "ok")):
        _eq(a, b, what)
    assert set(t[3]) == set(WAVEFRONT_ALLOC_SLOTS)
    for i, name in enumerate(WAVEFRONT_ALLOC_SLOTS):
        assert int(j[3][i]) == int(t[3][name]), name
    return t


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("depth,K,seed", [
    (6, 16, 0), (9, 64, 1), (8, 33, 2), (10, 128, 3), (6, 16, 4),
])
def test_wavefront_alloc_matches_pallas(depth, K, seed, layout):
    jt, tt = cfgs(depth, layout)
    rng = np.random.default_rng(seed)
    levels = rng.integers(2, depth + 1, size=K).astype(np.int32)
    t = check_alloc(jt, tt, jt.empty_tree(), tt.empty_tree("cpu"), levels)
    assert int(t[3]["rounds"]) >= 1 and bool(t[2].any())


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_wavefront_alloc_on_fragmented_tree(layout):
    """tests/test_kernels.py::test_on_fragmented_tree: fill 32 leaves,
    free every other one, then a mixed-level wavefront."""
    jt, tt = cfgs(8, layout)
    fill = np.full(32, 8, np.int32)
    t0 = tops.nbbs_wavefront_alloc(tt, tt.empty_tree("cpu"), _t(fill))
    j0 = jconc.wavefront_alloc(jt, jt.empty_tree(), jnp.asarray(fill), jnp.ones(32, bool))
    _eq(j0[0], t0[0], "filled tree")
    half = np.asarray(j0[1])[::2]
    jtree, jw = jconc.free_batch(jt, j0[0], jnp.asarray(half), jnp.ones(16, bool))
    ttree, tw = tconc.free_batch(tt, t0[0], _t(half), torch.ones(16, dtype=torch.bool))
    _eq(jtree, ttree, "fragmented tree")
    assert int(jw) == int(tw)
    check_alloc(jt, tt, jtree, ttree, np.array([4, 5, 8, 8, 6], np.int32))


def test_wavefront_alloc_inactive_and_out_of_range_lanes():
    """Inactive lanes stay empty; a lane whose level lies outside
    [max_level, depth] stays pending until max_rounds (rounds == 64)."""
    jt, tt = cfgs(6, "packed", max_level=1)
    levels = np.array([3, 0, 6, 9, 2, -1], np.int32)
    active = np.array([1, 1, 0, 1, 1, 1], bool)
    t = check_alloc(jt, tt, jt.empty_tree(), tt.empty_tree("cpu"), levels, active)
    assert int(t[3]["rounds"]) == 64
    assert t[2].tolist() == [True, False, False, False, True, False]
