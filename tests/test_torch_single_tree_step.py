"""The port's single-tree mixed step against the Pallas kernel it replaces.

`ops.nbbs_wavefront_step` on CPU tensors (the plain version of kernel
3) against JAX's `wavefront_step_pallas` with `interpret=True` and its
`ops.nbbs_wavefront_step` dispatcher, on the parameter grid of
tests/test_kernels.py::TestNBBSKernel, each in both tree layouts.  Words
(through int64), nodes, ok and all six stat slots must be identical, and
the release half alone (`nbbs_alloc.wavefront_free`, K=0) must give
the step's release counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import concurrent as jconc
from repro.kernels import ops as jops
from repro.kernels.nbbs_alloc import wavefront_step_pallas
from repro.obs.schema import WAVEFRONT_STEP_SLOTS
from repro_torch.core import concurrent as tconc
from repro_torch.kernels import nbbs_alloc
from repro_torch.kernels import ops as tops
from test_torch_layout import _eq, _t
from test_torch_single_tree import cfgs


def _fragment(jt, tt, rng, n, depth):
    """A tree with n mixed-level allocations, in both packages' dtypes."""
    ttree, nodes, ok, _ = tconc.wavefront_alloc(
        tt, tt.empty_tree("cpu"), _t(rng.integers(2, depth + 1, size=n).astype(np.int32)),
        torch.ones(n, dtype=torch.bool),
    )
    jtree = jnp.asarray(ttree.numpy().astype(np.dtype(jt.layout.state_dtype)))
    return jtree, ttree, nodes.numpy(), ok.numpy()


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("depth,K,F,seed", [
    (6, 16, 8, 0), (8, 33, 16, 1), (9, 64, 64, 2), (7, 24, 12, 3),
])
def test_wavefront_step_matches_pallas(depth, K, F, seed, layout):
    jt, tt = cfgs(depth, layout)
    rng = np.random.default_rng(seed)
    jtree, ttree, nodes, ok = _fragment(jt, tt, rng, 2 * F, depth)
    fn, fa = nodes[:F].astype(np.int32), ok[:F].copy()
    fa[-1] = True
    fn[-1] = fn[0]                      # a duplicate handle
    levels = rng.integers(1, depth + 1, size=K).astype(np.int32)
    j = wavefront_step_pallas(jt, jtree, jnp.asarray(fn), jnp.asarray(fa),
                              jnp.asarray(levels), interpret=True)
    t = tops.nbbs_wavefront_step(tt, ttree, _t(fn), _t(fa), _t(levels))
    for a, b, what in zip(j[:3], t[:3], ("tree", "nodes", "ok")):
        _eq(a, b, what)
    for i, name in enumerate(WAVEFRONT_STEP_SLOTS):
        assert int(j[3][i]) == int(t[3][name]), name
    assert int(t[3]["free_writes"]) == int(t[3]["free_merged_writes"])
    # the release half alone gives the step's release counts
    tf = nbbs_alloc.wavefront_free(tt, ttree, _t(fn), _t(fa))
    assert int(tf[1].sum()) == int(j[3][5]) < int(fa.sum())   # the duplicate is dropped
    assert int(tf[2]["merged_writes"]) == int(j[3][3])
    assert int(tf[2]["logical_rmws"]) == int(j[3][4])


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_wavefront_step_ops_dispatch(layout):
    """tests/test_kernels.py::test_mixed_step_ops_dispatch: JAX's
    reference dispatch against the port's op."""
    jt, tt = cfgs(6, layout)
    fill = np.full(8, 6, np.int32)
    jtree, nodes, _, _ = jconc.wavefront_alloc(jt, jt.empty_tree(), jnp.asarray(fill),
                                               jnp.ones(8, bool))
    fn = np.asarray(nodes)[:4]
    levels = np.array([2, 5, 6], np.int32)
    j = jops.nbbs_wavefront_step(jt, jtree, jnp.asarray(fn), jnp.ones(4, bool),
                                 jnp.asarray(levels), impl="reference")
    t = tops.nbbs_wavefront_step(tt, _t(np.asarray(jtree)).to(torch.int32), _t(fn),
                                 torch.ones(4, dtype=torch.bool), _t(levels))
    for a, b, what in zip(j[:3], t[:3], ("tree", "nodes", "ok")):
        _eq(a, b, what)
    for k in j[3]:
        assert int(j[3][k]) == int(t[3][k]), k
