"""The port's engine with the allocator front ends against the JAX
engine, step for step, on two shards in the packed layout.

The (S=2, bunch-packed) half of tests/test_torch_engine_frontends.py
(same geometry, traces and checks: the fastpath, magazines and both),
plus an overflowing trace on one shard with magazines of 2, where the
engine's exhaustion spill-back and retry must retire the same sequences
on the same steps as JAX's.
"""

import numpy as np
import pytest

from test_torch_engine_frontends import FRONTENDS, _step_exact, check_frontends, model  # noqa: F401


@pytest.mark.parametrize("front", sorted(FRONTENDS))
def test_step_exact_with_frontends_sharded(model, front):  # noqa: F811
    check_frontends(model, 2, "bunch-packed", front)


def test_overflow_trace_spills_magazines_back(model):  # noqa: F811
    _, cfg, _, _ = model
    geom = dict(num_pages=4, page_tokens=2, max_batch=2, max_lane_pages=4, max_out=8)
    rng = np.random.default_rng(7)
    trace = []
    for i in range(6):
        p = rng.integers(0, cfg.vocab_size, int(rng.integers(1, 5))).astype(np.int32)
        trace.append((i, p, int(rng.integers(2, 8))))
    _, tot = _step_exact(model, trace, geom, magazines=2)
    assert tot["overflow_retired"] > 0 and tot["magazine_spills"] > 0
