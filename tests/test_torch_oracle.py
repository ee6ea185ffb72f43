"""The port's `HostOracleEngine` against JAX's, and the port's jit-resident
engine against the port's oracle in lockstep.

The oracle runs no model: with no EOS the jit engine's page tables,
retirement order and occupancy depend only on prompt lengths, budgets
and arrivals.  First the port's oracle replays tests/test_serving.py's
traces beside JAX's (sharded, packed geometry, fastpath, magazines,
overflow): the running set and every block table after each admission,
the free pages, and at the end `retired_order`, `done_steps`,
`stat_totals()` and the pool's trees must be equal.  Then the port's
`JitServeEngine` on the CPU against the port's oracle, as
tests/test_serving.py's `test_differential_vs_host_oracle` holds JAX's
engine: page for page after every admission, the same retirements and
counters, and the same per-shard free pages at the end.
"""

import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JRequest
from repro.serve.oracle import HostOracleEngine as JOracle
from repro_torch.configs import get_config
from repro_torch.core.magazine import MagazineState
from repro_torch.core.pool import pool_free_units, pool_mag_free_per_shard
from repro_torch.models.transformer import init_params
from repro_torch.obs import schema
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import JitServeEngine
from repro_torch.serve.oracle import HostOracleEngine

GEOM = dict(num_pages=16, page_tokens=4, max_batch=4, max_lane_pages=8, max_out=16)


def _trace(seed, vocab, n=8, max_prompt=14, max_new=8):
    """tests/test_serving.py::_trace, the same requests."""
    rng = np.random.default_rng(seed)
    return [
        (
            i,
            rng.integers(0, vocab, size=int(rng.integers(1, max_prompt))).astype(np.int32),
            int(rng.integers(1, max_new)),
        )
        for i in range(n)
    ]


def _lockstep(a, b, trace, chunk, decode_a=None, arrivals=None):
    """Drive engines `a` and `b` over `trace` (all at once, or `arrivals`
    requests before each chunk), comparing after every admission."""
    pending = list(trace)
    for _ in range(200):
        for i, p, mn in pending[:arrivals or len(pending)]:
            a.submit((JRequest if isinstance(a, JOracle) else Request)(i, p.copy(), mn))
            b.submit(Request(i, p.copy(), mn))
        del pending[:arrivals or len(pending)]
        a._drain(), a._admit()
        b._drain(), b._admit()
        assert sorted(a.running) == sorted(b.running)
        assert a.stats == b.stats
        if not a.running and not a.waiting and not pending:
            break
        for sid in a.running:
            tab = a.device_block_table(sid) if hasattr(a, "device_block_table") else (
                a.block_table(sid))
            assert (tab == b.block_table(sid)).all(), sid
        free = a.device_free_pages() if hasattr(a, "device_free_pages") else a.free_pages()
        assert free == b.free_pages()
        (decode_a or a.decode_steps)(chunk)
        b.decode_steps(chunk)
    assert not b.running and not b.waiting
    assert a.retired_order == b.retired_order
    assert a.done_steps == b.done_steps


# (n_shards, front ends, trace seed, chunk, requests per arrival)
ORACLE_CASES = [
    (1, {}, 8, 1, None), (2, {}, 15, 1, None), (4, {}, 3, 4, None),
    (1, {"fastpath": True}, 4, 1, 2), (2, {"fastpath": True, "magazines": 2}, 5, 2, 2),
    (4, {"fastpath": True, "magazines": 4}, 6, 4, 3),
]


@pytest.mark.parametrize("case", ORACLE_CASES, ids=lambda c: f"S{c[0]}-" + "-".join(c[1]))
def test_oracle_matches_jax_oracle(case):
    S, kw, seed, chunk, arrivals = case
    j = JOracle(n_shards=S, **GEOM, **kw)
    t = HostOracleEngine(n_shards=S, **GEOM, **kw)
    _lockstep(j, t, _trace(seed, 200, n=12), chunk, arrivals=arrivals)
    assert t.stat_totals() == j.stat_totals()
    assert [b.tree for b in t.pool.buddies] == [b.tree for b in j.pool.buddies]
    assert t.pool.per_shard_free() == j.pool.per_shard_free()
    assert t.pool.fragmentation() == j.pool.fragmentation()
    assert t.free_pages() == GEOM["num_pages"]
    t.pool.check_invariants()
    assert {r: len(q.out_tokens) for r, q in t.completed.items()} == {
        r: len(q.out_tokens) for r, q in j.completed.items()}


def test_oracle_overflow_and_rejection_match_jax():
    """Pool exhaustion mid-decode retires the losing lane; an oversized
    request is rejected: both oracles agree on who and when."""
    kw = dict(num_pages=4, page_tokens=2, max_batch=2, max_lane_pages=4, max_out=8)
    j, t = JOracle(**kw), HostOracleEngine(**kw)
    rng = np.random.default_rng(7)
    for i in range(2):
        p = rng.integers(0, 200, 3).astype(np.int32)
        j.submit(JRequest(i, p, 5))
        t.submit(Request(i, p.copy(), 5))
    j.submit(JRequest(2, np.zeros(30, np.int32), 10))
    t.submit(Request(2, np.zeros(30, np.int32), 10))
    j.run_to_completion(max_steps=60)
    t.run_to_completion(max_steps=60)
    assert t.stats["overflow_retired"] >= 1 and t.stats["rejected"] == 1
    assert t.stat_totals() == j.stat_totals()
    assert t.retired_order == j.retired_order and t.done_steps == j.done_steps
    assert t.free_pages() == j.free_pages() == 4


def test_oracle_stat_names_are_registered():
    t = HostOracleEngine(**GEOM)
    for name in t.stat_totals():
        assert schema.spec(name).name == name
    t.stats["not_a_metric"] = 0
    with pytest.raises(KeyError, match="unregistered metric"):
        t.stat_totals()


# ---------------------------------------------------------------------------
# The port's jit engine against the port's oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg = get_config("stablelm-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


@pytest.mark.parametrize(
    "n_shards,layout,chunk,kw",
    [(1, "unpacked", 1, {}), (2, "unpacked", 1, {}), (2, "bunch-packed", 4, {}),
     (2, "bunch-packed", 2, {"fastpath": True, "magazines": 2})],
    ids=["S1", "S2", "S2-packed-chunk4", "S2-packed-fastpath-magazines"],
)
def test_jit_engine_matches_oracle_in_lockstep(model, n_shards, layout, chunk, kw):
    cfg, params = model
    eng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", n_shards=n_shards,
                         layout=layout, **GEOM, **kw)
    orc = HostOracleEngine(n_shards=n_shards, **GEOM, **kw)
    arrivals = 2 if kw else None   # lanes reused, so magazines can hit
    _lockstep(eng, orc, _trace(n_shards * 7 + chunk, cfg.vocab_size), chunk,
              decode_a=lambda n: eng.decode_steps(n, fused=n > 1), arrivals=arrivals)
    assert len(eng.completed) == 8
    tot, otot = eng.stat_totals(), orc.stat_totals()
    for key, v in otot.items():
        assert tot[key] == v, key
    if kw:
        assert otot["magazine_hits"] > 0 and otot["fastpath_hits"] > 0
    assert eng.device_free_pages() == orc.free_pages() == GEOM["num_pages"]
    pcfg = eng.ecfg.pool_config()
    per_shard = pool_free_units(pcfg, eng.state.trees)
    if kw.get("magazines"):   # stashed pages are claimable
        per_shard = per_shard + pool_mag_free_per_shard(
            pcfg, MagazineState(eng.state.mag_pages, eng.state.mag_depth))
    assert per_shard.tolist() == orc.pool.per_shard_free()
    orc.pool.check_invariants()
