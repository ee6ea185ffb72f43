"""The port's event ring and engine snapshots against the JAX package.

The ring ops (`obs/ring.py`) are held against JAX's on seeded pushes:
wrap-around, masked-out pushes, `push_many` with up to `cap` accepted
rows, `dropped`, and the zero-capacity ring that only counts.  Then the
port's engine with `ring_capacity` in {0, 8, 4096} runs the trace of
tests/test_serving.py beside the JAX engine (S=1, and S=2 packed, on
stablelm-3b's reduced config): the drained events must be equal field
for field, the ring counters and every other total equal, each
snapshot must pass both packages' `validate_snapshot`, and its Chrome
trace `validate_trace`.  Spans carry wall-clock times, so only their
phases, steps and extra fields (the decode span's `fused` flag
included) are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.obs import ring as jring
from repro.obs import trace_export as jexport
from repro.serve.engine import Request as JRequest
from repro.serve.jit_engine import JitServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models.transformer import params_from_numpy
from repro_torch.obs import ring as tring
from repro_torch.obs import trace_export as texport
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import JitServeEngine

GEOM = dict(num_pages=16, page_tokens=4, max_batch=4, max_lane_pages=8, max_out=16)
W = len(tring.EVENT_FIELDS)


def _same_ring(t, j):
    cap = tring.capacity(t)
    assert cap == jring.capacity(j)
    assert int(t.count) == int(j.count)
    assert int(tring.dropped(t)) == int(jring.dropped(j))
    assert np.array_equal(t.buf[:cap].numpy(), np.asarray(j.buf))
    assert tring.drain(t) == jring.drain(j)


def test_ring_names_match_jax():
    assert tring.EVENT_FIELDS == jring.EVENT_FIELDS
    assert tring.KIND_NAMES == jring.KIND_NAMES
    assert (tring.EV_STEP, tring.EV_ADMIT, tring.EV_RETIRE) == (
        jring.EV_STEP, jring.EV_ADMIT, jring.EV_RETIRE)
    row = tring.event(tring.EV_RETIRE, step=torch.tensor(5), rounds=3)
    assert row.dtype == torch.int32
    assert row.tolist() == np.asarray(
        jring.event(jring.EV_RETIRE, step=5, rounds=3)).tolist()
    assert tring.decode_row(row.tolist()) == jring.decode_row(row.tolist())
    with pytest.raises(KeyError):
        tring.event(tring.EV_STEP, bogus=1)


@pytest.mark.parametrize("cap", [1, 4, 7])
def test_ring_ops_match_jax(cap):
    """A seeded mix of single and batched pushes, masked in and out,
    wrapping the ring many times."""
    rng = np.random.default_rng(cap)
    t, j = tring.make_ring(cap, device="cpu"), jring.make_ring(cap)
    for step in range(40):
        if rng.random() < 0.5:
            vals = rng.integers(-5, 1000, size=W).astype(np.int32)
            mask = bool(rng.random() < 0.7)
            t = tring.push(t, torch.from_numpy(vals), torch.tensor(mask))
            j = jring.push(j, jnp.asarray(vals), jnp.asarray(mask))
        else:
            n = int(rng.integers(1, 7))
            rows = rng.integers(-5, 1000, size=(n, W)).astype(np.int32)
            mask = rng.random(n) < 0.6
            mask[np.nonzero(mask)[0][cap:]] = False   # at most cap accepted
            t = tring.push_many(t, torch.from_numpy(rows), torch.from_numpy(mask))
            j = jring.push_many(j, jnp.asarray(rows), jnp.asarray(mask))
        _same_ring(t, j)
    assert int(t.count) > 2 * cap  # wrapped


def test_zero_capacity_ring_only_counts():
    t, j = tring.make_ring(0, device="cpu"), jring.make_ring(0)
    row = np.arange(W, dtype=np.int32)
    t = tring.push(t, torch.from_numpy(row))
    j = jring.push(j, jnp.asarray(row))
    t = tring.push(t, torch.from_numpy(row), torch.tensor(False))
    j = jring.push(j, jnp.asarray(row), jnp.asarray(False))
    rows, mask = np.stack([row] * 3), np.array([True, False, True])
    t = tring.push_many(t, torch.from_numpy(rows), torch.from_numpy(mask))
    j = jring.push_many(j, jnp.asarray(rows), jnp.asarray(mask))
    _same_ring(t, j)
    assert int(t.count) == 3 and int(tring.dropped(t)) == 3
    assert tring.drain(t) == []


@pytest.fixture(scope="module")
def model():
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg = jget_config("stablelm-3b").reduced()
    cfg = get_config("stablelm-3b").reduced()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


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


def _spans(snap):
    return [{k: v for k, v in sp.items() if k not in ("t0", "t1")}
            for sp in snap["spans"]]


@pytest.mark.parametrize("n_shards,layout", [(1, "unpacked"), (2, "bunch-packed")])
@pytest.mark.parametrize("cap", [0, 8, 4096])
def test_engine_ring_matches_jax(model, n_shards, layout, cap):
    jcfg, cfg, jparams, params = model
    kw = dict(n_shards=n_shards, layout=layout, ring_capacity=cap, **GEOM)
    jeng = JEngine(jcfg, jparams, dtype=jnp.float32, **kw)
    teng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", **kw)
    for i, p, mn in _trace(n_shards * 7 + 1, cfg.vocab_size):
        jeng.submit(JRequest(i, p, mn))
        teng.submit(Request(i, p.copy(), mn))
    jeng.run_to_completion(max_steps=200)
    teng.run_to_completion(max_steps=200)
    assert teng.retired_order == jeng.retired_order
    assert teng.done_steps == jeng.done_steps

    jsnap, tsnap = jeng.snapshot(), teng.snapshot()
    for validate in (texport.validate_snapshot, jexport.validate_snapshot):
        validate(tsnap)
        validate(jsnap)
    assert tsnap["config"] == jsnap["config"]
    assert tsnap["metrics"] == jsnap["metrics"]
    assert tsnap["events"] == jsnap["events"]
    assert _spans(tsnap) == _spans(jsnap)
    assert {sp["phase"] for sp in tsnap["spans"]} == {"admit", "decode", "drain"}

    tot = tsnap["metrics"]
    assert tot["ring_events"] == int(teng.state.ring.count) == tot["steps"]
    assert tot["ring_dropped"] == max(tot["ring_events"] - cap, 0)
    assert len(tsnap["events"]) == min(tot["ring_events"], cap)
    if cap:
        assert tsnap["events"][-1]["step"] == tot["steps"] - 1
        assert tsnap["events"][-1]["free_pages"] == tot["free_pages"] == 16
    trace = texport.chrome_trace(tsnap)
    texport.validate_trace(trace)
    jexport.validate_trace(jexport.chrome_trace(tsnap))
    names = [e["name"] for e in trace["traceEvents"]]
    assert "decode" in names
    assert any(n.startswith("step ") for n in names) == bool(cap)
