"""The port's `JitServeEngine` span log (`obs/spans.py`) and host-read
counters, on stablelm-3b's reduced config on the CPU.

Untraced, the engine logs the phase records it always logged (held
against the JAX engine by tests/test_torch_ring.py and
tests/test_torch_engine_fused.py); traced, those same records gain ids,
and the spans inside them nest by id and by time, one `request` per
admission with its children, and each a `serve.` range under a profiler
with the same nesting.  `host_reads` counts every host read by site, one
per wait for the device.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import init_params, prefill
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import JitServeEngine

# 8 pages for 4 lanes of prompts of 6-21 tokens (2-6 pages): claims fail
# while the pool is full, so some admissions queue
GEOM = dict(num_pages=8, page_tokens=4, max_batch=4, max_lane_pages=8, max_out=16)
CHUNK = 4
TOP = ("admit", "decode", "drain")
REQUEST_CHILDREN = {"queued", "claim", "sync.claim", "prefill", "insert"}


@pytest.fixture(scope="module")
def model():
    cfg = get_config("stablelm-3b").reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _requests(vocab, n=10, seed=5):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, size=int(rng.integers(6, 22))).astype(np.int32),
                    int(rng.integers(2, 9))) for i in range(n)]


def _run(model, trace, chunk=CHUNK, **kw):
    cfg, params = model
    eng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", trace=trace,
                         **dict(GEOM, **kw))
    admits = []
    admit = eng._admit

    def counted():
        admits.append(1)
        admit()

    eng._admit = counted
    for r in _requests(cfg.vocab_size):
        eng.submit(r)
    eng.run_to_completion(max_steps=200, chunk=chunk)
    assert not eng.running and not eng.waiting and len(eng.completed) == 10
    return eng, len(admits)


def _untimed(rec):
    return {k: v for k, v in rec.items() if k not in ("t0", "t1", "id", "parent")}


def _kept_untraced(rec):
    """Today's rule: an admission round that admitted, every chunk, a
    drain that drained."""
    return rec["phase"] == "decode" or ("admitted" in rec or "drained" in rec)


@pytest.mark.parametrize("chunk", [1, CHUNK])
def test_untraced_log_is_the_phase_records(model, chunk):
    plain, _ = _run(model, False, chunk)
    traced, _ = _run(model, True, chunk)
    assert [r.out_tokens for r in plain.completed.values()] == \
        [r.out_tokens for r in traced.completed.values()]
    assert plain.stats == traced.stats and plain.retired_order == traced.retired_order
    for rec in plain.spans:
        assert list(rec)[:5] == ["phase", "t0", "t1", "step0", "step1"]
        assert rec["phase"] in TOP and _kept_untraced(rec)
    # the traced log's top-level records, less ids and the rounds an
    # untraced log leaves out, are the untraced records
    top = [r for r in traced.spans if r["parent"] is None and r["phase"] in TOP]
    assert [_untimed(r) for r in plain.spans] == [_untimed(r) for r in top if _kept_untraced(r)]
    assert {r["phase"] for r in plain.spans} == set(TOP)
    assert plain.host_reads == traced.host_reads
    assert not any("device_ms" in r for r in traced.spans)   # no card, no events


def test_children_nest_in_their_parents(model):
    eng, _ = _run(model, True)
    by_id = {r["id"]: r for r in eng.spans}
    assert len(by_id) == len(eng.spans)
    for r in eng.spans:
        assert r["t0"] <= r["t1"]
        if r["parent"] is None:
            assert r["phase"] in TOP + ("sync.step",)
            continue
        p = by_id[r["parent"]]
        if r["phase"] == "queued":   # from submission to its request's start
            assert p["phase"] == "request" and r["t1"] == p["t0"] and r["req"] == p["req"]
        else:
            assert p["t0"] <= r["t0"] <= r["t1"] <= p["t1"], (r, p)
        assert by_id[r["parent"]]["id"] < r["id"] or r["phase"] == "queued"


def test_each_admission_has_one_request_span(model):
    cfg, _ = model
    eng, _ = _run(model, True)
    assert eng.stats["queued_full"] > 0
    kids = {}
    for r in eng.spans:
        if r["parent"] is not None and "req" in r:
            kids.setdefault(r["parent"], []).append(r)
    requests = [r for r in eng.spans if r["phase"] == "request"]
    # an attempt whose claim failed has `claim` and `sync.claim` alone
    admitted = [r for r in requests if any(c["phase"] == "insert" for c in kids[r["id"]])]
    assert len(requests) == eng.stats["admitted"] + eng.stats["queued_full"]
    assert sorted(r["req"] for r in admitted) == list(range(10))
    for r in admitted:
        children = kids[r["id"]]
        assert sorted(c["phase"] for c in children) == sorted(REQUEST_CHILDREN)
        assert {c["req"] for c in children} == {r["req"]}
        pre = next(c for c in children if c["phase"] == "prefill")
        assert pre["tokens"] == len(eng.completed[r["req"]].prompt)
        assert pre["padded"] == 1 << (pre["tokens"] - 1).bit_length()
        layers = [c["phase"] for c in kids.get(pre["id"], [])]
        assert layers == ["prefill.attention", "prefill.ffn"] * cfg.n_layers
    for r in requests:
        if r not in admitted:
            assert sorted(c["phase"] for c in kids[r["id"]]) == ["claim", "sync.claim"]


@pytest.mark.parametrize("chunk", [1, CHUNK])
def test_host_syncs_count_the_reads(model, chunk):
    eng, n_admit = _run(model, False, chunk)
    drains = len([r for r in _run(model, True, chunk)[0].spans if r["phase"] == "drain"])
    assert eng.host_reads["lanes"] == n_admit
    assert eng.host_reads["claim"] == eng.stats["admitted"] + eng.stats["queued_full"]
    assert eng.host_reads["drain"] == drains
    assert set(eng.host_reads) == {"lanes", "claim", "drain"}


def test_front_end_reads_are_counted(model):
    eng, _ = _run(model, True, fastpath=True, magazines=2)
    attempts = eng.stats["admitted"] + eng.stats["queued_full"]
    assert eng.host_reads["fastpath"] == attempts
    assert eng.host_reads["magazine"] == attempts == eng.host_reads["claim"]
    claims = [r for r in eng.spans if r["phase"] == "sync.claim"]
    assert len(claims) == 3 * attempts     # fastpath pair, magazine, admitted


def test_step_reads_count_as_step(model):
    cfg, params = model
    eng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", trace=True, **GEOM)
    for r in _requests(cfg.vocab_size, n=3):
        eng.submit(r)
    steps = 0
    while eng.step():
        steps += 1
    assert eng.host_reads["step"] == steps + 1
    assert [r["parent"] for r in eng.spans if r["phase"] == "sync.step"] == [None] * (steps + 1)


def test_profiler_ranges_nest_as_the_spans(model):
    cfg, params = model
    eng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", trace=True, **GEOM)
    for r in _requests(cfg.vocab_size, n=4):
        eng.submit(r)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run_to_completion(max_steps=200, chunk=CHUNK)
    ranges = sorted((e for e in prof.events() if e.name.startswith("serve.")),
                    key=lambda e: e.time_range.start)
    spans = sorted((r for r in eng.spans if r["phase"] != "queued"), key=lambda r: r["t0"])
    assert [e.name for e in ranges] == ["serve." + r["phase"] for r in spans]
    by_id = {r["id"]: r for r in eng.spans}

    def serve_parent(e):
        e = e.cpu_parent
        while e is not None and not e.name.startswith("serve."):
            e = e.cpu_parent
        return e

    for e, r in zip(ranges, spans):
        p = serve_parent(e)
        if r["parent"] is None:
            assert p is None
        else:
            assert p.name == "serve." + by_id[r["parent"]]["phase"]
            assert p.time_range.start <= e.time_range.start <= e.time_range.end \
                <= p.time_range.end


def test_layer_spans_only_inside_an_engine_prefill(model):
    cfg, params = model
    eng, _ = _run(model, True)
    n = len(eng.spans)
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prefill(cfg, params, {"tokens": toks}, 8, dtype=torch.float32)
    assert len(eng.spans) == n
    assert not [e for e in prof.events() if e.name.startswith("serve.")]
