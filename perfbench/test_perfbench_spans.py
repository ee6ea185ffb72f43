"""The program's span log under the harness, read by `probe_spans.py`, at
a tiny size on the CPU.

The harness builds `JitServeEngine` without `trace`, so its runs log the
phase records alone.  With the engine traced, as the probe builds it,
the spans account for the window's admissions, the host reads are
counted per request admitted, every request admitted in an open loop
has its queue wait, and in trace A each `serve.prefill` range holds the
harness's `serve_prefill` range of the same call (the harness wraps the
module-level function that the program's span calls), on the profiler's
one clock.  The CPU has no device trace, so the idle shares stay silent.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from perfbench import probe_spans
from perfbench.conftest import tiny_spec

SECONDS = 4.0     # long enough that an open loop finishes its sample under load


def probe(name: str, trace: bool, spans: bool):
    return probe_spans.probe(tiny_spec(name), 2 ** 31 + 77, SECONDS, trace, spans, "cpu",
                             time.perf_counter())


@pytest.mark.parametrize("name", ["stablelm-3b.chat-batch", "stablelm-3b.doc-qa-open"])
def test_spans_account_for_the_window(few_threads, name):
    res, _, got = probe(name, True, True)
    assert res["correct"]
    eng, w = got["engine"], got["window"]
    n = res["admitted"]
    assert n == len(w.admitted()) and res["split_ms_per_request"]["requests"] == n
    assert res["admit_ms_per_request"] == pytest.approx(res["metrics"][
        "admit_ms_per_request." + ("open" if name.endswith("open") else "batch")])
    assert 0.9 < res["split_share_of_admit"] <= 1.0
    assert res["admit_reads_per_request"] >= 1.0    # a claim read per request at least
    reads = res["reads"]
    assert reads["claim"] == reads["attempts"] >= n
    assert res["prefills"] and res["prefill_enqueue_ms_per_request"] > 0
    if name.endswith("open"):
        assert res["queue_wait_n"] == n and res["queue_wait_ms_p95"] >= 0
    else:
        assert "queue_wait_ms_p95" not in res or res["queue_wait_n"] == n

    # trace A: each `serve.prefill` around one harness `serve_prefill`
    ours, theirs = res["trace_prefill_ranges"]
    assert ours and ours == theirs == res["one_clock_nested"]
    assert {nm for nm, *_ in got["traces"][0].serve} >= {
        "admit", "request", "claim", "sync.claim", "prefill", "prefill.attention",
        "prefill.ffn", "insert", "decode", "drain"}
    # no device trace on the CPU: the device readings stay silent
    assert not got["traces"][0].device
    assert "prefill_idle_share" not in res and "admit_idle_s" not in res
    assert all("device_ms" not in r for r in eng.spans)


def test_untraced_engine_logs_the_phases_alone(few_threads):
    res, _, got = probe("stablelm-3b.chat-batch", False, False)
    assert res["correct"]
    eng = got["engine"]
    assert eng.spans and all("parent" not in r for r in eng.spans)
    assert {r["phase"] for r in eng.spans} <= {"admit", "decode", "drain"}
    reads = res["reads"]
    assert reads["claim"] == reads["attempts"] >= res["admitted"] > 0 and reads["lanes"] > 0
    assert "split_ms_per_request" not in res and not got["traces"]


def test_admission_split_accounts_for_admit():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request
    from repro_torch.serve.jit_engine import JitServeEngine

    cfg = get_config("stablelm-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, cfg.vocab_size, size=int(rng.integers(6, 22))).astype(np.int32),
             int(rng.integers(2, 9))) for i in range(10)]

    def served(trace):
        eng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", trace=trace,
                             num_pages=8, page_tokens=4, max_batch=4, max_lane_pages=8,
                             max_out=16)
        for r in reqs:
            eng.submit(Request(*r))
        eng.run_to_completion(max_steps=200, chunk=4)
        return eng

    eng = served(True)
    split = probe_spans.admission_split(eng.spans)
    assert split["requests"] == eng.stats["admitted"] == 10
    admit_ms = sum(r["t1"] - r["t0"] for r in eng.spans if r["phase"] == "admit") * 1e3
    assert all(split[k] >= 0 for k in probe_spans.PARTS) and split["rest"] > -1e-9
    assert sum(split[k] for k in probe_spans.PARTS + ("rest",)) * 10 == pytest.approx(admit_ms)
    assert probe_spans.admission_split(eng.spans, t_lo=eng.spans[-1]["t1"] + 1) == {}
    assert probe_spans.admission_split(served(False).spans) == {}
