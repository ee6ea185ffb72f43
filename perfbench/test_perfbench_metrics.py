"""The yardstick's arithmetic: whole-window rates and percentiles, the
operation and byte models against hand counts at tiny shapes, the
trace-based readers, and the page pool's invariants."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import costs, harness, stats, tracing
from perfbench.harness import Req, RunData, Window
from perfbench.reference import pages

TINY = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "d_ff": 16,
        "vocab_size": 10, "tie_embeddings": False}


@pytest.mark.parametrize("q", [0, 25, 50, 95, 99, 100])
def test_percentile_is_numpys_linear_rule(q):
    v = list(np.random.default_rng(q).normal(size=37))
    assert stats.percentile(v, q) == pytest.approx(float(np.percentile(v, q)))


def test_ctx_sum_counts_each_token():
    S, first, last = 17, 3, 11
    assert stats.ctx_sum(S, first, last) == sum(S + j for j in range(first, last))


def test_matmul_params_hand_count():
    # attention 8*(2*8 + 2*4) = 192, mlp 3*8*16 = 384, per layer 576; head 80
    assert costs.matmul_params_per_token(TINY) == 2 * 576 + 80
    moe = dict(TINY, n_experts=4, top_k=2)
    # experts 3*8*16*2 = 768 plus router 8*4 = 32
    assert costs.matmul_params_per_token(moe, lm_head=False) == 2 * (192 + 768 + 32)


def test_flop_models_hand_count():
    # 4 * Hq * D * pairs * layers
    assert costs.attention_flops(TINY, 10) == 4 * 2 * 4 * 10 * 2
    assert costs.decode_flops(TINY, 3, 10) == 2 * 1232 * 3 + 640
    # prompt of 4: 2 * 1152 * 4 matmul operations, 10 causal pairs
    assert costs.prefill_flops(TINY, 4) == 2 * 1152 * 4 + 4 * 2 * 4 * 10 * 2


def test_paged_attention_bytes_hand_count():
    nbytes, flops = costs.paged_attention_cost(TINY, [5, 0, 9], page_tokens=4)
    # K and V: 14 rows x 1 kv head x 4 x 2 B each; q and out: 2 lanes x 2 x 4 x 2 B;
    # tables: 2 + 3 pages x 4 B; lengths 2 x 4 B
    assert nbytes == 2 * 14 * 4 * 2 + 2 * 2 * 2 * 4 * 2 + 4 * 5 + 4 * 2
    assert flops == 4 * 2 * 4 * 14
    assert costs.roofline_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert costs.roofline_seconds(0, 989e12) == pytest.approx(1.0)
    # a page of 4 positions: K and V x 2 layers x 1 kv head x 4 x 2 B
    assert costs.kv_page_bytes(TINY, 4) == 2 * 2 * 1 * 4 * 4 * 2


def window():
    """A window from 10.0 to 20.0 s: request 1 ran through it, 2 finished
    in it, 3 finished before it, 4 started in it; 5 and 6 were due in it."""
    reqs = [
        Req(1, 100, 50, None, 0.0, 0, first_t=5.0, done_t=None),
        Req(2, 50, 20, None, 0.0, 1, first_t=8.0, done_t=15.0, served=20),
        Req(3, 10, 8, None, 0.0, 0, first_t=2.0, done_t=9.0, served=8),
        Req(4, 30, 40, None, 0.0, 5, first_t=12.0, done_t=None),
        Req(5, 30, 40, 11.0, 11.5, 6, first_t=12.0, done_t=19.0, served=40),
        Req(6, 30, 40, 19.5, 19.6, None),
    ]
    return Window(10.0, 20.0, 10.0, reqs, before={1: 10, 2: 12}, after={1: 30, 4: 6},
                  iters=(4, 9), admit_s=0.5, grace_end=25.0, stats0={}, stats1={},
                  queue=(0, 0), chunk_ms=[4.0, 6.0], live_pages=[3, 5], chunk=8)


def run_data(w, trace=None):
    return RunData(TINY, {"engine": {"page_tokens": 4}}, 3.5, w, trace)


def test_tokens_per_s_counts_every_token_of_the_window():
    w = window()
    # request 1: 20, request 2: 8, request 4: 6; request 5 (not in `before`): 40
    assert harness.reader("tokens_per_s")(run_data(w)) == pytest.approx((20 + 8 + 6 + 40) / 10)
    assert harness.reader("setup_s")(run_data(w)) == 3.5


def test_latency_percentiles_cover_the_whole_window():
    w = window()
    tpot = harness.reader("tpot_ms_p95")(run_data(w))
    vals = [(15.0 - 8.0) / 19 * 1e3, (19.0 - 12.0) / 39 * 1e3]
    assert tpot == pytest.approx(stats.percentile(vals, 95))
    # due in the window: 5 (first token at 12.0) and 6 (none by the grace's end)
    ttft = harness.reader("ttft_ms_p95")(run_data(w))
    assert ttft == pytest.approx(stats.percentile([1000.0, 5500.0], 95))


def test_device_time_readers():
    w = window()
    d = run_data(w)
    assert harness.reader("decode_step_ms.batch")(d) == pytest.approx(10.0 / 16)
    assert harness.reader("admit_ms_per_request.open")(d) == pytest.approx(500.0 / 2)  # requests 4 and 5
    spans = w.token_spans()
    flops = costs.decode_flops(TINY, sum(b - a for _, a, b in spans),
                               sum(stats.ctx_sum(r.prompt_len, a, b) for r, a, b in spans))
    assert harness.reader("decode_mfu")(d) == pytest.approx(100 * flops / 0.010 / 989e12)
    # no trace: the readers of device records stay silent
    assert harness.reader("prefill_mfu")(d) is None


def test_trace_readers():
    lanes = [(5, 0, 3, True), (9, 1, 2, True), (0, 0, 0, False)]
    trace = {"decode": {"steps": 2, "lanes": lanes, "kernels_us": {
                 "void paged_decode_kernel<bf16>": 4.0, "nbbs_step_kernel<0>": 1.0,
                 "nvjet_tst_64x8": 3.0, "sm90_xmma_gemm": 1.0, "elementwise": 7.0}},
             "loop": {"busy_s": 0.75, "window_s": 1.0, "prefill_prompts": [30, 50],
                      "prefill_ranges": 2, "prefill_busy_us": 2000.0}}
    d = run_data(window(), trace)
    pre = costs.prefill_flops(TINY, 30) + costs.prefill_flops(TINY, 50)
    assert harness.reader("prefill_mfu")(d) == pytest.approx(100 * pre / 0.002 / 989e12)
    # a prefill whose device range the trace lost: no reading, not a high one
    trace["loop"]["prefill_ranges"] = 1
    assert harness.reader("prefill_mfu")(d) is None
    assert harness.reader("gemm_ms_per_step")(d) == pytest.approx(4.0 / 1e3 / 2)
    assert harness.reader("nbbs_us_per_step")(d) == pytest.approx(0.5)
    assert harness.reader("device_idle_share.open")(d) == pytest.approx(25.0)
    # step 0: lanes at 6 and 10; step 1: lane 0 at 7 (lane 1 has served its 2)
    bound = sum(costs.roofline_seconds(*costs.paged_attention_cost(TINY, c, 4))
                for c in ([6, 10], [7])) * TINY["n_layers"]
    assert harness.reader("paged_attention_roofline")(d) == pytest.approx(100 * bound / 4e-6)
    assert harness.reader("gemm_ms_per_step")(run_data(window())) is None


def test_busy_within_counts_device_time_inside_the_ranges():
    def ev(a, b):
        return SimpleNamespace(time_range=SimpleNamespace(start=a, end=b))
    events = [ev(0, 10), ev(5, 15), ev(20, 30), ev(40, 50)]
    # busy: [0, 15], [20, 30], [40, 50]; ranges [8, 25] and [45, 60]
    assert tracing.busy_within(events, [(8, 25), (45, 60)]) == pytest.approx(7 + 5 + 5)
    assert tracing.busy_within(events, []) == 0


def tree_for(depth, held):
    t = np.zeros(2 << depth, np.int32)
    for p in held:
        t[(1 << depth) + p] = 0x13
    return t


def test_page_checks_sound_pool():
    tables = np.array([[3, 5, -1], [0, -1, -1], [-1, -1, -1]])
    got = pages.page_checks(tree_for(3, [3, 5, 0]), tables, np.array([8, 2, 0]),
                            np.array([True, True, False]), 4, 8)
    assert got == dict.fromkeys(got, 0)


@pytest.mark.parametrize("fault,key", [
    ("twice", "pages_mapped_twice"), ("leak", "pages_leaked"), ("free", "pages_not_reserved"),
    ("short", "lanes_misfit"), ("range", "pages_out_of_range"), ("interior", "interior_reserved"),
])
def test_page_checks_catch_each_fault(fault, key):
    tables = np.array([[3, 5, -1], [0, -1, -1], [-1, -1, -1]])
    ctx, held = np.array([8, 2, 0]), [3, 5, 0]
    tree = tree_for(3, held)
    if fault == "twice":
        tables[1, 1] = 3
        ctx[1] = 5
    elif fault == "leak":
        tree[(1 << 3) + 6] = 0x13
    elif fault == "free":
        tree[(1 << 3) + 5] = 0
    elif fault == "short":
        ctx[0] = 9
    elif fault == "range":
        tables[1, 1] = 8
        ctx[1] = 5
    else:
        tree[2] = 0x10
    got = pages.page_checks(tree, tables, ctx, np.array([True, True, False]), 4, 8)
    assert got[key] >= 1
