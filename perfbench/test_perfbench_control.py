"""The control, the reference in fp8 put in the program's place, has to
come out not correct by each cell's own limits, where served tokens that
agree with the reference come out correct."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import generator, harness
from perfbench.conftest import tiny_spec
from perfbench.reference import compare, model
from perfbench.weights import make_params

SEED = 2 ** 31 + 91


def greedy(arch, params, prompt, n):
    """`n` tokens after `prompt`, each the float32 reference's best."""
    seq = torch.as_tensor(prompt, dtype=torch.int64)
    out = []
    for _ in range(n):
        nxt = model.logits(arch, params, seq, seq.numel() - 1)[-1].argmax()
        out.append(int(nxt))
        seq = torch.cat([seq, nxt[None]])
    return out


@pytest.mark.parametrize("name,layers", [("stablelm-3b.chat-batch", 4),
                                         ("phi3.5-moe-16l.chat-batch", 8),
                                         ("stablelm-3b.doc-qa-open", 4)])
def test_control_separates(name, layers, few_threads):
    """Requests of the cell's traffic served by the reference's own greedy
    tokens; the control's first tokens at the same positions, judged by
    `harness.judge` with the cell's limits as a run's are.  The gap is in
    standard deviations of a position's logits, whose extremes grow with
    the vocabulary, and fp8's error with depth and the routing's choices,
    so the small model here keeps the configuration's vocabulary and
    experts and has layers of width 128, eight where top-2 routing
    among 16 experts has to flip."""
    spec = tiny_spec(name)
    arch = spec["config"]["arch"]
    own = harness.cell_spec(name)["config"]["arch"]
    arch.update({k: own[k] for k in ("vocab_size", "n_experts", "top_k") if k in own},
                n_layers=layers, d_model=128, head_dim=32, d_ff=160)
    params = make_params(arch, SEED, "cpu", getattr(torch, spec["config"]["dtype"]))
    stream = generator.Stream(spec["traffic"], SEED, arch["vocab_size"],
                              spec["cell"].get("rate_per_s"))
    sample = []
    for _ in range(24):                     # some hundreds of served tokens
        _, prompt, new, _ = stream.next()
        sample.append({"prompt": prompt, "served": greedy(arch, params, prompt, new)})
    gap, ctrl = compare.served_gap(arch, params, sample, "cpu", control=True)
    compared = gap.pop("compared")
    limits = spec["cell"]["check"]["limits"]
    checks, _, correct = harness.judge(gap, limits, compared)
    c_checks, c_info, c_correct = harness.judge(ctrl, limits, compared)
    assert correct and not c_correct, c_checks
    assert set(c_checks) == {k for k in limits if k.startswith("served_gap")}
    assert gap["served_gap_sd"] == 0.0
    assert ctrl["served_gap_sd_mean"] > 0


def test_a_run_judges_its_control(few_threads):
    """A whole run with `control`: the program correct, its control not,
    by the same limits (the stablelm-3b chat cell, whose control fails
    its limits at any size that keeps the vocabulary)."""
    name = "stablelm-3b.chat-batch"
    spec = tiny_spec(name)
    spec["config"]["arch"]["vocab_size"] = harness.cell_spec(name)["config"]["arch"]["vocab_size"]
    # a busy machine finishes fewer requests in a window: lengthen it until
    # the sample is full
    for seconds in (3.0, 6.0, 12.0):
        out, lines = harness.run(spec, 5, seconds, False, "cpu", time.perf_counter(),
                                 control=True)
        if out["checks"]["sample_short"]["value"] == 0:
            break
    assert out["correct"], lines
    ctrl = out["control"]
    assert ctrl["correct"] is False and set(ctrl) == {"correct", "checks", "readings"}
    assert set(ctrl["checks"]) == {"served_gap_sd", "served_gap_sd_mean"}
    assert any(c["value"] > c["limit"] for c in ctrl["checks"].values())
