"""The reference against the port's CPU path, and whole runs with the
timed path broken underneath, each of which has to come out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness
from perfbench.conftest import tiny_spec
from perfbench.reference import model
from perfbench.weights import make_params

SEED = 2 ** 31 + 77


@pytest.mark.parametrize("name", ["stablelm-3b.chat-batch", "phi3.5-moe-16l.chat-batch"])
def test_reference_matches_the_port_in_float32(name, few_threads):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.transformer import prefill

    arch = tiny_spec(name)["config"]["arch"]
    params = make_params(arch, SEED, "cpu", torch.float32)
    tokens = torch.randint(0, arch["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(1))
    got, _ = prefill(ArchConfig(**arch), params, {"tokens": tokens}, 40, dtype=torch.float32)
    want = model.logits(arch, params, tokens[0], 39)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max())


@pytest.mark.parametrize("name", ["stablelm-3b.chat-batch", "phi3.5-moe-16l.chat-batch"])
def test_served_tokens_are_the_references_best_in_float32(name, few_threads):
    spec = tiny_spec(name)
    spec["config"]["dtype"] = "float32"
    out, _ = harness.run(spec, SEED, 2.0, False, "cpu", time.perf_counter())
    assert out["correct"]
    gap = out["checks"].get("served_gap_sd") or {"value": out["readings"]["served_gap_sd"]}
    assert gap["value"] < 1e-3


def unchanged(je):
    def run(ecfg, params, state, n):
        return je._zero_metrics(ecfg, state.ctx.device)
    return "engine_run", run


def half_batch(je):
    """Each step leaves out half of its lanes (alternate halves), so every
    request is served some tokens computed without its own."""
    orig = je.paged_decode_step
    steps = [0]

    def run(*a, active=None, **kw):
        active = active.clone()
        active[steps[0] % 2::2] = False
        steps[0] += 1
        return orig(*a, active=active, **kw)
    return "paged_decode_step", run


def altered_token(je):
    orig = je.paged_decode_step

    def run(*a, **kw):
        return orig(*a, **kw).roll(1, dims=-1)
    return "paged_decode_step", run


def leaked_pages(je):
    orig = je.nb_pool_free_pages

    def run(pcfg, trees, shard, off, active, *a, **kw):
        return orig(pcfg, trees, shard, off, torch.zeros_like(active), *a, **kw)
    return "nb_pool_free_pages", run


@pytest.mark.parametrize("fault,caught_by", [
    (None, None), (unchanged, "sample_short"), (half_batch, "served_gap_sd_mean"),
    (altered_token, "served_gap_sd_mean"), (leaked_pages, "pages_leaked"),
])
@pytest.mark.parametrize("name", ["stablelm-3b.chat-batch", "phi3.5-moe-16l.chat-batch"])
def test_a_broken_timed_path_is_not_correct(name, fault, caught_by, monkeypatch, few_threads):
    from repro_torch.serve import jit_engine as je

    if fault is not None:
        monkeypatch.setattr(je, *fault(je))
    out, lines = harness.run(tiny_spec(name), SEED, 2.0, False, "cpu", time.perf_counter())
    failing = sorted(k for k, c in out["checks"].items() if c["value"] > c["limit"])
    assert out["correct"] is (fault is None), lines
    assert (caught_by in failing) if fault else failing == [], failing
