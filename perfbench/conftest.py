"""Tiny versions of the benchmark's cells for the CPU tests: the cells'
own files with the model cut to two narrow layers, a small page pool and
short requests, so that a whole run takes seconds here."""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench import harness

CELLS = ("stablelm-3b.chat-batch", "phi3.5-moe-16l.chat-batch", "stablelm-3b.doc-qa-open")


def tiny_spec(name: str) -> dict:
    spec = copy.deepcopy(harness.cell_spec(name))
    arch = spec["config"]["arch"]
    arch.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                vocab_size=256)
    if arch.get("n_experts"):
        arch.update(n_experts=4, top_k=2)
    cell = spec["cell"]
    cell["engine"] = dict(num_pages=256, page_tokens=4, max_batch=8, max_lane_pages=32,
                          max_out=24)
    cell.update(ramp_chunks=1, warm_s=0.3, grace_s=5.0, trace_s=0.3)
    cell["check"]["sample"] = 2
    if "rate_per_s" in cell:
        cell["rate_per_s"] = 6.0
    traffic = spec["traffic"]
    traffic["prompt"] = dict(median=24, sigma=0.5, min=8, max=96)
    traffic["output"] = dict(median=12, sigma=0.4, min=4, max=24)
    traffic["pool"] = 64
    return spec


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)
