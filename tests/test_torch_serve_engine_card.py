"""The host-loop `ServeEngine` on the card against the same engine on the
CPU.

These tests import torch, numpy and the port only (the machine with the
card has no JAX); without a card each skips with its reason.  On one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_engine_card.py

With no EOS the schedule does not depend on the tokens, so the card's
run of a trace must give the CPU run's `stats`, `step_log`, block
tables, trees and `fragmentation()` exactly, at stablelm-3b's reduced
config, and launch kernel B once per layer and decode step and kernel A
never (the host loop allocates on the host).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import nbbs_alloc, paged_attention as pa
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine
from torch_card import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def _trace(seed, n=10):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 200, size=int(rng.integers(1, 14))).astype(np.int32),
             int(rng.integers(1, 9))) for i in range(n)]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _run(cfg, params, device, dtype, trace, **kw):
    eng = ServeEngine(cfg, params, num_pages=64, page_tokens=4, max_batch=4, dtype=dtype,
                      device=device, log_stats=True, **kw)
    tables = []
    for i, p, mn in trace:
        eng.submit(Request(i, p.copy(), mn))
    for _ in range(500):
        if not eng.waiting and not eng.running:
            break
        eng.step()
        tables.append({s: eng.kv.block_table(s, eng.max_pages).tolist() for s in eng.running})
    return eng, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [{}, {"n_shards": 2, "layout": "bunch-packed"},
                                {"n_shards": 2, "fastpath": True, "magazines": 2}],
                         ids=["S1", "S2-packed", "S2-fastpath-magazines"])
def test_serve_engine_on_card_matches_cpu_schedule(cuda_device, dtype, kw):
    cfg = get_config("stablelm-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    on_card = _to(params, cuda_device)
    trace = _trace(3)
    cpu, cpu_tables = _run(cfg, params, "cpu", dtype, trace, **kw)
    b0, a0 = pa.launches, nbbs_alloc.launches
    card, card_tables = _run(cfg, on_card, cuda_device, dtype, trace, **kw)
    assert pa.launches - b0 == cfg.n_layers * card.stats["steps"]
    assert nbbs_alloc.launches == a0   # the host loop allocates on the host
    assert card.pool["k"].device.type == "cuda"
    assert card.stats == cpu.stats
    assert card.step_log == cpu.step_log
    assert card_tables == cpu_tables
    assert [b.tree for b in card.kv.buddies] == [b.tree for b in cpu.kv.buddies]
    assert card.kv.fragmentation() == cpu.kv.fragmentation()
    assert card.kv.free_pages() == 64
    assert {i: len(r.out_tokens) for i, r in card.completed.items()} == {
        i: mn for i, _, mn in trace}
