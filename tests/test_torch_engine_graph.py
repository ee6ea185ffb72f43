"""The fused decode chunk as a captured CUDA graph, on the card.

These tests import torch, numpy and the port only (the machine with the
card has no JAX).  Without a card each test skips with its reason; on
one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_engine_graph.py

`JitServeEngine.decode_steps(n, fused=True)` on a CUDA engine runs its
first chunk of each n eagerly, captures it into a `torch.cuda.CUDAGraph`
and replays the graph for every later chunk of that n.  Two engines of
the reduced stablelm-3b (fp32, 64 pages of 4 tokens, 4 lanes, S=2) serve
the same six requests (6-16 new tokens) in the six front-end variants of
tests/test_torch_kernels_on_card.py::test_engine_decode_has_no_host_sync,
one through fused chunks of 4 and of 1 with eager chunks of 2 between
them, the other through the eager loop alone.  Before every chunk every
state tensor (the KV pool, block tables, ring included), the metric
accumulator, the retirement order and steps and every token must be
equal bit for bit; every chunk, the capture included, runs under
`torch.cuda.set_sync_debug_mode("error")`; each chunk length is captured
once (`CAPTURE_COUNTS`); and every fused chunk, replays included, adds
to the kernels' launch counters what the eager chunk of that length
launches.  A replay runs no Python step.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import counters as kcounters
from repro_torch.models.transformer import init_params
from repro_torch.obs import metrics as om
from repro_torch.serve import jit_engine as je
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import JitServeEngine
from torch_card import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda

GEOM = dict(num_pages=64, page_tokens=4, max_batch=4, max_lane_pages=8, max_out=16,
            n_shards=2)
FRONTENDS = [
    ("unpacked", {}), ("bunch-packed", {}),
    ("unpacked", {"fastpath": True}), ("bunch-packed", {"fastpath": True, "magazines": 2}),
    ("unpacked", {"ring_capacity": 16}), ("bunch-packed", {"ring_capacity": 4}),
]
# (steps, fused) of the fused engine's decode calls, in turn
PLAN = ((4, True), (1, True), (2, False))


def _engines(dev, layout, frontends, n=2):
    cfg = get_config("stablelm-3b").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engs = [JitServeEngine(cfg, params, device=dev, layout=layout, **GEOM, **frontends)
            for _ in range(n)]
    rng = np.random.default_rng(0)
    for i in range(6):
        p = rng.integers(0, 256, int(rng.integers(2, 9))).astype(np.int32)
        mn = int(rng.integers(6, 17))
        for eng in engs:
            eng.submit(Request(i, p.copy(), mn))
    return engs


def _no_sync(fn, *args, **kw):
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _same_engines(a, b):
    for k, v in vars(a.state).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(b.state, k)), k
    assert torch.equal(a.state.ring.buf, b.state.ring.buf)
    assert torch.equal(a.state.ring.count, b.state.ring.count)
    assert om.to_host(a.acc) == om.to_host(b.acc)
    assert a.retired_order == b.retired_order and a.done_steps == b.done_steps
    assert sorted(a.completed) == sorted(b.completed)
    for sid, req in b.completed.items():
        assert a.completed[sid].out_tokens == req.out_tokens, sid


@pytest.mark.parametrize("layout,frontends", FRONTENDS)
def test_graph_replay_matches_eager_loop(cuda_device, layout, frontends):
    fused, eager = _engines(cuda_device, layout, frontends)
    key = {n: (fused.ecfg, n) for n, _ in PLAN}
    captures0 = {n: je.CAPTURE_COUNTS[k] for n, k in key.items()}
    replays = 0
    for i in range(200):
        for eng in (fused, eager):
            eng._drain(), eng._admit()
        assert sorted(fused.running) == sorted(eager.running)
        _same_engines(fused, eager)
        if not fused.running and not fused.waiting:
            break
        n, f = PLAN[i % len(PLAN)]
        c0 = kcounters.launch_counts()
        _no_sync(eager.decode_steps, n)
        per_chunk = kcounters.since(c0)
        replays += f and n in fused._graphs
        c0 = kcounters.launch_counts()
        _no_sync(fused.decode_steps, n, fused=f)
        # the warm-up chunk launched, the capture did not, a replay does
        assert kcounters.since(c0) == per_chunk
        if f:
            assert je.CAPTURE_COUNTS[key[n]] == captures0[n] + 1
    assert len(fused.completed) == 6 and replays >= 2
    assert fused.device_free_pages() == eager.device_free_pages() == 64
    assert [sp["fused"] for sp in fused.spans if sp["phase"] == "decode"][:3] == [1, 1, 0]
    tot = fused.stat_totals()
    if frontends.get("fastpath"):
        assert tot["fastpath_hits"] > 0
    if frontends.get("magazines"):
        assert tot["magazine_hits"] > 0
    if frontends.get("ring_capacity"):
        assert fused.snapshot()["events"] == eager.snapshot()["events"]


def test_replays_run_no_python_step(cuda_device, monkeypatch):
    """After the first chunk a fused chunk of the same length is a replay:
    with the step taken away it still decodes, captures nothing, and the
    counters gain (captures + replays) x the chunk's launches."""
    (eng,) = _engines(cuda_device, "bunch-packed", {"fastpath": True, "magazines": 2}, 1)
    eng._admit()
    key = (eng.ecfg, 3)
    captures0 = je.CAPTURE_COUNTS[key]
    c0 = kcounters.launch_counts()
    eng.decode_steps(3, fused=True)
    per_chunk = kcounters.since(c0)
    assert je.CAPTURE_COUNTS[key] == captures0 + 1
    assert per_chunk[("nbbs_alloc", "launches")] == 3 * 3   # 3 per step with magazines
    assert per_chunk[("paged_attention", "launches")] == 3 * eng.cfg.n_layers

    def no_step(*a, **kw):
        raise AssertionError("a replay ran the Python step")

    monkeypatch.setattr(je, "_step", no_step)
    step0 = int(eng.state.step_no)
    for _ in range(3):
        _no_sync(eng.decode_steps, 3, fused=True)
    assert int(eng.state.step_no) == step0 + 9
    assert je.CAPTURE_COUNTS[key] == captures0 + 1
    assert kcounters.since(c0) == {k: 4 * v for k, v in per_chunk.items()}
    with pytest.raises(AssertionError, match="Python step"):
        eng.decode_steps(2, fused=True)   # a new length is captured, so it steps
