"""The port's fused decode chunk against JAX's, on the CPU.

`JitServeEngine.decode_steps(4, fused=True)` of both packages on the
trace of tests/test_serving.py (`_trace`), stablelm-3b's reduced config
at fp32 with the same parameters (moved through numpy), the geometry of
tests/test_torch_engine.py (16 pages of 4 tokens, 4 lanes): S=1
unpacked, S=2 bunch-packed, and S=2 packed with the fastpath, magazines
of 2 and a ring of 16 events.  After every chunk the running set, each
running sequence's block table, the free page count, the retirement
order and steps, every generated token, `stat_totals()` and the drained
ring events must be identical.  Then `run_to_completion(chunk=4)` (a
fused chunk per decode) on both: the same, and the same spans apart
from their wall-clock fields.

On the CPU a fused chunk is `engine_run` itself (the card replays its
captured graph: tests/test_torch_engine_graph.py).  Here the chunk must
also keep every state tensor at its address, what a captured graph
needs, and equal the port's own single steps.  `reduce_trajectory` and
`hist_summary` are held against JAX's on numpy-made stacked metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.obs import metrics as jom
from repro.obs import ring as jring
from repro.serve.engine import Request as JRequest
from repro.serve.jit_engine import JitServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models.transformer import params_from_numpy
from repro_torch.obs import metrics as om
from repro_torch.obs import ring as oring
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import JitServeEngine

GEOM = dict(num_pages=16, page_tokens=4, max_batch=4, max_lane_pages=8, max_out=16)
CHUNK = 4
VARIANTS = {
    "S1-unpacked": (1, "unpacked", {}),
    "S2-packed": (2, "bunch-packed", {}),
    "S2-packed-fastpath-mag2-ring": (
        2, "bunch-packed", {"fastpath": True, "magazines": 2, "ring_capacity": 16}),
}


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


def _engines(model, variant, seed):
    jcfg, cfg, jparams, params = model
    S, layout, kw = VARIANTS[variant]
    kw = dict(n_shards=S, layout=layout, **kw, **GEOM)
    jeng = JEngine(jcfg, jparams, dtype=jnp.float32, **kw)
    teng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", **kw)
    for i, p, mn in _trace(seed, cfg.vocab_size):
        jeng.submit(JRequest(i, p, mn))
        teng.submit(Request(i, p.copy(), mn))
    return jeng, teng


def _same_outputs(jeng, teng):
    assert teng.retired_order == jeng.retired_order
    assert teng.done_steps == jeng.done_steps
    assert sorted(teng.completed) == sorted(jeng.completed)
    for sid, req in jeng.completed.items():
        assert teng.completed[sid].out_tokens == req.out_tokens, sid
    assert teng.stat_totals() == jeng.stat_totals()
    assert oring.drain(teng.state.ring) == jring.drain(jeng.state.ring)


def _addresses(state):
    out = {k: v.data_ptr() for k, v in vars(state).items() if isinstance(v, torch.Tensor)}
    return {**out, "ring.buf": state.ring.buf.data_ptr(),
            "ring.count": state.ring.count.data_ptr()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_chunks_match_jax(model, variant):
    jeng, teng = _engines(model, variant, 5)
    where = _addresses(teng.state)
    for _ in range(100):
        jeng._drain(), jeng._admit()
        teng._drain(), teng._admit()
        assert sorted(teng.running) == sorted(jeng.running)
        _same_outputs(jeng, teng)
        if not jeng.running and not jeng.waiting:
            break
        for sid in jeng.running:  # page-for-page table equality
            assert (teng.device_block_table(sid) == jeng.device_block_table(sid)).all()
        assert teng.device_free_pages() == jeng.device_free_pages()
        jeng.decode_steps(CHUNK, fused=True)
        teng.decode_steps(CHUNK, fused=True)
    assert not teng.running and not teng.waiting and len(teng.completed) == 8
    assert teng.device_free_pages() == jeng.device_free_pages() == 16
    assert [sp["fused"] for sp in teng.spans if sp["phase"] == "decode"] == [
        sp["fused"] for sp in jeng.spans if sp["phase"] == "decode"] == [1] * (
            teng.stats["steps"] // CHUNK)
    # every state tensor kept its address through admissions, chunks and
    # drains (a captured chunk reads and writes those addresses)
    assert {k: v for k, v in _addresses(teng.state).items() if k in where} == where


def _spans(eng):
    return [{k: v for k, v in sp.items() if k not in ("t0", "t1")} for sp in eng.spans]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_run_to_completion_fused_matches_jax(model, variant):
    jeng, teng = _engines(model, variant, 11)
    jeng.run_to_completion(max_steps=200, chunk=CHUNK)
    teng.run_to_completion(max_steps=200, chunk=CHUNK)
    _same_outputs(jeng, teng)
    assert _spans(teng) == _spans(jeng)
    assert any(sp["phase"] == "decode" and sp["fused"] == 1 for sp in teng.spans)


def test_fused_chunk_equals_single_steps(model):
    """The port's fused chunks against its own single steps, state tensor
    for state tensor after every chunk (magazines, slab and ring on, so
    every field moves)."""
    _, cfg, _, params = model
    S, layout, kw = VARIANTS["S2-packed-fastpath-mag2-ring"]
    engs = [JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", n_shards=S,
                           layout=layout, **kw, **GEOM) for _ in range(2)]
    for eng in engs:
        for i, p, mn in _trace(3, cfg.vocab_size):
            eng.submit(Request(i, p.copy(), mn))
    a, b = engs
    for _ in range(100):
        for eng in engs:
            eng._drain(), eng._admit()
        if not a.running and not a.waiting:
            break
        a.decode_steps(CHUNK, fused=True)
        b.decode_steps(CHUNK)
        for k, v in vars(a.state).items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, getattr(b.state, k)), k
        assert torch.equal(a.state.ring.buf, b.state.ring.buf)
        assert om.to_host(a.acc) == om.to_host(b.acc)
    assert len(a.completed) == 8 and a.retired_order == b.retired_order


@pytest.mark.parametrize("T", [1, 4, 9])
def test_reduce_trajectory_matches_jax(T):
    """A counter, a gauge, a vector gauge and a histogram stacked over T
    steps reduce as JAX's; the histogram's summary labels match."""
    rng = np.random.default_rng(T)
    traj = {
        "alloc_pages": rng.integers(0, 300, T).astype(np.int32),
        "free_pages": rng.integers(0, 4096, T).astype(np.int32),
        "free_pages_shard": rng.integers(0, 1024, (T, 4)).astype(np.int32),
        "alloc_rounds_hist": rng.integers(
            0, 50, (T, om.spec("alloc_rounds_hist").n_slots)).astype(np.int32),
    }
    got = om.reduce_trajectory({k: torch.from_numpy(v) for k, v in traj.items()})
    want = jom.reduce_trajectory({k: jnp.asarray(v) for k, v in traj.items()})
    assert sorted(got) == sorted(want)
    for k in traj:
        assert got[k].dtype == torch.int32
        assert got[k].tolist() == np.asarray(want[k]).tolist(), k
    assert om.to_host(got) == jom.to_host(want)
    name = "alloc_rounds_hist"
    assert om.hist_summary(name, got[name]) == jom.hist_summary(name, want[name])
