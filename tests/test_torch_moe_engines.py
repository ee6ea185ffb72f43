"""The port's serving engines on phi3.5-moe's reduced config against JAX's,
at fp32 with the same parameters (the JAX `init_params`, moved through
numpy).

- `ServeEngine` (the host loop): the twin of tests/test_serving.py's
  `TestMoEServing` and a trace with queueing and two shards, step for
  step: running set, every token, `stats`, block tables, trees, the
  step log; the KV pool within 1e-4 at the end.
- `JitServeEngine`: the trace of tests/test_serving.py (`_trace`) at S=1
  and at S=2 bunch-packed, decoded in single eager steps and in fused
  chunks of 4: after every admission the running set, each running
  sequence's block table and the free pages; at the end the retirement
  order and steps, every token and `stat_totals()`.
- The launcher with `--arch phi3.5-moe-42b-a6.6b --reduced --device cpu`
  against JAX's launcher: every field but the throughput.
"""

import contextlib
import functools
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jlaunch
from repro.models import init_params as jinit_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.jit_engine import JitServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models.transformer import params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.jit_engine import JitServeEngine

NAME = "phi3.5-moe-42b-a6.6b"
TOL = 1e-4  # tests/test_torch_model.py
GEOM = dict(num_pages=16, page_tokens=4, max_batch=4, max_lane_pages=8, max_out=16)


@functools.lru_cache(maxsize=None)
def _model():
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg = jget_config(NAME).reduced()
    cfg = get_config(NAME).reduced()
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


# -- ServeEngine -------------------------------------------------------------


def _host_engines(**kw):
    jcfg, cfg, jparams, params = _model()
    return (JServeEngine(jcfg, jparams, dtype=jnp.float32, **kw),
            ServeEngine(cfg, params, dtype=torch.float32, device="cpu", **kw))


def _same_host_state(j, t):
    assert sorted(t.running) == sorted(j.running)
    assert t.stats == j.stats
    assert t.ctx_lens == j.ctx_lens
    for sid, req in list(j.running.items()) + list(j.completed.items()):
        got = (t.running.get(sid) or t.completed[sid]).out_tokens
        assert got == req.out_tokens, sid
    for sid in j.running:
        assert (t.kv.block_table(sid, t.max_pages) == j.kv.block_table(sid, j.max_pages)).all()
    assert [b.tree for b in t.kv.buddies] == [b.tree for b in j.kv.buddies]


HOST_CASES = {
    # tests/test_serving.py::TestMoEServing::test_moe_engine
    "TestMoEServing": (dict(num_pages=32, page_tokens=4, max_batch=2),
                       [(0, np.random.default_rng(4).integers(0, 200, 5).astype(np.int32), 3)]),
    "queueing-sharded": (dict(num_pages=32, page_tokens=4, max_batch=3, n_shards=2),
                         _trace(7, 256, n=6, max_new=6)),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_serve_engine_matches_jax(case):
    kw, reqs = HOST_CASES[case]
    j, t = _host_engines(**kw)
    for i, p, mn in reqs:
        j.submit(JRequest(i, p, mn))
        t.submit(Request(i, p.copy(), mn))
    for _ in range(200):
        if not j.waiting and not j.running:
            break
        assert t.step() == j.step()
        _same_host_state(j, t)
    assert not t.waiting and not t.running
    assert sorted(t.completed) == sorted(j.completed) == [i for i, _, _ in reqs]
    assert t.step_log == j.step_log
    P = t.kv.num_pages
    for k in ("k", "v"):
        np.testing.assert_allclose(t.pool[k][:, :P].numpy(), np.asarray(j.pool[k]),
                                   atol=TOL, rtol=TOL)
    assert t.kv.free_pages() == kw["num_pages"]


# -- JitServeEngine ------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("S,layout", [(1, "unpacked"), (2, "bunch-packed")])
def test_jit_engine_matches_jax(S, layout, fused):
    jcfg, cfg, jparams, params = _model()
    kw = dict(n_shards=S, layout=layout, **GEOM)
    jeng = JEngine(jcfg, jparams, dtype=jnp.float32, **kw)
    teng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", **kw)
    for i, p, mn in _trace(S * 7 + 1, cfg.vocab_size):
        jeng.submit(JRequest(i, p, mn))
        teng.submit(Request(i, p.copy(), mn))
    chunk = 4 if fused else 1
    for _ in range(100):
        jeng._drain(), jeng._admit()
        teng._drain(), teng._admit()
        assert sorted(teng.running) == sorted(jeng.running)
        if not jeng.running and not jeng.waiting:
            break
        for sid in jeng.running:
            assert (teng.device_block_table(sid) == jeng.device_block_table(sid)).all()
        assert teng.device_free_pages() == jeng.device_free_pages()
        jeng.decode_steps(chunk, fused=fused)
        teng.decode_steps(chunk, fused=fused)
    assert not teng.running and not teng.waiting and len(teng.completed) == 8
    assert teng.retired_order == jeng.retired_order
    assert teng.done_steps == jeng.done_steps
    for sid, req in jeng.completed.items():
        assert teng.completed[sid].out_tokens == req.out_tokens, sid
    assert teng.device_free_pages() == jeng.device_free_pages() == 16
    assert teng.stat_totals() == jeng.stat_totals()


# -- the launcher --------------------------------------------------------------


def _launch(main, argv):
    old, out = sys.argv, io.StringIO()
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = old
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_launcher_moe_json_matches_jax():
    """The schedule does not depend on the weights (no EOS), so every
    field but the throughput equals JAX's launcher."""
    argv = ["--arch", NAME, "--reduced", "--requests", "6", "--max-new", "4"]
    want = _launch(jlaunch.main, argv)
    got = _launch(tlaunch.main, argv + ["--device", "cpu"])
    assert set(got) == set(want)
    for key in ("completed", "generated_tokens", "engine_stats", "kv"):
        assert got[key] == want[key], key
    assert got["completed"] == 6 and got["generated_tokens"] == 24
    assert got["kv"]["free_pages"] == got["kv"]["largest_run"] == 256
