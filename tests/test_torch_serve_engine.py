"""The port's host-loop `ServeEngine` against JAX's, step for step.

Both engines serve the traces of tests/test_serving.py's
`TestServeEngine` (and its sharded, rejection and front-end cases) on
stablelm-3b's reduced config at fp32 with the same parameters (the JAX
`init_params`, moved through numpy).  After every step the running set,
every generated token, `stats`, every running sequence's block table and
the page manager's trees must be identical; `step_log` at the end.  The
prefill logits agree within 1e-4, and so does the KV pool (the port's
pool has one more page, the sink of padded rows: `pool[:, :P]`).  The
launcher's JSON line against JAX's launcher, and the refusal of the
hybrid and ssm families.
"""

import contextlib
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
from repro.serve.paged_decode import serve_prefill as jserve_prefill
from repro_torch.configs import get_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models.transformer import init_params, params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.jit_engine import JitServeEngine
from repro_torch.serve.paged_decode import serve_prefill

TOL = 1e-4  # tests/test_torch_model.py


@pytest.fixture(scope="module")
def model():
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg = jget_config("stablelm-3b").reduced()
    cfg = get_config("stablelm-3b").reduced()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _engines(model, **kw):
    jcfg, cfg, jparams, params = model
    return (JServeEngine(jcfg, jparams, dtype=jnp.float32, **kw),
            ServeEngine(cfg, params, dtype=torch.float32, device="cpu", **kw))


def _same_state(j, t):
    assert sorted(t.running) == sorted(j.running)
    assert t.stats == j.stats
    assert t.ctx_lens == j.ctx_lens
    assert sorted(t.completed) == sorted(j.completed)
    for sid, req in list(j.running.items()) + list(j.completed.items()):
        got = (t.running.get(sid) or t.completed[sid]).out_tokens
        assert got == req.out_tokens, sid
    for sid in j.running:
        assert (t.kv.block_table(sid, t.max_pages) == j.kv.block_table(sid, j.max_pages)).all()
    assert [b.tree for b in t.kv.buddies] == [b.tree for b in j.kv.buddies]
    assert t.kv.fragmentation() == j.kv.fragmentation()


def _same_pool(j, t):
    P = t.kv.num_pages
    assert tuple(t.pool["k"].shape) == (j.pool["k"].shape[0], P + 1) + tuple(j.pool["k"].shape[2:])
    for name in ("k", "v"):
        np.testing.assert_allclose(t.pool[name][:, :P].numpy(), np.asarray(j.pool[name]),
                                   atol=TOL, rtol=TOL)


def _serve(j, t, arrivals, max_steps=500):
    """`arrivals`: {step: [(id, prompt, max_new)]}; steps both engines in
    lockstep until both are idle."""
    for n in range(max_steps):
        for i, p, mn in arrivals.get(n, ()):
            j.submit(JRequest(i, p, mn))
            t.submit(Request(i, p.copy(), mn))
        if not j.waiting and not j.running and n > max(arrivals):
            break
        assert t.step() == j.step()
        _same_state(j, t)
    assert not t.waiting and not t.running
    assert t.step_log == j.step_log


def _reqs(seed, n, lo, hi, max_new, vocab=200):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(lo, hi))).astype(np.int32),
             max_new) for i in range(n)]


# TestServeEngine's traces, its sharded, queueing and rejection cases,
# and the front ends
CASES = {
    "run_to_completion": (dict(num_pages=64, page_tokens=4, max_batch=4),
                          {0: _reqs(0, 6, 3, 9, 5)}),
    "sharded": (dict(num_pages=64, page_tokens=4, max_batch=4, n_shards=2),
                {0: _reqs(9, 5, 3, 9, 4)}),
    "queueing": (dict(num_pages=16, page_tokens=4, max_batch=8),
                 {0: [(i, np.random.default_rng(3 + i).integers(0, 200, 12).astype(np.int32), 8)
                      for i in range(6)]}),
    "mixed_positions": (dict(num_pages=64, page_tokens=4, max_batch=4, log_stats=True),
                        {0: _reqs(2, 1, 8, 9, 6), 1: [(1, np.arange(3, dtype=np.int32), 4)]}),
    "fastpath_magazines_packed": (
        dict(num_pages=64, page_tokens=4, max_batch=4, n_shards=2, layout="bunch-packed",
             fastpath=True, magazines=2, magazine_refill=1, log_stats=True, max_table_pages=8),
        {0: _reqs(4, 3, 1, 3, 2), 3: _reqs(5, 3, 1, 3, 2), 6: _reqs(6, 3, 2, 7, 3)}),
}
# unique ids per arrival step
CASES["fastpath_magazines_packed"][1][3] = [(i + 3, p, m) for i, p, m in
                                            CASES["fastpath_magazines_packed"][1][3]]
CASES["fastpath_magazines_packed"][1][6] = [(i + 6, p, m) for i, p, m in
                                            CASES["fastpath_magazines_packed"][1][6]]


@pytest.mark.parametrize("name", list(CASES))
def test_serve_engine_matches_jax(model, name):
    kw, arrivals = CASES[name]
    j, t = _engines(model, **kw)
    _serve(j, t, arrivals)
    _same_pool(j, t)
    assert t.kv.free_pages() == kw["num_pages"]
    if name == "queueing":
        assert t.stats["queued_full"] > 0
    if kw.get("magazines"):
        frag = t.kv.fragmentation()
        assert frag["fastpath_hits"] > 0 and frag["magazine_hits"] > 0


def test_rejects_impossible_request_without_blocking(model):
    j, t = _engines(model, num_pages=16, page_tokens=4, max_batch=4, n_shards=2)
    rng = np.random.default_rng(12)
    # needs ceil(40/4)=10 pages -> run of 16 > 8 per shard
    arrivals = {0: [(0, rng.integers(0, 200, 30).astype(np.int32), 10),
                    (1, rng.integers(0, 200, 4).astype(np.int32), 3)]}
    _serve(j, t, arrivals)
    assert t.stats["rejected"] == 1
    assert not t.completed[0].out_tokens
    assert len(t.completed[1].out_tokens) == 3
    assert t.kv.free_pages() == 16


def test_pool_after_prefill_and_decode(model):
    """Mid-run, prompts and decoded tokens sit in the same pages and
    slots of both pools; padded rows wrote only the sink page."""
    j, t = _engines(model, num_pages=32, page_tokens=4, max_batch=4)
    for i, p, mn in _reqs(21, 3, 2, 11, 6):
        j.submit(JRequest(i, p, mn))
        t.submit(Request(i, p.copy(), mn))
    for _ in range(3):
        j.step(), t.step()
        _same_state(j, t)
        _same_pool(j, t)   # 3 running, padded to 4 rows
    assert t.pool["k"][:, 32].abs().sum() > 0   # the sink took the padded row's writes


@pytest.mark.parametrize("S", [1, 5, 12])
def test_prefill_logits_match_jax(model, S):
    jcfg, cfg, jparams, params = model
    prompt = np.random.default_rng(S).integers(0, cfg.vocab_size, size=S).astype(np.int32)
    jlg, jcache = jserve_prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt[None])},
                                 max_len=S, dtype=jnp.float32)
    lg, cache = serve_prefill(cfg, params, {"tokens": torch.from_numpy(prompt[None]).long()},
                              max_len=S, dtype=torch.float32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=TOL, rtol=TOL)


def _launch(main, argv):
    old, out = sys.argv, io.StringIO()
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = old
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_launcher_json_matches_jax():
    """Every field but the throughput: the tokens differ (the weights come
    from different RNGs), the schedule does not (no EOS)."""
    argv = ["--arch", "stablelm-3b", "--reduced", "--requests", "10", "--max-new", "5"]
    want = _launch(jlaunch.main, argv)
    got = _launch(tlaunch.main, argv + ["--device", "cpu"])
    assert set(got) == set(want)
    for key in ("completed", "generated_tokens", "engine_stats", "kv"):
        assert got[key] == want[key], key
    assert got["completed"] == 10 and got["generated_tokens"] == 50
    assert got["kv"]["free_pages"] == got["kv"]["largest_run"] == 256
    assert got["tokens_per_s"] > 0


@pytest.mark.parametrize("name", ["zamba2-1.2b", "rwkv6-7b"])
@pytest.mark.parametrize("engine", ["serve", "jit"])
def test_missing_families_refused_at_construction(engine, name, monkeypatch):
    """The paged engines serve the attention families (dense and MoE:
    tests/test_torch_moe_engines.py); both refuse the hybrid and ssm
    families, as JAX's engines do, before any pool is allocated."""
    from repro_torch.serve import engine as teng_mod
    from repro_torch.serve import jit_engine as tjit_mod

    cfg = get_config(name).reduced()
    dense = get_config("stablelm-3b").reduced()
    params = init_params(dense, torch.Generator().manual_seed(0), device="cpu")

    def no_pool(*a, **k):
        raise AssertionError("a pool was allocated")

    monkeypatch.setattr(teng_mod, "init_pool", no_pool)
    monkeypatch.setattr(tjit_mod, "init_engine_state", no_pool)
    cls = ServeEngine if engine == "serve" else JitServeEngine
    with pytest.raises(ValueError, match="paged engine covers attention families"):
        cls(cfg, params, num_pages=32, page_tokens=4, max_batch=2, device="cpu")
