"""The port's jit-resident engine against the JAX engine, step for step.

Both engines run the trace of tests/test_serving.py (`_trace`), in both
tree layouts, on stablelm-3b's reduced config at fp32 with the same
parameters (moved through numpy), 16 pages of 4 tokens, 4 lanes.  After every admission
the running set, each running sequence's block table and the free page
count must be identical; at the end the retirement order and steps,
every generated token and `stat_totals()` (histograms included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.serve.engine import Request as JRequest
from repro.serve.jit_engine import JitServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models.transformer import params_from_numpy
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import EngineConfig, JitServeEngine

GEOM = dict(num_pages=16, page_tokens=4, max_batch=4, max_lane_pages=8, max_out=16)


@pytest.fixture(scope="module")
def model():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _step_exact(model, n_shards, layout, chunk, seed):
    """Both engines on one trace, `chunk` decode steps between
    admissions; returns them once every request has retired."""
    jcfg, cfg, jparams, params = model
    jeng = JEngine(jcfg, jparams, dtype=jnp.float32, n_shards=n_shards,
                   layout=layout, **GEOM)
    teng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu",
                          n_shards=n_shards, layout=layout, **GEOM)
    for i, p, mn in _trace(seed, cfg.vocab_size):
        jeng.submit(JRequest(i, p, mn))
        teng.submit(Request(i, p.copy(), mn))
    for _ in range(100):
        jeng._drain(), jeng._admit()
        teng._drain(), teng._admit()
        assert sorted(teng.running) == sorted(jeng.running)
        if not jeng.running and not jeng.waiting:
            break
        for sid in jeng.running:
            assert (teng.device_block_table(sid) == jeng.device_block_table(sid)).all()
        assert teng.device_free_pages() == jeng.device_free_pages()
        jeng.decode_steps(chunk)
        teng.decode_steps(chunk)
    assert not teng.running and not teng.waiting
    assert teng.retired_order == jeng.retired_order
    assert teng.done_steps == jeng.done_steps
    for sid, req in jeng.completed.items():
        assert teng.completed[sid].out_tokens == req.out_tokens, sid
    assert teng.device_free_pages() == jeng.device_free_pages() == 16
    assert teng.stat_totals() == jeng.stat_totals()
    return jeng, teng


def test_step_exact_against_jax_engine_packed(model):
    """tests/test_serving.py's (2, "bunch-packed", 4) case: the packed
    tree words, the schedule, the tokens and every counter."""
    _, teng = _step_exact(model, 2, "bunch-packed", 4, 2 * 7 + 4)
    assert len(teng.completed) == 8
    assert tuple(teng.state.trees.shape) == (2, teng.ecfg.pool_config().n_state_words)
    assert teng.state.trees.dtype == torch.int32 and not teng.state.trees.any()


@pytest.mark.parametrize("n_shards", [1, 2])
def test_step_exact_against_jax_engine(model, n_shards):
    _, teng = _step_exact(model, n_shards, "unpacked", 1, n_shards * 7 + 1)
    assert len(teng.completed) == 8


def test_fused_chunks_match_single_steps(model):
    """Decode chunks of 4 (`run_to_completion(chunk=4)`, one `engine_run`
    per chunk) retire every request with the tokens of single steps."""
    _, cfg, _, params = model
    engs = [JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", **GEOM)
            for _ in range(2)]
    for eng, chunk in zip(engs, (1, 4)):
        for i, p, mn in _trace(3, cfg.vocab_size):
            eng.submit(Request(i, p.copy(), mn))
        eng.run_to_completion(max_steps=200, chunk=chunk)
    a, b = engs
    assert a.stat_totals()["retired"] == b.stat_totals()["retired"] == 8
    for sid, req in a.completed.items():
        assert b.completed[sid].out_tokens == req.out_tokens


def test_matches_dense_greedy_decode(model):
    """tests/test_serving.py::test_matches_dense_greedy_decode with the
    port's engine: its tokens equal JAX dense greedy decoding."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
    lg, cache = jprefill(jcfg, jparams, {"tokens": jnp.asarray(prompt[None])},
                         max_len=16, dtype=jnp.float32)
    want = [int(np.argmax(np.asarray(lg)[0]))]
    for _ in range(3):
        lg, cache = jdecode_step(jcfg, jparams, cache,
                                 jnp.asarray([want[-1]], jnp.int32), dtype=jnp.float32)
        want.append(int(np.argmax(np.asarray(lg)[0])))
    eng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", **GEOM)
    eng.submit(Request(0, prompt, max_new_tokens=4))
    eng.run_to_completion(max_steps=20)
    assert eng.completed[0].out_tokens == want


@pytest.mark.parametrize("kw,error,match", [
    # the front ends are ported: their bad geometry is what raises now
    ({"fastpath": True, "fastpath_slab_level": 9}, ValueError, "slab_level"),
    ({"magazines": 4, "magazine_refill": -1}, ValueError, "magazine_refill"),
    ({"ring_capacity": -1}, ValueError, "ring_capacity"),
])
def test_config_refuses_later_slices(kw, error, match):
    cfg = get_config("stablelm-3b").reduced()
    with pytest.raises(error, match=match):
        EngineConfig(arch=cfg, **GEOM, **kw)


def test_rejects_oversized_without_blocking(model):
    _, cfg, _, params = model
    eng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu",
                         **{**GEOM, "max_lane_pages": 4})
    rng = np.random.default_rng(12)
    eng.submit(Request(0, rng.integers(0, 200, 30).astype(np.int32), 10))
    eng.submit(Request(1, rng.integers(0, 200, 4).astype(np.int32), 3))
    eng.run_to_completion(max_steps=100)
    assert eng.stats["rejected"] == 1
    assert not eng.completed[0].out_tokens
    assert len(eng.completed[1].out_tokens) == 3
    assert eng.device_free_pages() == 16
