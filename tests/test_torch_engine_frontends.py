"""The port's engine with the allocator front ends against the JAX
engine, step for step.

tests/test_fastpath.py's reduced geometry (stablelm-3b reduced, fp32,
16 pages of 4 tokens, 4 lanes, 8 pages per lane, 16 out) at (S=1,
unpacked) here and (S=2, bunch-packed) in
tests/test_torch_engine_frontends_sharded.py (each file stays under a
minute), each with the fastpath slab, with magazines, and with both.
After every admission the running set, each
running sequence's block table and the free page count (stashed pages
included) must be identical; at the end the retirement order and steps,
every generated token and `stat_totals()`, the `fastpath_*`,
`magazine_*` and `admit_*` counters included.  Turning the front ends
on or off must not change a token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.serve.engine import Request as JRequest
from repro.serve.jit_engine import JitServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models.transformer import params_from_numpy
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import JitServeEngine

GEOM = dict(num_pages=16, page_tokens=4, max_batch=4, max_lane_pages=8, max_out=16)
FRONTENDS = {
    "fastpath": {"fastpath": True},
    "magazines": {"magazines": 4},
    "both": {"fastpath": True, "magazines": 4},
}


@pytest.fixture(scope="module")
def model():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jcfg = jget_config("stablelm-3b").reduced()
    cfg = get_config("stablelm-3b").reduced()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _trace(seed, vocab, n=8, max_new=8):
    """Prompts of 5-8 tokens: one prefill bucket, so each JAX engine
    compiles its prefill insert once."""
    rng = np.random.default_rng(seed)
    return [
        (
            i,
            rng.integers(0, vocab, size=int(rng.integers(5, 9))).astype(np.int32),
            int(rng.integers(1, max_new)),
        )
        for i in range(n)
    ]


def _step_exact(model, trace, geom, **kw):
    """Both engines on one trace, one decode step between admissions."""
    jcfg, cfg, jparams, params = model
    jeng = JEngine(jcfg, jparams, dtype=jnp.float32, **geom, **kw)
    teng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", **geom, **kw)
    for i, p, mn in trace:
        jeng.submit(JRequest(i, p, mn))
        teng.submit(Request(i, p.copy(), mn))
    for _ in range(200):
        jeng._drain(), jeng._admit()
        teng._drain(), teng._admit()
        assert sorted(teng.running) == sorted(jeng.running)
        if not jeng.running and not jeng.waiting:
            break
        for sid in jeng.running:
            assert (teng.device_block_table(sid) == jeng.device_block_table(sid)).all()
        assert teng.device_free_pages() == jeng.device_free_pages()
        jeng.decode_steps(1)
        teng.decode_steps(1)
    assert not teng.running and not teng.waiting
    assert teng.retired_order == jeng.retired_order
    assert teng.done_steps == jeng.done_steps
    for sid, req in jeng.completed.items():
        assert teng.completed[sid].out_tokens == req.out_tokens, sid
    assert teng.device_free_pages() == jeng.device_free_pages() == geom["num_pages"]
    tot = teng.stat_totals()
    assert tot == jeng.stat_totals()
    mags = (jeng.state.mag_pages, jeng.state.mag_depth)
    assert (teng.state.mag_pages.numpy() == np.asarray(mags[0])).all()
    assert (teng.state.mag_depth.numpy() == np.asarray(mags[1])).all()
    return teng, tot


def check_frontends(model, n_shards, layout, front):
    _, cfg, _, _ = model
    kw = FRONTENDS[front]
    teng, tot = _step_exact(model, _trace(n_shards, cfg.vocab_size), GEOM,
                            n_shards=n_shards, layout=layout, **kw)
    assert len(teng.completed) == 8
    if kw.get("fastpath"):
        assert tot["fastpath_hits"] > 0
    if kw.get("magazines"):
        assert tot["magazine_hits"] > 0


@pytest.mark.parametrize("front", sorted(FRONTENDS))
def test_step_exact_with_frontends(model, front):
    check_frontends(model, 1, "unpacked", front)


@pytest.mark.parametrize("kw", [{"fastpath": True}, {"magazines": 4}])
def test_frontends_on_off_same_tokens(model, kw):
    """The front ends change how pages are found, not which tokens come
    out: with them on or off the port's engine emits the same tokens
    and retires on the same steps."""
    _, cfg, _, params = model
    engs = [JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", n_shards=2,
                           **GEOM, **extra) for extra in (kw, {})]
    for eng in engs:
        for i, p, mn in _trace(3, cfg.vocab_size):
            eng.submit(Request(i, p.copy(), mn))
        eng.run_to_completion(max_steps=200, chunk=4)
    on, off = engs
    assert on.retired_order == off.retired_order and on.done_steps == off.done_steps
    for sid, req in off.completed.items():
        assert on.completed[sid].out_tokens == req.out_tokens
    name = "fastpath_hits" if "fastpath" in kw else "magazine_hits"
    assert on.stat_totals()[name] > 0 and off.stat_totals()[name] == 0
