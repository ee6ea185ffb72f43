"""The port's MoE model paths against the JAX package at fp32.

`params_from_numpy` moves the JAX `init_params` of phi3.5-moe's and
llama4-scout's reduced configs into the port (the router stays float32,
the expert weights take the working dtype); `prefill` (logits and KV),
one `paged_decode_step` (logits and the updated pool, inactive lanes
included) and the dense-cache `init_cache` / `decode_step` (also for
stablelm-3b and gemma2-27b, whose windows and softcaps bite at S=16)
then agree with JAX within 1e-4 (the sums run in another order).  The
twin of tests/test_models.py::test_serve_consistency holds the port's
`prefill(S+1)` against `prefill(S)` + `decode_step` on its own
parameters (tests/test_torch_hybrid_ssm_model.py has the hybrid and ssm
families).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models.transformer import init_cache as jinit_cache
from repro.serve.paged_decode import paged_decode_step as jpaged_decode_step
from repro_torch.configs import get_config
from repro_torch.models.transformer import (
    decode_step,
    init_cache,
    init_params,
    params_from_numpy,
    prefill,
)
from repro_torch.serve.paged_decode import init_pool, paged_decode_step

TOL = 1e-4  # tests/test_torch_model.py
MOE = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
ATTENTION = ["stablelm-3b", "gemma2-27b"] + MOE
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _model(name):
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg = jget_config(name).reduced()
    cfg = get_config(name).reduced()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree, params_from_numpy(cfg, tree, "cpu")


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, node


@pytest.mark.parametrize("name", MOE)
def test_params_from_numpy(name):
    _, cfg, _, tree, params = _model(name)
    want, got = dict(_leaves(tree)), dict(_leaves(params))
    assert set(got) == set(want)
    assert {"/layers/moe/router", "/layers/moe/w_gate", "/layers/moe/w_in",
            "/layers/moe/w_out"} <= set(got)
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), w), k
    bf = params_from_numpy(cfg, tree, "cpu", torch.bfloat16)
    assert bf["layers"]["moe"]["router"].dtype == torch.float32
    for k in ("w_gate", "w_in", "w_out"):
        assert bf["layers"]["moe"][k].dtype == torch.bfloat16
    # the port's own init: the same tree of names and shapes, router fp32
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                      dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == {
        k: w.shape for k, w in want.items()}
    assert own["layers"]["moe"]["router"].dtype == torch.float32
    assert own["layers"]["moe"]["w_out"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", MOE)
def test_prefill_matches(name):
    jcfg, cfg, jparams, _, params = _model(name)
    toks = _tokens(cfg, 1, (B, 7))
    jlg, jcache = jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, max_len=8,
                           dtype=jnp.float32)
    lg, cache = prefill(cfg, params, {"tokens": torch.from_numpy(toks).long()},
                        max_len=8, dtype=torch.float32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   atol=TOL, rtol=TOL)
    assert cache["pos"] == int(jcache["pos"])


@pytest.mark.parametrize("name", MOE)
def test_paged_decode_step_matches(name):
    jcfg, cfg, jparams, _, params = _model(name)
    rng = np.random.default_rng(2)
    Bp, P, page, MP = 4, 16, 4, 4
    shape = (cfg.n_layers, P, page, cfg.n_kv_heads, cfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    bt = np.full((Bp, MP), -1, np.int32)
    perm = rng.permutation(P)
    ctx = np.array([5, 0, 9, 3], np.int32)
    for b in range(Bp):
        n = ctx[b] // page + 1
        bt[b, :n] = perm[b * MP : b * MP + n]
    toks = _tokens(cfg, 3, Bp)
    active = np.array([True, False, True, True])
    jlg, jpool = jpaged_decode_step(
        jcfg, jparams, {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(toks),
        page_tokens=page, impl="reference", dtype=jnp.float32,
        active=jnp.asarray(active),
    )
    pool = init_pool(cfg, P, page, torch.float32, "cpu")
    pool["k"][:, :P] = torch.from_numpy(k0)
    pool["v"][:, :P] = torch.from_numpy(v0)
    lg = paged_decode_step(
        cfg, params, pool, torch.from_numpy(bt), torch.from_numpy(ctx),
        torch.from_numpy(toks).long(), page_tokens=page, dtype=torch.float32,
        active=torch.from_numpy(active),
    )
    # the inactive lane attends over nothing (JAX's reference: uniform
    # weights, the port: zeros); it still routes through its experts, but
    # at drop-free capacity it crowds out no other lane, so the active
    # lanes must agree
    np.testing.assert_allclose(lg.numpy()[active], np.asarray(jlg)[active],
                               atol=TOL, rtol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pool[k][:, :P].numpy(), np.asarray(jpool[k]),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ATTENTION)
def test_init_cache_and_decode_step_match(name):
    jcfg, cfg, jparams, _, params = _model(name)
    toks = _tokens(cfg, 4, (B, S + 2))
    _, jcache = jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])},
                         max_len=S + 4, dtype=jnp.float32)
    _, cache = prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                       max_len=S + 4, dtype=torch.float32)
    for t in (S, S + 1):   # two steps: the second reads the first's K/V
        jlg, jcache = jdecode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, t]),
                                   dtype=jnp.float32)
        lg, cache = decode_step(cfg, params, cache, torch.from_numpy(toks[:, t]).long(),
                                dtype=torch.float32)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL)
        assert cache["pos"] == int(jcache["pos"]) == t + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   atol=TOL, rtol=TOL)
    empty = init_cache(cfg, B, S + 4, torch.float32, "cpu")
    jempty = jinit_cache(jcfg, B, S + 4, jnp.float32)
    assert empty["pos"] == int(jempty["pos"]) == 0
    for k in ("k", "v"):
        assert tuple(empty[k].shape) == jempty[k].shape
        assert not empty[k].any()


@pytest.mark.parametrize("name", ATTENTION)
def test_serve_consistency(name):
    """Twin of tests/test_models.py::test_serve_consistency on the port's
    own parameters: prefill(S+1) last logits == prefill(S) + decode."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 5, (B, S + 1))).long()
    lg_full, _ = prefill(cfg, params, {"tokens": toks}, max_len=S + 4, dtype=torch.float32)
    _, cache = prefill(cfg, params, {"tokens": toks[:, :S]}, max_len=S + 4,
                       dtype=torch.float32)
    lg_dec, _ = decode_step(cfg, params, cache, toks[:, S], dtype=torch.float32)
    np.testing.assert_allclose(lg_full.numpy(), lg_dec.numpy(), atol=1e-4)
