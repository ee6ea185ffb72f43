"""The port's dense model against the JAX package at fp32.

`params_from_numpy` moves the JAX `init_params` of stablelm-3b's reduced
config into the port; `prefill` (logits and KV) and one
`paged_decode_step` (logits and the updated pool, with inactive lanes)
then agree with JAX within 1e-4 (fp32; the sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params, prefill as jprefill
from repro.serve.paged_decode import paged_decode_step as jpaged_decode_step
from repro_torch.configs import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import (
    init_params,
    params_from_numpy,
    prefill,
)
from repro_torch.serve.paged_decode import init_pool, paged_decode_step

TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jcfg = jget_config("stablelm-3b").reduced()
    cfg = get_config("stablelm-3b").reduced()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree, params_from_numpy(cfg, tree, "cpu")


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, node


def test_config_copy_matches():
    for name in ("stablelm-3b", "gemma2-27b", "phi3.5-moe-42b-a6.6b"):
        a, b = jget_config(name), get_config(name)
        assert a.__dict__ == b.__dict__
        assert a.reduced().__dict__ == b.reduced().__dict__


def test_params_round_trip(model):
    _, cfg, _, tree, params = model
    want = dict(_leaves(tree))
    got = dict(_leaves(params))
    assert set(want) == set(got)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert np.array_equal(got[name].numpy(), w), name
    bf = params_from_numpy(cfg, tree, "cpu", torch.bfloat16)
    assert bf["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert bf["lm_head"].dtype == torch.float32  # logits read fp32 tables


def test_init_params_shapes(model):
    _, cfg, _, tree, _ = model
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    want = dict(_leaves(tree))
    got = dict(_leaves(params))
    assert set(want) == set(got)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name


def test_rope_and_norm_match():
    from repro.models import layers as jlayers

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5)[None, :] + np.array([[0], [7]])
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-5,
    )
    s = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s))),
        atol=1e-5,
    )


def test_prefill_matches(model):
    jcfg, cfg, jparams, _, params = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    jlg, jcache = jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           max_len=8, dtype=jnp.float32)
    lg, cache = prefill(cfg, params, {"tokens": torch.from_numpy(toks).long()},
                        max_len=8, dtype=torch.float32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   atol=TOL, rtol=TOL)
    assert cache["pos"] == int(jcache["pos"])


def test_paged_decode_step_matches(model):
    jcfg, cfg, jparams, _, params = model
    rng = np.random.default_rng(2)
    B, P, page, MP = 4, 16, 4, 4
    shape = (cfg.n_layers, P, page, cfg.n_kv_heads, cfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    bt = np.full((B, MP), -1, np.int32)
    perm = rng.permutation(P)
    ctx = np.array([5, 0, 9, 3], np.int32)
    for b in range(B):
        n = ctx[b] // page + 1
        bt[b, :n] = perm[b * MP : b * MP + n]
    toks = rng.integers(0, cfg.vocab_size, size=B).astype(np.int32)
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
    # inactive lanes attend over nothing: the JAX reference gives them
    # uniform weights, the port (like the Pallas kernel) zeros
    np.testing.assert_allclose(lg.numpy()[active], np.asarray(jlg)[active],
                               atol=TOL, rtol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pool[k][:, :P].numpy(), np.asarray(jpool[k]),
                                   atol=TOL, rtol=TOL)
