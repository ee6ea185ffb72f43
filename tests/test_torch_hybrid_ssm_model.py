"""The port's hybrid (zamba2-1.2b) and ssm (rwkv6-7b) models against the
JAX package's, on the reduced configs (zamba2: 2 groups of 2 Mamba2
layers; rwkv6: 2 layers).  JAX's `init_params` moves into the port
through `params_from_numpy`; inputs are seeded numpy tokens.  Whole-model
outputs are held within 1e-4 of the reference's norm (`_rel`), in fp32:

- the parameter tree: names, shapes, and the dtypes `init_params` and
  `params_from_numpy` give (the projections in the working dtype, every
  other leaf float32); the JAX values carried over exactly;
- `forward` (hidden states); `train_loss` and its gradients are in
  tests/test_torch_hybrid_ssm_train.py;
- `init_cache`: JAX's shapes and dtypes, zeros, every site its own
  memory;
- `prefill` at S=7 and S=2 (shorter than the conv tail): the logits and
  every cache leaf;
- 4 `decode_step`s after prefill: each step's logits, then every cache
  leaf;
- the twin of tests/test_models.py::test_serve_consistency on the
  port's own parameters (prefill(S+1) against prefill(S) + decode_step,
  within 1e-4 as there);
- `paged_decode_step` refuses both families, as JAX's does (the engines'
  refusals: tests/test_torch_serve_engine.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import prefill as jprefill
from repro.models.transformer import init_cache as jinit_cache
from repro_torch.configs import get_config
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    params_from_numpy,
    prefill,
)
from repro_torch.serve.paged_decode import init_pool, paged_decode_step
from test_torch_train_model import (
    _model,
    _paths,
    one_thread,  # noqa: F401  (autouse fixture)
)

NAMES = ["zamba2-1.2b", "rwkv6-7b"]
TOL = 1e-4
B = 2
PROJ = {"w_in", "w_out", "wq", "wk", "wv", "wo", "w_r", "w_k", "w_v", "w_g", "w_o",
        "cm_k", "cm_v", "cm_r"}

jprefill_jit = jax.jit(jprefill, static_argnums=(0,), static_argnames=("max_len", "dtype"))
jdecode_jit = jax.jit(jdecode_step, static_argnums=(0,), static_argnames=("dtype",))


@functools.lru_cache(maxsize=None)
def _params(name):
    jcfg, cfg, jparams, tree = _model(name)
    return jcfg, cfg, jparams, tree, params_from_numpy(cfg, tree, "cpu")


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cache_leaves(cache):
    return {k: v for k, v in _paths({k: v for k, v in cache.items() if k != "pos"})}


@pytest.mark.parametrize("name", NAMES)
def test_params_tree_matches_jax(name):
    _, cfg, _, tree, params = _params(name)
    want = dict(_paths(tree))
    got = dict(_paths(params))
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), w), k
    bf = dict(_paths(params_from_numpy(cfg, tree, "cpu", torch.bfloat16)))
    own = dict(_paths(init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                  dtype=torch.bfloat16)))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: w.shape for k, w in want.items()}
    for k in want:
        dt = torch.bfloat16 if k.rsplit("/", 1)[1] in PROJ else torch.float32
        assert bf[k].dtype == own[k].dtype == dt, k
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        assert own["/groups/mamba/A_log"].shape[:2] == (G, cfg.attn_every)
        assert own["/shared_attn/attn/wq"].shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    jcfg, cfg, jparams, _, params = _params(name)
    x = np.random.default_rng(1).standard_normal((B, 11, cfg.d_model)).astype(np.float32)
    jh, _ = jax.jit(jforward, static_argnums=(0,))(jcfg, jparams, jnp.asarray(x))
    h, aux = forward(cfg, params, torch.from_numpy(x))
    assert _rel(h, jh) <= TOL and float(aux) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_init_cache_matches_jax(name):
    jcfg, cfg, _, _, _ = _params(name)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        cache = init_cache(cfg, B, 9, dtype, "cpu")
        jcache = jinit_cache(jcfg, B, 9, jdtype)
        assert cache["pos"] == int(jcache["pos"]) == 0
        want = {k: v for k, v in _paths({k: v for k, v in jcache.items() if k != "pos"})}
        got = _cache_leaves(cache)
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
            assert not got[k].any(), k
            # a real tensor per leaf: the port writes each site in place
            assert all(s != 0 for s, n in zip(got[k].stride(), got[k].shape) if n > 1), k


@pytest.mark.parametrize("S", [7, 2])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_jax(name, S):
    jcfg, cfg, jparams, _, params = _params(name)
    toks = _tokens(cfg, 2, (B, S))
    jlg, jcache = jprefill_jit(jcfg, jparams, {"tokens": jnp.asarray(toks)}, max_len=S + 4,
                               dtype=jnp.float32)
    lg, cache = prefill(cfg, params, {"tokens": torch.from_numpy(toks).long()},
                        max_len=S + 4, dtype=torch.float32)
    assert _rel(lg, jlg) <= TOL
    assert cache["pos"] == int(jcache["pos"]) == S
    want = {k: v for k, v in _paths({k: v for k, v in jcache.items() if k != "pos"})}
    got = _cache_leaves(cache)
    assert set(got) == set(want)
    for k, w in want.items():
        assert _rel(got[k], w) <= TOL, k


@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_jax(name):
    jcfg, cfg, jparams, _, params = _params(name)
    S = 6
    toks = _tokens(cfg, 3, (B, S + 4))
    _, jcache = jprefill_jit(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])},
                             max_len=S + 4, dtype=jnp.float32)
    _, cache = prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                       max_len=S + 4, dtype=torch.float32)
    leaves = _cache_leaves(cache)
    for t in range(S, S + 4):
        jlg, jcache = jdecode_jit(jcfg, jparams, jcache, jnp.asarray(toks[:, t]),
                                  dtype=jnp.float32)
        lg, cache = decode_step(cfg, params, cache, torch.from_numpy(toks[:, t]).long(),
                                dtype=torch.float32)
        assert _rel(lg, jlg) <= TOL, t
        assert cache["pos"] == int(jcache["pos"]) == t + 1
    got = _cache_leaves(cache)
    for k, w in _paths({k: v for k, v in jcache.items() if k != "pos"}):
        assert got[k] is leaves[k], k   # written in place
        assert _rel(got[k], w) <= TOL, k


@pytest.mark.parametrize("name", NAMES)
def test_serve_consistency(name):
    """Twin of tests/test_models.py::test_serve_consistency on the port's
    own parameters: prefill(S+1) last logits == prefill(S) + decode."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    S = 16
    toks = torch.from_numpy(_tokens(cfg, 5, (B, S + 1))).long()
    lg_full, _ = prefill(cfg, params, {"tokens": toks}, max_len=S + 4, dtype=torch.float32)
    _, cache = prefill(cfg, params, {"tokens": toks[:, :S]}, max_len=S + 4,
                       dtype=torch.float32)
    lg_dec, _ = decode_step(cfg, params, cache, toks[:, S], dtype=torch.float32)
    np.testing.assert_allclose(lg_full.numpy(), lg_dec.numpy(), atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_paged_decode_refuses(name):
    """`paged_decode_step` refuses both families, as JAX's does (the
    engines' refusals: tests/test_torch_serve_engine.py)."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dense = get_config("stablelm-3b").reduced()
    pool = init_pool(dense, 8, 4, torch.float32, "cpu")
    lanes = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="paged decode covers attention families"):
        paged_decode_step(cfg, params, pool, torch.zeros((2, 2), dtype=torch.int32), lanes,
                          lanes.long(), page_tokens=4, dtype=torch.float32)
