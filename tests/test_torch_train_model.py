"""The port's training forward of the attention families against the
JAX package.

JAX's `init_params` of each reduced config moves into the port through
`params_from_numpy` (float32 masters).  On shared seeded batches:

- `prefill` of the stub frontends (llava-next-34b, musicgen-large) with
  `embeds` alone, embeds and tokens, and tokens alone equals JAX's
  within 2e-5: it used to read only the tokens;
- `train_loss` and its gradients, with the port's remat on and off,
  equal `jax.value_and_grad(train_loss)` (remat on; JAX's remat
  recomputes the same operations) in fp32: the loss within 1e-5
  relative, every gradient leaf within 1e-5 of the leaf's largest
  element (the sums run in another order: the worst seen is 6.7e-6).
  Here the dense archs; tests/test_torch_train_grads.py the MoE and
  frontend archs, and bf16 over float32 masters;
- `cast_params_once`'s rule is JAX's;
- the layers training adds (`cross_entropy`, `attention_block`,
  `attention_decode_block`, the GELU MLP) equal JAX's within 1e-5;

plus twins of tests/test_models.py's train smoke test for the
attention archs, its gemma2 window pattern and MoE aux-loss tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import train_loss as jtrain_loss
from repro_torch.configs import get_config
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.transformer import (
    ATTENTION_FAMILIES,
    init_params,
    params_from_numpy,
    prefill,
    train_loss,
    window_array,
)
from repro_torch.configs.registry import ARCH_NAMES
from repro_torch.tree_util import leaves, tree_map

B, S = 2, 16
ATTENTION = [n for n in ARCH_NAMES if get_config(n).family in ATTENTION_FAMILIES]
FRONTENDS = ["llava-next-34b", "musicgen-large"]
LOSS_TOL, GRAD_TOL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The CPU ops here are tiny: torch's worker threads only add their
    wake-ups (a 3x-8x slower step with 8 threads beside other test
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(name):
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg = jget_config(name).reduced()
    cfg = get_config(name).reduced()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, jax.tree.map(np.asarray, jparams)


def _batch(cfg, seed, embeds, tokens=True):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if embeds:
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if tokens:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return out


def _paths(node, prefix=""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _paths(node[k], f"{prefix}/{k}")
    else:
        yield prefix, node


def _batch_of(cfg):
    return _batch(cfg, 2, cfg.frontend != "none", cfg.frontend == "none")


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name, dtype, cast_once=False):
    """JAX's loss and gradients on `_batch_of`, remat on."""
    jcfg, cfg, jparams, _ = _model(name)
    batch = _batch_of(cfg)
    cast = _jax_cast if cast_once else (lambda p: p)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain_loss(jcfg, cast(p), batch, dtype=dtype)))(jparams)
    return float(loss), grads


def _jax_cast(tree):
    return jax.tree.map(
        lambda p: p.astype(jnp.bfloat16) if p.dtype == jnp.float32 and p.ndim >= 2
        else p, tree)


def _port_cast(tree):
    return tree_map(
        lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 and p.ndim >= 2
        else p, tree)


def _port_value_and_grad(cfg, tree, batch, dtype, remat, cast=None):
    params = params_from_numpy(cfg, tree, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    used = cast(params) if cast else params
    loss = train_loss(cfg, used, {k: torch.from_numpy(v) for k, v in batch.items()},
                      dtype=dtype, remat=remat)
    loss.backward()
    loss = float(loss.detach())
    grads = {k: (np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
             for k, p in _paths(params)}
    return loss, grads


def _worst_grad(grads, jgrads):
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    assert set(grads) == set(want)
    return max(float(np.abs(grads[k] - w).max() / max(np.abs(w).max(), 1e-30))
               for k, w in want.items())


@pytest.mark.parametrize("form", ["embeds", "embeds+tokens", "tokens"])
@pytest.mark.parametrize("name", FRONTENDS)
def test_prefill_takes_embeds(name, form):
    jcfg, cfg, jparams, tree = _model(name)
    batch = _batch(cfg, 1, "embeds" in form, "tokens" in form)
    batch.pop("labels")
    jlg, jcache = jprefill(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                           max_len=S + 2, dtype=jnp.float32)
    lg, cache = prefill(cfg, params_from_numpy(cfg, tree, "cpu"),
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        max_len=S + 2, dtype=torch.float32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=2e-5, rtol=2e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   atol=2e-5, rtol=2e-5)
    assert cache["pos"] == int(jcache["pos"]) == S


def check_fp32_grads(name, remat):
    _, cfg, _, tree = _model(name)
    jloss, jgrads = _jax_value_and_grad(name, jnp.float32)
    loss, grads = _port_value_and_grad(cfg, tree, _batch_of(cfg), torch.float32, remat)
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss)
    assert _worst_grad(grads, jgrads) <= GRAD_TOL


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", [n for n in ATTENTION
                                  if get_config(n).family == "dense"])
def test_train_loss_and_grads_match_jax(name, remat):
    check_fp32_grads(name, remat)


def test_cast_params_once_rule():
    """JAX's rule casts every float32 leaf with ndim >= 2: the stacked
    norm scales, the router, the embedding and LM head too; only
    `final_norm` stays float32.  The hybrid's and ssm's stacked per-head
    leaves count too (`A_log`, `D`, `dt_bias`, `conv_b`, the Mamba2
    norm; RWKV's mixes, `w0`, `u`, `ln_scale`); zamba2's shared block's
    norm [d] is not stacked and stays float32."""
    _, cfg, _, tree = _model("phi3.5-moe-42b-a6.6b")
    cast = _port_cast(params_from_numpy(cfg, tree, "cpu"))
    kept = sorted(k for k, p in _paths(cast) if p.dtype == torch.float32)
    assert kept == ["/final_norm"]
    assert cast["layers"]["ln1"].dtype == cast["layers"]["moe"]["router"].dtype \
        == cast["embed"].dtype == torch.bfloat16
    for name, want_kept, stacked in (
            ("zamba2-1.2b", ["/final_norm", "/shared_attn/ln"],
             ("A_log", "D", "dt_bias", "conv_b", "norm")),
            ("rwkv6-7b", ["/final_norm"], ("mu_r", "w0", "u", "ln_scale", "cm_mu_k"))):
        _, cfg, _, tree = _model(name)
        cast = _port_cast(params_from_numpy(cfg, tree, "cpu"))
        assert sorted(k for k, p in _paths(cast) if p.dtype == torch.float32) == want_kept
        layers = cast["groups"]["mamba"] if "groups" in cast else cast["layers"]
        assert all(layers[k].dtype == torch.bfloat16 for k in stacked), name


def test_cross_entropy_and_gelu_mlp_match_jax():
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    rng = np.random.default_rng(4)
    lg = (rng.standard_normal((3, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    for z in (0.0, 1e-4):
        np.testing.assert_allclose(
            float(layers.cross_entropy(torch.from_numpy(lg), torch.from_numpy(labels), z)),
            float(jlayers.cross_entropy(jnp.asarray(lg), jnp.asarray(labels), z)), rtol=1e-6)
    p = jlayers.init_gelu_mlp(jax.random.PRNGKey(1), 16, 48)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    want = jlayers.apply_gelu_mlp(p, jnp.asarray(x), dtype=jnp.float32)
    got = layers.apply_gelu_mlp({k: torch.from_numpy(np.array(v)) for k, v in p.items()},
                                torch.from_numpy(x), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    own = layers.init_gelu_mlp(torch.Generator().manual_seed(0), 16, 48, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in p.items()}


@pytest.mark.parametrize("window, softcap", [(0, None), (5, 30.0)])
def test_attention_blocks_match_jax(window, softcap):
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    d, H, Hkv, D, S = 32, 4, 2, 8, 12
    p = jattn.init_attention(jax.random.PRNGKey(2), d, H, Hkv, D)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, rope_theta=10000.0, softcap=softcap)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    want = jattn.attention_block(p, jnp.asarray(x), window=window, chunk=5, **kw)
    got = tattn.attention_block(tp, torch.from_numpy(x), window=window, chunk=5, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    k0 = rng.standard_normal((2, S, Hkv, D)).astype(np.float32)
    v0 = rng.standard_normal((2, S, Hkv, D)).astype(np.float32)
    x1 = x[:, :1]
    want, wk, wv = jattn.attention_decode_block(p, jnp.asarray(x1), jnp.asarray(k0),
                                                jnp.asarray(v0), 7, window=window, **kw)
    kc, vc = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    got, gk, gv = tattn.attention_decode_block(tp, torch.from_numpy(x1), kc, vc, 7,
                                               window=window, **kw)
    assert gk is kc and gv is vc   # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6)


# --- twins of tests/test_models.py -----------------------------------------


@pytest.mark.parametrize("name", ATTENTION)
def test_arch_smoke_train_step(name):
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, 0, cfg.frontend != "none", cfg.frontend == "none").items()}
    loss = train_loss(cfg, params, batch, dtype=torch.float32, remat=True)
    loss.backward()
    assert torch.isfinite(loss), name
    gnorm = torch.sqrt(sum((p.grad.square().sum() for p in leaves(params)
                            if p.grad is not None), torch.zeros(())))
    assert torch.isfinite(gnorm) and gnorm > 0, name


def test_gemma2_window_pattern():
    w = np.asarray(window_array(get_config("gemma2-27b")))
    assert len(w) == 46
    assert (w[::2] == 4096).all() and (w[1::2] == 0).all()


def test_moe_aux_loss_and_balance():
    gen = torch.Generator().manual_seed(0)
    p = init_moe(gen, 32, 64, 4, device="cpu")
    x = torch.randn((2, 64, 32), generator=gen)
    y, aux = apply_moe(p, x, top_k=2, dtype=torch.float32)
    assert y.shape == x.shape
    assert torch.isfinite(y).all() and torch.isfinite(aux)
    assert float(aux) > 0
