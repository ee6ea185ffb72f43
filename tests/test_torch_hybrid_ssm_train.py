"""The port's training loss of the hybrid (zamba2-1.2b) and ssm
(rwkv6-7b) families against the JAX package's, on the reduced configs.
JAX's `init_params` moves into the port through `params_from_numpy`
(float32 masters); batches are tests/test_torch_train_model.py's seeded
`_batch_of`:

- fp32, remat on and off (the port checkpoints one hybrid group, as
  JAX's `jax.checkpoint` wraps one scan step): the loss within 1e-5
  relative of `jax.value_and_grad(train_loss)`'s, each gradient leaf
  within 2e-5 of its largest element, the modules' limit (the wkv and
  SSD scans sum over time in another order: the worst seen is 1.02e-5,
  rwkv6 with remat).  The shared attention block's gradient is the sum
  over its G sites;
- bf16 over float32 masters, with and without `cast_params_once`: the
  loss within 2^-8 relative and each gradient leaf within 2^-4 of its
  largest element (tests/test_torch_train_grads.py's limits) of JAX's
  bf16 compiled to round every op, as eager torch does
  (`_jax_bf16_value_and_grad`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import train_loss as jtrain_loss
from test_torch_train_model import (
    _batch_of,
    _jax_cast,
    _jax_value_and_grad,
    _model,
    _port_cast,
    _port_value_and_grad,
    _worst_grad,
    one_thread,  # noqa: F401  (autouse fixture)
)

NAMES = ["zamba2-1.2b", "rwkv6-7b"]
LOSS_TOL, GRAD_TOL = 1e-5, 2e-5
BF16_LOSS_TOL, BF16_GRAD_TOL = 2.0 ** -8, 2.0 ** -4


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_train_loss_and_grads_match_jax(name, remat):
    _, cfg, _, tree = _model(name)
    jloss, jgrads = _jax_value_and_grad(name, jnp.float32)
    loss, grads = _port_value_and_grad(cfg, tree, _batch_of(cfg), torch.float32, remat)
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss)
    assert _worst_grad(grads, jgrads) <= GRAD_TOL


def _jax_bf16_value_and_grad(name, cast_once):
    """JAX's bf16 loss and gradients on `_batch_of`, compiled with
    `xla_allow_excess_precision` off, so that XLA rounds every bf16 op as
    eager torch does.  With XLA's default it keeps fused bf16 chains in
    float32; rwkv6's gradients (no `cast_params_once`) then lie farther
    than 2^-4 of a leaf's largest element from the port's, and farther
    still from JAX's own fp32 gradients: at these widths bf16 rounding
    dominates them."""
    jcfg, cfg, jparams, _ = _model(name)
    batch = _batch_of(cfg)
    cast = _jax_cast if cast_once else (lambda p: p)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtrain_loss(jcfg, cast(p), batch, dtype=jnp.bfloat16)))
    loss, grads = fn.lower(jparams).compile(
        compiler_options={"xla_allow_excess_precision": False})(jparams)
    return float(loss), grads


@pytest.mark.parametrize("cast_once", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_bf16_over_fp32_masters(name, cast_once):
    _, cfg, _, tree = _model(name)
    jloss, jgrads = _jax_bf16_value_and_grad(name, cast_once)
    loss, grads = _port_value_and_grad(cfg, tree, _batch_of(cfg), torch.bfloat16, True,
                                       _port_cast if cast_once else None)
    assert abs(loss - jloss) <= BF16_LOSS_TOL * abs(jloss)
    assert _worst_grad(grads, jgrads) <= BF16_GRAD_TOL
    for k, g in grads.items():
        assert g.dtype == np.float32 and np.isfinite(g).all(), k
