"""The port's training loss and gradients against the JAX package's,
for the MoE and frontend archs in fp32 and in bf16 over float32 master
weights (tests/test_torch_train_model.py has the dense archs in fp32).

fp32: the loss within 1e-5 relative, every gradient leaf within 1e-5 of
the leaf's largest element, remat on and off.  MoE layers train at the
config's capacity factor (1.25) and add 0.01 x their aux loss; llava
and musicgen take `embeds` alone.

bf16: JAX's `init_params` moves into the port as float32 masters; each
layer casts its matmul weights to bf16 (JAX casts each at its use), or,
with `cast_params_once`, every float32 leaf with ndim >= 2 is cast
before the stack as JAX's trainer does.  The loss must stay within 2^-8
relative of JAX's and every gradient leaf within 2^-4 of the leaf's
largest element: bf16 rounds each matmul input to 2^-8 relative, the
two packages round at the same places but sum in other orders, and a
gradient passes through both layers' roundings (the worst seen: 5.4e-4
for the loss, 2.8e-2 for a gradient leaf).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_model import (
    _batch_of,
    _jax_value_and_grad,
    _model,
    _port_cast,
    _port_value_and_grad,
    _worst_grad,
    check_fp32_grads,
    one_thread,  # noqa: F401  (autouse fixture)
)

BF16_LOSS_TOL, BF16_GRAD_TOL = 2.0 ** -8, 2.0 ** -4


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e",
                                  "llava-next-34b", "musicgen-large"])
def test_train_loss_and_grads_match_jax(name, remat):
    check_fp32_grads(name, remat)


@pytest.mark.parametrize("name, cast_once", [
    ("stablelm-3b", False), ("gemma2-27b", True),
    ("phi3.5-moe-42b-a6.6b", False), ("phi3.5-moe-42b-a6.6b", True)])
def test_bf16_over_fp32_masters(name, cast_once):
    _, cfg, _, tree = _model(name)
    jloss, jgrads = _jax_value_and_grad(name, jnp.bfloat16, cast_once)
    loss, grads = _port_value_and_grad(cfg, tree, _batch_of(cfg), torch.bfloat16, True,
                                       _port_cast if cast_once else None)
    assert abs(loss - jloss) <= BF16_LOSS_TOL * abs(jloss)
    assert _worst_grad(grads, jgrads) <= BF16_GRAD_TOL
    for k, g in grads.items():
        assert g.dtype == np.float32 and np.isfinite(g).all(), k
