"""The hybrid and ssm families (zamba2-1.2b, rwkv6-7b reduced) on an
NVIDIA card against the same on the CPU, in fp32 with TF32 off (skips
without a card): `chip_smoke.py` phase ssm (c) at the reduced size.

- `prefill`'s logits within 1e-4 of their norm and every cache leaf
  within 2e-5 of its norm, then 4 `decode_step`s on the CPU's greedy
  tokens: each step's logits, then every cache leaf, with the same
  limits;
- `train_loss` within 1e-5 relative (tests/test_torch_train_card.py's
  limit) and every gradient leaf within 1e-4 of the leaf's largest
  element or, where the gradients are worse conditioned, within twice
  the CPU's own spread: how far its gradients move when the parameters
  move by 1e-7 of themselves (rwkv6's gradients are ill-conditioned:
  a fixed 1e-4 failed on correct arithmetic, `chip_smoke.py` phase ssm
  (c) reports the spread at full width).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.models.transformer import decode_step, init_params, prefill, train_loss
from repro_torch.tree_util import flatten, leaves, tree_map
from torch_card import cuda_device  # noqa: F401  (fixture)

NAMES = ["zamba2-1.2b", "rwkv6-7b"]
LOGIT_TOL, LEAF_TOL = 1e-4, 2e-5
LOSS_TOL, GRAD_TOL, NOISE = 1e-5, 1e-4, 1e-7


def _rel(got, want):
    got, want = got.detach().cpu(), want.detach()
    return float((got - want).norm()) / max(float(want.norm()), 1e-30)


def _cache_leaves(cache):
    return flatten({k: v for k, v in cache.items() if k != "pos"})


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_on_card_equal_cpu(cuda_device, name):
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                         device=cuda_device)
    host = tree_map(lambda x: x.cpu(), params)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))).long()
    lg, cache = prefill(cfg, params, {"tokens": toks.to(cuda_device)}, 16,
                        dtype=torch.float32)
    want, hcache = prefill(cfg, host, {"tokens": toks}, 16, dtype=torch.float32)
    assert _rel(lg, want) <= LOGIT_TOL
    for a, b in zip(_cache_leaves(cache)[0], _cache_leaves(hcache)[0]):
        assert a.device.type == "cuda" and _rel(a, b) <= LEAF_TOL
    for _ in range(4):
        tok = want.argmax(-1)
        lg, cache = decode_step(cfg, params, cache, tok.to(cuda_device), dtype=torch.float32)
        want, hcache = decode_step(cfg, host, hcache, tok, dtype=torch.float32)
        assert _rel(lg, want) <= LOGIT_TOL
    (mine, tree_a), (theirs, tree_b) = _cache_leaves(cache), _cache_leaves(hcache)
    assert str(tree_a) == str(tree_b) and cache["pos"] == hcache["pos"] == 16
    for a, b in zip(mine, theirs):
        assert _rel(a, b) <= LEAF_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_train_loss_and_grads_on_card_equal_cpu(cuda_device, name):
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                         device=cuda_device)
    host = tree_map(lambda x: x.cpu(), params)
    batch = SyntheticLM(cfg.vocab_size, 32, 4, seed=1).batch_at(0)

    gen = torch.Generator().manual_seed(5)
    nudged = tree_map(lambda x: x * (1 + NOISE * torch.randn(x.shape, generator=gen)), host)

    def value_and_grad(p, device):
        flat = leaves(p)
        for x in flat:
            x.requires_grad_(True)
        loss = train_loss(cfg, p, to_device(batch, device), dtype=torch.float32)
        loss.backward()
        return float(loss.detach()), [x.grad.detach().cpu() for x in flat]

    def worst(got):
        return max(float((g - w).abs().max()) / float(w.abs().max())
                   for g, w in zip(got, want_grads))

    loss, grads = value_and_grad(params, cuda_device)
    want, want_grads = value_and_grad(host, "cpu")
    floor = worst(value_and_grad(nudged, "cpu")[1])
    assert abs(loss - want) <= LOSS_TOL * abs(want)
    assert worst(grads) <= max(GRAD_TOL, 2 * floor)
