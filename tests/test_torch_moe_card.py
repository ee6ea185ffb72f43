"""The MoE serving path on the card against the same weights on the CPU.

These tests import torch, numpy and the port only (the machine with the
card has no JAX); without a card each skips with its reason.  On one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_card.py

- `paged_decode_step` of phi3.5-moe at full width (d_model 4096, 32/8
  heads, D=128, 16 experts of d_ff 6400, top-2, vocab 32064), cut to 2
  layers, fp32, 8 lanes at lengths 0..40 (one lane inactive): the
  card's logits (through kernel B, 2 launches) and pool within 1e-4 of
  the CPU step on the same weights.
- `JitServeEngine` at phi3.5-moe's reduced config, fp32: the card serves
  six requests through fused chunks of 4 (graph capture, then replays,
  every chunk under `torch.cuda.set_sync_debug_mode("error")`) and must
  give the CPU run's schedule (retirement order and steps,
  `stat_totals()`) and tokens; kernel B launches once per layer and
  step, kernel A twice per step and admission.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import nbbs_alloc, paged_attention as pa
from repro_torch.models.transformer import init_params
from repro_torch.serve import jit_engine as je
from repro_torch.serve.engine import Request
from repro_torch.serve.jit_engine import JitServeEngine
from repro_torch.serve.paged_decode import init_pool, paged_decode_step
from torch_card import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda

NAME = "phi3.5-moe-42b-a6.6b"
TOL = 1e-4  # tests/test_torch_model.py


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_paged_decode_step_full_width_matches_cpu(cuda_device):
    import dataclasses

    cfg = dataclasses.replace(get_config(NAME), n_layers=2)
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                         device=cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(0)
    B, P, page, MP = 8, 128, 4, 16
    ctx = np.array([0, 3, 7, 12, 19, 26, 33, 40], np.int32)
    bt = np.full((B, MP), -1, np.int32)
    perm = rng.permutation(P)
    for b in range(B):
        n = ctx[b] // page + 1
        bt[b, :n] = perm[b * MP: b * MP + n]
    toks = rng.integers(0, cfg.vocab_size, size=B)
    active = np.array([True] * 5 + [False] + [True] * 2)
    pools = {}
    for dev in ("cpu", cuda_device):
        pool = init_pool(cfg, P, page, torch.float32, "cpu")
        g = torch.Generator().manual_seed(1)
        pool["k"][:, :P] = torch.randn(pool["k"][:, :P].shape, generator=g)
        pool["v"][:, :P] = torch.randn(pool["v"][:, :P].shape, generator=g)
        pools[str(dev)] = _to(pool, dev)
    args = [torch.from_numpy(a) for a in (bt, ctx, toks, active)]
    b0 = pa.launches
    card = paged_decode_step(cfg, params, pools[str(cuda_device)],
                             *[a.to(cuda_device) for a in args[:3]], page_tokens=page,
                             dtype=torch.float32, active=args[3].to(cuda_device))
    assert pa.launches - b0 == cfg.n_layers
    cpu = paged_decode_step(cfg, _to(params, "cpu"), pools["cpu"], *args[:3],
                            page_tokens=page, dtype=torch.float32, active=args[3])
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=TOL, rtol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pools[str(cuda_device)][k][:, :P].cpu().numpy(),
                                   pools["cpu"][k][:, :P].numpy(), atol=TOL, rtol=TOL)


def _serve(cfg, params, dev):
    eng = JitServeEngine(cfg, params, dtype=torch.float32, device=dev, num_pages=64,
                         page_tokens=4, max_batch=4, max_lane_pages=8, max_out=16,
                         n_shards=2)
    rng = np.random.default_rng(0)
    for i in range(6):
        p = rng.integers(0, cfg.vocab_size, int(rng.integers(2, 9))).astype(np.int32)
        eng.submit(Request(i, p, int(rng.integers(6, 17))))
    inner = eng.decode_steps

    def no_sync(n, fused=False):
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            inner(n, fused=fused)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")

    eng.decode_steps = no_sync
    eng.run_to_completion(max_steps=500, chunk=4)
    return eng


def test_jit_engine_fused_matches_cpu(cuda_device):
    cfg = get_config(NAME).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cpu = _serve(cfg, params, torch.device("cpu"))
    a0, b0 = nbbs_alloc.launches, pa.launches
    card = _serve(cfg, _to(params, cuda_device), cuda_device)
    steps = card.stats["steps"]
    admits = card.stats["admitted"] + card.stats["queued_full"]
    assert pa.launches - b0 == cfg.n_layers * steps
    assert nbbs_alloc.launches - a0 == 2 * (steps + admits)
    assert je.CAPTURE_COUNTS[(card.ecfg, 4)] >= 1 and 4 in card._graphs
    assert len(card.completed) == 6
    assert card.retired_order == cpu.retired_order
    assert card.done_steps == cpu.done_steps
    assert card.stat_totals() == cpu.stat_totals()
    for sid, req in cpu.completed.items():
        assert card.completed[sid].out_tokens == req.out_tokens, sid
    assert card.device_free_pages() == 64
