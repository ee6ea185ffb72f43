"""The distribution layer on an NVIDIA card over NCCL, in a world of one
rank (skips without a card).

One card cannot hold two NCCL ranks, so the process group has one rank
and the mesh is (1, 1) ("data", "model"): DTensor then runs the same
local ops as the unsharded path.

- a sharded `make_train_step` step (fp32, TF32 off, 2 microbatches,
  constrain_grads on and off) equals the unsharded step from the same
  state: the loss within 1e-6 relative and every parameter within 1e-6
  of its leaf's largest element;
- `compressed_psum` over NCCL equals `decompress(*compress(g))` exactly
  (one rank's scale is its own);
- `pipeline_apply` with one stage equals the sequential layers within
  1e-5;
- sharded `prefill` and 4 `decode_step`s (fp32, the reduced configs of
  every family: parameters by `param_specs` + `shard_tree`, the cache
  placed by `cache_pspecs`) equal the unsharded ones: logits and every
  cache leaf within 1e-6 of their max, each cache leaf in its
  `cache_pspecs` placements after every step; B=1 also on the cache
  placed by the rule's branch for a batch that does not divide over dp
  (S over every mesh axis), which a dp group of one never picks itself.
"""

import copy

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import compress, compressed_psum, decompress
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step
from repro_torch.tree_util import leaves, tree_map
from torch_card import cuda_device  # noqa: F401  (fixture)
from torch_dist import free_port

TOL = 1e-6


@pytest.fixture(scope="module")
def world():
    """A one-rank NCCL group for the module's tests."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: NCCL has no CPU mode")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("constrain", [True, False])
@pytest.mark.parametrize("name", ["stablelm-3b", "phi3.5-moe-42b-a6.6b"])
def test_sharded_step_on_card_equals_unsharded(cuda_device, world, name, constrain):
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.models.sharding import MeshAxes, param_specs, shard_tree

    cfg = get_config(name).reduced()
    tcfg = TrainConfig(microbatches=2, dtype=torch.float32, constrain_grads=constrain,
                       optimizer=AdamWConfig(peak_lr=3e-4, warmup_steps=1, total_steps=10))
    state = init_train_state(cfg, tcfg, torch.Generator(device=cuda_device).manual_seed(0),
                             cuda_device)
    batch = SyntheticLM(cfg.vocab_size, 32, 8, seed=1).batch_at(0)
    axes = MeshAxes()
    mesh = make_test_mesh((1, 1), ("data", "model"))
    sharded = shard_tree(state, param_specs(axes, state), mesh)
    plain, m = make_train_step(cfg, tcfg)(copy.deepcopy(state), batch)
    with use_mesh(mesh):
        sharded, ms = make_train_step(cfg, tcfg, axes)(sharded, batch)
    assert abs(float(ms["loss"]) - float(m["loss"])) <= TOL * abs(float(m["loss"]))
    for got, want in zip(leaves(sharded.params), leaves(plain.params)):
        got, want = got.detach().full_tensor(), want.detach()
        assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.cuda
def test_compressed_psum_on_card(cuda_device, world):
    from repro_torch.launch.mesh import make_test_mesh, use_mesh

    g = torch.randn(3 * 256 + 17, generator=torch.Generator(device=cuda_device).manual_seed(2),
                    device=cuda_device)
    with use_mesh(make_test_mesh((1,), ("data",))):
        out = compressed_psum(g, "data")
    assert torch.equal(out, decompress(*compress(g), g.shape))


@pytest.mark.cuda
def test_pipeline_one_stage_on_card(cuda_device, world):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.pp import pipeline_apply

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = torch.randn(8, 16, 16, generator=gen, device=cuda_device) * 0.3
    x = torch.randn(4, 2, 16, generator=gen, device=cuda_device)
    y = pipeline_apply(lambda lw, h: torch.tanh(h @ lw), w, x,
                       make_test_mesh((1,), ("pipe",)))
    ref = x
    for layer in range(8):
        ref = torch.tanh(ref @ w[layer])
    assert float((y - ref).abs().max()) <= 1e-5


SERVE_CASES = [("stablelm-3b", 4), ("phi3.5-moe-42b-a6.6b", 4), ("gemma2-27b", 4),
               ("zamba2-1.2b", 4), ("rwkv6-7b", 4), ("stablelm-3b", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", SERVE_CASES)
def test_sharded_serving_on_card_equals_unsharded(cuda_device, world, name, batch):
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.models.sharding import (MeshAxes, cache_pspecs, dp_spec, param_specs,
                                             placements, shard_tree, spec_leaves)
    from repro_torch.models.transformer import decode_step, init_params, prefill

    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device,
                         dtype=torch.float32)
    axes = MeshAxes()
    mesh = make_test_mesh((1, 1), ("data", "model"))
    sharded = shard_tree(params, param_specs(axes, params), mesh)
    toks = torch.randint(0, cfg.vocab_size, (batch, 20),
                         generator=torch.Generator().manual_seed(4)).to(cuda_device)
    # B=1 runs on the non-divisible branch's placements (S over every axis)
    divisible = batch > 1

    def close(got, want):
        got = got.full_tensor()
        assert float((got - want).abs().max()) <= TOL * max(float(want.abs().max()), 1e-30)

    def check_cache(got, want):
        specs = spec_leaves(cache_pspecs(cfg, got, dp_spec(axes), axes.tp, divisible))
        for g, w, s in zip(leaves(got), leaves(want), specs):
            if torch.is_tensor(w):
                assert g.placements == placements(s, mesh), (s, g.placements)
                close(g, w)

    lg, cache = prefill(cfg, params, {"tokens": toks[:, :16]}, 32, dtype=torch.float32)
    with use_mesh(mesh):
        slg, scache = prefill(cfg, sharded, {"tokens": toks[:, :16]}, 32, axes=axes,
                              dtype=torch.float32)
    if not divisible:
        specs = cache_pspecs(cfg, scache, dp_spec(axes), axes.tp, False)
        scache = shard_tree(tree_map(lambda x: x.full_tensor() if torch.is_tensor(x) else x,
                                     scache), specs, mesh)
    close(slg, lg)
    check_cache(scache, cache)
    for t in range(16, 20):
        lg, cache = decode_step(cfg, params, cache, toks[:, t], dtype=torch.float32)
        with use_mesh(mesh):
            slg, scache = decode_step(cfg, sharded, scache, toks[:, t], axes=axes,
                                      dtype=torch.float32)
        close(slg, lg)
        check_cache(scache, cache)
