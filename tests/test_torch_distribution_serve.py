"""The port's sharded serving entry points against the JAX package's.

- `cache_pspecs` and `batch_specs` (`models.sharding`) equal JAX's
  `launch/dryrun.py` rules, spec for spec (compared as tuples), for the
  reduced `init_cache` tree and a batch of every registry config, with
  B = 4 (divisible over a dp group of 2) and B = 1, on the one-pod dp
  axis and the multi-pod ('pod', 'data') group; the cache trees' leaf
  shapes agree too.  JAX's side runs in a subprocess: importing
  `repro.launch.dryrun` forces 512 host devices on JAX.
- Four gloo ranks (`torch_dist.Ranks`), parameters from JAX's
  `init_params` through numpy, on a (2, 2) ("data", "model") mesh:
  sharded fp32 `prefill` (B = 4, S = 16, `max_len` 32) and 4
  `decode_step`s on seeded tokens against JAX's unsharded `prefill` /
  `decode_step`.  Logits within 1e-5 of their largest |value|; every
  cache leaf, gathered by `full_tensor()`, within 1e-5 of its largest;
  after prefill and every step each leaf holds `cache_pspecs`'
  placements (checked on the ranks) and every tensor leaf has changed
  by value; inside `prefill` and `decode_step` no K/V cache leaf (nor a
  layer of one) is redistributed (`DTensor.redistribute` wrapped on the
  ranks).  stablelm-3b, phi3.5-moe, gemma2-27b (a window of 8 that
  the 20 positions pass) and llava-next-34b (embeds alone) here;
  stablelm-3b also with B = 1 (the cache rule's S over every axis, a
  cache of 30 in uneven shards, uneven activations kept whole).
  `shard_range` is held against DTensor's own shards on the ranks,
  an empty one included.  The hybrid and ssm families, and
  stablelm-3b on a (2, 1, 2) ("pod", "data", "model") mesh with dp over
  two axes: tests/test_torch_distribution_serve_ssm.py.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCH_NAMES
from repro_torch.models.sharding import batch_specs, cache_pspecs, spec_leaves
from repro_torch.models.transformer import init_cache
from repro_torch.tree_util import flatten
from torch_dist import REPO, Ranks, load_tree, save_tree

POD = dict(mesh=((2, 2), ("data", "model")), axes={})
CASES = {  # name: the arch, the batch, the mesh and MeshAxes' arguments
    "stablelm-3b": dict(POD, arch="stablelm-3b", batch=4),
    "phi3.5-moe": dict(POD, arch="phi3.5-moe-42b-a6.6b", batch=4),
    "gemma2-27b": dict(POD, arch="gemma2-27b", batch=4),
    "llava-next-34b": dict(POD, arch="llava-next-34b", batch=4),
    # B = 1 and a cache of 30 over the 4 ranks: S shards of 8, 8, 8 and 6
    # rows, the last one beyond every position written
    "stablelm-3b-b1": dict(POD, arch="stablelm-3b", batch=1, max_len=30),
}
S, MAX_LEN, STEPS = 16, 32, 4
TOL = 1e-5

RANK_SCRIPT = """
from torch.distributed.tensor import DTensor
from torch_dist import load_tree, save_tree
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.models.sharding import (MeshAxes, batch_divisible, cache_pspecs, dp_spec,
                                         param_specs, placements, shard_tree, spec_leaves)
from repro_torch.models.transformer import decode_step, params_from_numpy, prefill
from repro_torch.tree_util import flatten, tree_map

from torch.distributed.tensor import distribute_tensor
from repro_torch.models.sharding import P, shard_range

full = lambda x: x.full_tensor().numpy() if isinstance(x, DTensor) else x

# shard_range against DTensor's own shards: rows over each mesh dim and
# over both (the first major), uneven and empty shards included
mesh = make_test_mesh((2, 2), ("data", "model"))
for size in (1, 3, 25, 30, 32):
    for spec in (P(("data", "model")), P("model"), P("data")):
        place = placements(spec, mesh)
        got = distribute_tensor(torch.arange(size), mesh, place).to_local()
        start, n = shard_range(size, mesh, place, 0)
        assert torch.equal(got, torch.arange(start, start + n)), (size, spec, start, n, got)

# no K/V cache leaf, nor a layer of one, is redistributed inside prefill or
# decode_step: a DTensor whose dim -3 is max_len is the cache
guard = [None]
redistribute = DTensor.redistribute


def guarded(self, *a, **kw):
    assert not (guard[0] and self.ndim >= 4 and self.shape[-3] == guard[0]), (
        "a K/V cache leaf was redistributed", self.shape, self.placements, a)
    return redistribute(self, *a, **kw)


DTensor.redistribute = guarded

for key, case in CASES.items():
    cfg = get_config(case["arch"]).reduced()
    axes = MeshAxes(**case["axes"])
    mesh = make_test_mesh(*case["mesh"])
    inp = dict(np.load(os.path.join(OUT, "inputs_" + key + ".npz")))
    params = params_from_numpy(cfg, load_tree(os.path.join(OUT, case["arch"] + ".npz")), "cpu")
    params = shard_tree(params, param_specs(axes, params), mesh)
    batch = {k: torch.from_numpy(inp[k]) for k in ("tokens", "embeds") if k in inp}
    max_len = case.get("max_len", MAX_LEN)
    specs = None
    out = {}

    def record(name, lg, cache, before):
        global specs
        if specs is None:
            specs = spec_leaves(cache_pspecs(cfg, cache, dp_spec(axes), axes.tp,
                                             batch_divisible(case["batch"], mesh, axes)))
        now = flatten(cache)[0]
        for x, s in zip(now, specs):
            if torch.is_tensor(x):
                assert x.placements == placements(s, mesh), (key, name, s, x.placements)
        whole = tree_map(full, cache)
        if before is not None:
            for a, b in zip(flatten(whole)[0], flatten(before)[0]):
                assert not np.array_equal(a, b), (key, name, "a cache leaf did not change")
        out[name] = dict(logits=full(lg), cache=whole)
        return whole

    with use_mesh(mesh):
        guard[0] = max_len
        lg, cache = prefill(cfg, params, batch, max_len, axes=axes, dtype=torch.float32)
        guard[0] = None
        whole = record("prefill", lg, cache, None)
        for t in range(STEPS):
            guard[0] = max_len
            lg, cache = decode_step(cfg, params, cache, torch.from_numpy(inp["decode"][:, t]),
                                    axes=axes, dtype=torch.float32)
            guard[0] = None
            whole = record(f"step{t}", lg, cache, whole)
    if RANK == 0:
        save_tree(os.path.join(OUT, "serve_" + key + ".npz"), out)
print("RANK OK")
"""


def _inputs(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    inp = {"decode": rng.integers(0, cfg.vocab_size, (batch, STEPS)).astype(np.int32)}
    if cfg.frontend != "none":
        inp["embeds"] = rng.standard_normal((batch, S, cfg.d_model)).astype(np.float32)
    else:
        inp["tokens"] = rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)
    return inp


def _cache_leaves(cache) -> dict:
    """JAX's cache as {"/"-joined path: array}, "pos" left out."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif prefix != "pos":
            flat[prefix] = np.asarray(node)
    walk(cache, "")
    return flat


def start_runs(d, cases) -> dict:
    """Write the inputs, start the ranks on `cases`, compute JAX's
    unsharded prefill and decode steps of each case meanwhile, collect."""
    jparams = {}
    for arch in {c["arch"] for c in cases.values()}:
        jparams[arch] = jinit_params(jget_config(arch).reduced(), jax.random.PRNGKey(0))
        save_tree(d / f"{arch}.npz", jax.tree.map(np.asarray, jparams[arch]))
    inputs = {}
    for i, (key, case) in enumerate(cases.items()):
        inputs[key] = _inputs(get_config(case["arch"]).reduced(), case["batch"], 10 + i)
        np.savez(d / f"inputs_{key}.npz", **inputs[key])
    ranks = Ranks(4, f"CASES = {cases!r}\nMAX_LEN, STEPS = {MAX_LEN}, {STEPS}\n" + RANK_SCRIPT,
                  d)
    pf = jax.jit(jprefill, static_argnums=(0, 3), static_argnames=("dtype",))
    dec = jax.jit(jdecode_step, static_argnums=(0,), static_argnames=("dtype",))
    ref = {"dir": d}
    for key, case in cases.items():
        jcfg = jget_config(case["arch"]).reduced()
        inp = inputs[key]
        batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "embeds") if k in inp}
        lg, cache = pf(jcfg, jparams[case["arch"]], batch, case.get("max_len", MAX_LEN),
                       dtype=jnp.float32)
        steps = {"prefill": (np.asarray(lg), _cache_leaves(cache))}
        for t in range(STEPS):
            lg, cache = dec(jcfg, jparams[case["arch"]], cache, jnp.asarray(inp["decode"][:, t]),
                            dtype=jnp.float32)
            steps[f"step{t}"] = (np.asarray(lg), _cache_leaves(cache))
        ref[key] = steps
    outs = ranks.wait(timeout=170)
    assert all("RANK OK" in o for o in outs)
    return ref


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale, what


def check_case(runs, key) -> None:
    got = load_tree(runs["dir"] / f"serve_{key}.npz")
    assert sorted(got) == sorted(runs[key])
    for name, (logits, cache) in runs[key].items():
        _close(got[name]["logits"], logits, (key, name, "logits"))
        port = {k: v for k, v in zip(*_paths(got[name]["cache"]))}
        assert int(port.pop("pos")) == (S if name == "prefill" else S + int(name[4:]) + 1)
        assert sorted(port) == sorted(cache)
        for path, want in cache.items():
            _close(port[path], want, (key, name, path))


def _paths(tree, prefix=""):
    names, vals = [], []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            n, x = _paths(v, p)
            names += n
            vals += x
        else:
            names.append(p)
            vals.append(v)
    return names, vals


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_runs(tmp_path_factory.mktemp("dist_serve"), CASES)


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_serving_matches_jax(runs, key):
    check_case(runs, key)


# ---------------------------------------------------------------------------
# the placement rules, against JAX's in a subprocess
# ---------------------------------------------------------------------------

DPS = {"pod": "data", "multipod": ("pod", "data")}
BATCHES = (4, 1)   # over a dp group of 2: divisible, and not

JAX_SPECS = """
import json, sys
import jax, jax.numpy as jnp
from repro.launch.dryrun import batch_specs, cache_pspecs
from repro.configs import get_config
from repro.models.transformer import init_cache

names, dps, batches, seq, max_len = json.loads(sys.argv[1])
spec = lambda s: [list(e) if isinstance(e, tuple) else e for e in s]
leaves = lambda tree: jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
out = {}
for name in names:
    cfg = get_config(name).reduced()
    for B in batches:
        cache = jax.eval_shape(lambda: init_cache(cfg, B, max_len))
        batch = {"labels": jax.ShapeDtypeStruct((B, seq), jnp.int32),
                 ("embeds" if cfg.frontend != "none" else "tokens"):
                 jax.ShapeDtypeStruct((B, seq, cfg.d_model) if cfg.frontend != "none"
                                      else (B, seq), jnp.float32)}
        for dk, dp in dps.items():
            dp = tuple(dp) if isinstance(dp, list) else dp
            div = B % 2 == 0
            out[f"{name}|{B}|{dk}"] = dict(
                cache=[spec(s) for s in leaves(cache_pspecs(cfg, cache, dp, "model", div))],
                batch=[spec(s) for s in leaves(batch_specs(batch, dp, div))],
                shapes=[list(x.shape) for x in jax.tree.leaves(cache)])
print(json.dumps(out))
"""


def _tuples(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


@pytest.fixture(scope="module")
def jax_specs():
    arg = json.dumps([list(ARCH_NAMES), DPS, list(BATCHES), S, MAX_LEN])
    r = subprocess.run([sys.executable, "-c", JAX_SPECS, arg], capture_output=True, text=True,
                       timeout=240, env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                                             JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_and_batch_specs_match_jax(jax_specs, name, B):
    cfg = get_config(name).reduced()
    cache = init_cache(cfg, B, MAX_LEN, torch.float32, "meta")
    lead = "embeds" if cfg.frontend != "none" else "tokens"
    batch = {"labels": torch.empty((B, S), device="meta"),
             lead: torch.empty((B, S, cfg.d_model) if lead == "embeds" else (B, S),
                               device="meta")}
    for dk, dp in DPS.items():
        want = jax_specs[f"{name}|{B}|{dk}"]
        div = B % 2 == 0
        got = [tuple(s) for s in spec_leaves(cache_pspecs(cfg, cache, dp, "model", div))]
        assert got == [_tuples(s) for s in want["cache"]], (dk, got)
        # every config's cache has a leaf that the rules split
        assert any(any(e is not None for e in s) for s in got)
        got = [tuple(s) for s in spec_leaves(batch_specs(batch, dp, div))]
        assert got == [_tuples(s) for s in want["batch"]], (dk, got)
        shapes = [list(x.shape) if torch.is_tensor(x) else [] for x in flatten(cache)[0]]
        assert shapes == want["shapes"]
