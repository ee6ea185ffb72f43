"""The port's dry-run input stand-ins and model flops against the JAX
package's, for every arch x supported shape at full size.

`input_specs` and `cache_specs` (`repro_torch.configs.registry`) give
meta tensors with the shapes and dtypes of JAX's `jax.ShapeDtypeStruct`
trees (JAX's cache through `jax.eval_shape` of its `init_cache`; its
"pos" is an int32 scalar, the port's the Python int 0), and nothing is
allocated.  `launch.dryrun.model_flops` equals JAX's exactly; JAX's is
computed in a subprocess, because importing `repro.launch.dryrun` sets
`XLA_FLAGS` for the process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import cache_specs as jcache_specs
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro_torch.configs import ARCH_NAMES, cache_specs, get_config, input_specs
from repro_torch.launch.dryrun import model_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in ARCH_NAMES for s in get_config(a).supported_shapes()]


def _tokens(shape) -> int:
    return shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _record(leaf):
    return (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_and_cache_specs_match_jax(arch, shape_name):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape = cfg.supported_shapes()[shape_name]
    jshape = jcfg.supported_shapes()[shape_name]
    got, want = _flat(input_specs(cfg, shape)), _flat(jinput_specs(jcfg, jshape))
    assert {k: _record(v) for k, v in got.items()} == {k: _record(v) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())

    got, want = _flat(cache_specs(cfg, shape)), _flat(jcache_specs(jcfg, jshape))
    assert got.pop("/pos") == 0
    assert _record(want.pop("/pos")) == ((), "int32")
    assert {k: _record(v) for k, v in got.items()} == {k: _record(v) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())


def test_specs_follow_the_device_they_are_given():
    cfg = get_config("stablelm-3b")
    shape = cfg.supported_shapes()["decode_32k"]
    with torch._subclasses.fake_tensor.FakeTensorMode():
        cache = cache_specs(cfg, shape, device="cpu")
        batch = input_specs(cfg, shape, device="cpu")
    assert isinstance(cache["k"], torch._subclasses.fake_tensor.FakeTensor)
    assert cache["k"].device.type == "cpu" and batch["tokens"].device.type == "cpu"


@pytest.fixture(scope="module")
def jax_model_flops():
    code = (
        "import json\n"
        "from repro.configs import ARCH_NAMES, get_config\n"
        "from repro.launch.dryrun import model_flops\n"
        "out = {}\n"
        "for a in ARCH_NAMES:\n"
        "    cfg = get_config(a)\n"
        "    for n, s in cfg.supported_shapes().items():\n"
        "        t = s.global_batch * (1 if s.kind == 'decode' else s.seq_len)\n"
        "        out[a + '/' + n] = model_flops(cfg, s, t)\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_model_flops_match_jax(jax_model_flops, arch, shape_name):
    cfg = get_config(arch)
    shape = cfg.supported_shapes()[shape_name]
    got = model_flops(cfg, shape, _tokens(shape))
    assert got == jax_model_flops[f"{arch}/{shape_name}"]
    assert np.isfinite(got) and got > 0
