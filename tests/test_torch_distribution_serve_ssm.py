"""Sharded serving on four gloo ranks against the JAX package, as
tests/test_torch_distribution_serve.py runs the attention families:
zamba2-1.2b and rwkv6-7b reduced on a (2, 2) ("data", "model") mesh
(the Mamba2 `ssm` and `conv` states and the RWKV `wkv`, `tm_x`, `cm_x`
states on the model axis by `cache_pspecs`, written in place on their
shards; the SSD scan, the Mamba2 decode step and the wkv scan run on
each rank's batch rows and heads), and stablelm-3b on a (2, 1, 2)
("pod", "data", "model") mesh with ('pod', 'data') as the dp group.
Sharded fp32 `prefill` plus 4 `decode_step`s; logits and gathered cache
leaves within 1e-5 of their max, `cache_pspecs`' placements after every
step, every leaf changed by value.
"""

import pytest

from test_torch_distribution_serve import POD, check_case, start_runs

CASES = {
    "zamba2-1.2b": dict(POD, arch="zamba2-1.2b", batch=4),
    "rwkv6-7b": dict(POD, arch="rwkv6-7b", batch=4),
    "stablelm-3b-multipod": dict(arch="stablelm-3b", batch=4,
                                 mesh=((2, 1, 2), ("pod", "data", "model")),
                                 axes=dict(dp=("pod", "data"))),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_runs(tmp_path_factory.mktemp("dist_serve_ssm"), CASES)


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_serving_matches_jax(runs, key):
    check_case(runs, key)
