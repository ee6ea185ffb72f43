"""The hybrid and ssm families' sharded loss and gradients on four gloo
ranks against the JAX package's unsharded ones, as
tests/test_torch_distribution_train.py runs the attention families:
zamba2-1.2b and rwkv6-7b reduced, fp32, remat on, on a (2, 2) ("data",
"model") mesh (`_hybrid_body` and `_ssm_body` with `axes`; the Mamba2
conv leaves and the RWKV projections sharded by JAX's rules).  The loss
within 1e-5 relative and each gradient leaf within 2e-5 of its largest
element: the bounds of tests/test_torch_hybrid_ssm_train.py, which
holds the unsharded port to JAX on these families.
"""

import pytest

from test_torch_distribution_train import POD, check_case, start_runs

CASES = {"zamba2-1.2b": dict(POD, arch="zamba2-1.2b", replace={}),
         "rwkv6-7b": dict(POD, arch="rwkv6-7b", replace={})}
LOSS_TOL, GRAD_TOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_runs(tmp_path_factory.mktemp("dist_ssm"), CASES)


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_loss_and_grads_match_jax(runs, key):
    check_case(runs, key, LOSS_TOL, GRAD_TOL)
