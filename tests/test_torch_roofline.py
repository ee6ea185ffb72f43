"""The port's per-device operation counter (`repro_torch.roofline.op_count`),
twin of tests/test_roofline.py: the instrument behind the dry run's
roofline terms must itself be right.

JAX's analyzer walks compiled HLO and allows 1-2% on its flop counts;
the port counts the aten ops of an eager call, so its twins hold the
counts exactly: a matmul, a batched dot, a loop of 12 matmuls (12 times
one), the H100 terms, an all-reduce classified on a fake world of 4
ranks (`x P(None, "d") @ w P("d", None)`), and a matmul sharded 4 ways
counted per device (a quarter of the global flops), the same on a cold
and a warm DTensor propagation cache.  The fake world is this process's
default group while the module runs, destroyed after it.
"""

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.roofline.op_count import COLLECTIVES, HW_H100, analyze_ops, roofline_terms


def test_matmul_flops_exact():
    r = analyze_ops(lambda a, b: a @ b, torch.randn(128, 256), torch.randn(256, 64))
    assert r["flops"] == 2 * 128 * 256 * 64
    assert r["bytes"] == 4 * (128 * 256 + 256 * 64 + 128 * 64)


def test_batched_dot():
    r = analyze_ops(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                    torch.randn(4, 32, 64), torch.randn(4, 64, 16))
    assert r["flops"] == 2 * 4 * 32 * 64 * 16


def test_scan_trip_count_multiplies_flops():
    x, w = torch.randn(64, 64), torch.randn(64, 64)

    def loop(n):
        def f(x, w):
            for _ in range(n):
                x = torch.tanh(x @ w)
            return x
        return f

    f1 = analyze_ops(loop(1), x, w)["flops"]
    f12 = analyze_ops(loop(12), x, w)["flops"]
    assert f1 == 2 * 64 ** 3 + 64 * 64
    assert f12 == 12 * f1


def test_nested_loops_compose():
    x, w = torch.randn(32, 32), torch.randn(32, 32)

    def f(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    assert analyze_ops(f, x, w)["flops"] == 12 * 2 * 32 ** 3


def test_views_cost_nothing_and_layout_copies_go_apart():
    x = torch.randn(64, 32)
    assert analyze_ops(lambda x: x.t().reshape(32, 64)[:4], x)["n_ops"] == 0
    r = analyze_ops(lambda x: x.t().contiguous(), x)
    assert r["bytes"] == 0 and r["layout_bytes"] == 2 * 64 * 32 * 4


def test_write_into_a_slice_counts_the_slice():
    cache, upd = torch.zeros(64, 1024, 16), torch.randn(64, 1, 16)

    def f(cache, upd):
        for i in range(8):
            cache[:, i:i + 1].copy_(upd)
        return cache

    r = analyze_ops(f, cache, upd)
    assert r["bytes"] == 8 * 2 * 64 * 16 * 4  # far below one buffer's worth
    assert r["layout_bytes"] == 0


def test_dominant_and_fraction():
    t = roofline_terms({"flops": 989e12, "bytes": 3.35e10, "collective_bytes": 4.5e8})
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.01)
    assert t["collective_s"] == pytest.approx(0.001)
    assert t["dominant"] == "compute_s"
    assert 0.97 < t["overlap_fraction"] <= 1.0
    assert HW_H100["hbm_bytes"] == 80e9


@pytest.fixture(scope="module")
def mesh4():
    fake_world(4)
    try:
        yield make_test_mesh((4,), ("d",), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_collective_bytes_and_classification(mesh4):
    with FakeTensorMode():
        x = dtensor_zeros((64, 64), device_mesh=mesh4, placements=[Shard(1)])
        w = dtensor_zeros((64, 64), device_mesh=mesh4, placements=[Shard(0)])
        r = analyze_ops(lambda x, w: (x @ w).sum().full_tensor(), x, w)
    assert r["collective_bytes"] > 0
    assert set(r["per_collective"]) == {"all-reduce"} and "all-reduce" in COLLECTIVES
    assert r["per_collective"]["all-reduce"] == 4  # the partial sum, one float
    assert r["flops"] >= 2 * 64 * 16 * 64


def test_sharded_matmul_counts_per_device(mesh4):
    x = distribute_tensor(torch.randn(64, 128), mesh4, [Shard(0)])
    w = distribute_tensor(torch.randn(128, 32), mesh4, [Replicate()])
    cold = analyze_ops(lambda x, w: x @ w, x, w)  # the first call propagates
    warm = analyze_ops(lambda x, w: x @ w, x, w)
    assert cold["flops"] == warm["flops"] == 2 * 64 * 128 * 32 / 4
    assert cold["bytes"] == warm["bytes"] == 4 * (16 * 128 + 128 * 32 + 16 * 32)
    assert cold["collective_bytes"] == 0
