"""`chip_smoke.py` phase ranks rehearsed on the CPU.

The phase runs the sharded cases of tests/test_torch_distribution_train.py,
_ssm.py, _steps.py, _serve.py, _serve_ssm.py, test_torch_distribution.py
and tests/test_torch_moe_einsum_sharded.py (there against JAX) on 4 gloo
ranks (`repro_torch.launch.ranks`), each against the unsharded port in
the calling process, with those files' tolerances; on the card machine
it does so under that machine's torch.  Here it runs under the torch
the tests run with, `torch.cuda` stubbed to fail on use (the phase and
its ranks touch no card): every case must pass, and the case list must
hold every case the phase owes.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()


def _no_card(name):
    def refuse(*a, **k):
        raise AssertionError(f"phase ranks called torch.cuda.{name}")
    return refuse


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    report = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("synchronize", "empty_cache", "Event", "set_device", "current_device"):
            mp.setattr(torch.cuda, name, _no_card(name))
        try:
            chip_smoke.phase_ranks(torch, torch.device("cpu"), report,
                                   out_dir=tmp_path_factory.mktemp("ranks"))
        except AssertionError as exc:   # each case's test reports its own row
            report["error"] = str(exc)
    return report


def test_case_list_holds_every_sharded_path():
    cases = chip_smoke.RANKS_CASES.values()
    grads = {(c["arch"], c.get("replace", {}).get("dispatch_mode", "scatter"),
              tuple(c["mesh"][0])) for c in cases if c["kind"] == "grads"}
    assert grads == {("stablelm-3b", "scatter", (2, 2)),
                     ("phi3.5-moe-42b-a6.6b", "scatter", (2, 2)),
                     ("phi3.5-moe-42b-a6.6b", "einsum", (2, 2)),
                     ("zamba2-1.2b", "scatter", (2, 2)), ("rwkv6-7b", "scatter", (2, 2)),
                     ("stablelm-3b", "scatter", (2, 2, 1))}
    kinds = [c["kind"] for c in cases]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "grads": 6, "steps": 1, "elastic": 1, "psum": 1, "pp": 1, "serve": 2}
    assert {c["arch"] for c in cases if c["kind"] == "serve"} == {"stablelm-3b", "zamba2-1.2b"}
    elastic = next(c for c in cases if c["kind"] == "elastic")
    assert (elastic["mesh"][0], elastic["to"][0]) == ((2, 2), (1, 4))
    assert all(chip_smoke.RANKS_N == _ranks(c["mesh"][0]) for c in cases)


def _ranks(shape):
    n = 1
    for s in shape:
        n *= s
    return n


@pytest.mark.parametrize("case", list(chip_smoke.RANKS_CASES))
def test_case_within_tolerance_of_unsharded(phase, case):
    assert "ranks" in phase, phase.get("error")
    row = next(r for r in phase["ranks"]["rows"] if r["case"] == case)
    assert row["ok"], (row["detail"], row["error"])
    assert row["seconds"] is not None and row["unsharded_s"] is not None
