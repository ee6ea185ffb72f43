"""The port's example twins (`python -m repro_torch.examples.<name>`) on
the CPU, against the JAX package's examples where they print numbers.

- quickstart: the twin prints the numbers `examples/quickstart.py`
  prints (run as a subprocess), line for line, and its section headers
  but §4's (the kernel's name) and §2's ("TPU-native");
- serve_paged at `--reduced --device cpu --dtype float32` (the JAX
  example's own setting): every request served by both engines, equal
  tokens per request, the host pool fully coalesced and the jit
  engine's 128 pages free;
- train_tiny_lm cut to 12 steps with a failure at step 7 and a
  checkpoint every 5: one restart, the replayed steps' losses equal to
  their first run's, the loss lower at the end;
- elastic_restart on 4 gloo ranks, (2, 2) -> (1, 4) (the 8-rank (4, 2)
  -> (2, 4) run is `chip_smoke.py` phase examples'): its losses within
  1e-5 relative of the unsharded port's and `elastic rescale OK`;
- `--device cuda` without a card raises, in every twin.
The quickstart subprocess and the elastic twin (a subprocess of its own,
which starts the ranks and runs the unsharded steps) start first and run
while the other twins do.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import elastic_restart, quickstart, serve_paged, train_tiny_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"-?\d+(?:\.\d+)?")


ELASTIC = """
import json
from repro_torch.examples import elastic_restart
res = elastic_restart.run("cpu", meshes=((2, 2), (1, 4)), timeout=150)
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def background():
    """The JAX quickstart and the elastic twin, each a subprocess, started
    at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    procs = {
        "jax_quickstart": [os.path.join(REPO, "examples", "quickstart.py")],
        "elastic": ["-c", ELASTIC],
    }
    procs = {k: subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for k, args in procs.items()}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_paged_twin(background):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve_paged.main(["--reduced", "--device", "cpu", "--dtype", "float32"])
    text = buf.getvalue()
    assert "fully coalesced: True" in text
    host, jit = res["host"], res["jit"]
    assert host["completed"] == jit["completed"] == serve_paged.N_REQUESTS
    assert host["fully_coalesced"] and host["used_pages"] == 0
    assert host["out_tokens"] == jit["out_tokens"]
    assert jit["free_pages"] == serve_paged.GEOM["num_pages"]
    assert f"pool free={serve_paged.GEOM['num_pages']}/128" in text
    assert jit["stat_totals"]["freed_pages"] > 0


def test_train_tiny_lm_twin_restarts_once(background):
    res = train_tiny_lm.run("cpu", steps=12, fail_at=(7,), ckpt_every=5, out=lambda *a: None)
    assert res["restarts"] == 1
    # the failure at step 7 restarts from the checkpoint of step 5
    assert res["steps"] == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9, 10, 11]
    assert res["losses"][7:9] == res["losses"][5:7]
    assert res["last_mean"] < res["first_mean"]


def test_quickstart_twin_prints_the_jax_numbers(background):
    lines = []
    quickstart.run("cpu", out=lines.append)
    got = "\n".join(lines).splitlines()
    want_text, err = background["jax_quickstart"].communicate(timeout=120)
    assert background["jax_quickstart"].returncode == 0, err[-3000:]
    want = want_text.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.startswith(("== 2.", "== 4.")) or "bit-identical" in g:
            assert NUM.findall(g)[:1] == NUM.findall(w)[:1], (g, w)
        else:
            assert g == w


def test_elastic_restart_twin_on_4_ranks(background):
    text, err = background["elastic"].communicate(timeout=170)
    assert background["elastic"].returncode == 0, err[-3000:]
    lines = text.splitlines()
    res = json.loads(lines[-1])
    assert len(res["losses"]) == 8 and res["max_rel"] <= elastic_restart.LOSS_TOL
    assert res["backend"] == "gloo" and res["ranks"] == 4
    assert lines[-2] == "elastic rescale OK"
    assert any(line.startswith("  mesh=(1, 4) step 7") for line in lines)


@pytest.mark.parametrize("twin", [quickstart, serve_paged, train_tiny_lm, elastic_restart],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cuda_without_a_card_raises(twin):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main([])
