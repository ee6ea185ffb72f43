"""The port's obsdump twin (`python -m repro_torch.tools.obsdump`) against
`tools/obsdump.py`, each run as a subprocess on the same snapshot file:
the metric table, `--events` and `--trace OUT` (stdout and the trace
file) byte for byte, on three snapshots: the port's `JitServeEngine`
with `ring_capacity` on stablelm-3b's reduced config (the serve_paged
twin's jit run, written by its `--snapshot`), the same run with
`trace=True` (its spans nested by id, with the spans' own fields as the
trace's args), and the self-test's synthetic one.  The engine's
snapshots carry its host reads by site (`host_reads`), which both
packages' `validate_snapshot` pass and both tools read past alike.  The twin's `--self-test` exits 0 and prints what the
original prints.  The twin imports no torch: it runs on any host.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro.obs import trace_export as jexport
from repro_torch.configs import get_config
from repro_torch.examples import serve_paged
from repro_torch.models.transformer import init_params
from repro_torch.obs import trace_export as texport
from repro_torch.serve.jit_engine import JitServeEngine
from repro_torch.tools import obsdump

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
JAX_TOOL = [sys.executable, os.path.join(REPO, "tools", "obsdump.py")]
TWIN = [sys.executable, "-m", "repro_torch.tools.obsdump"]
MODES = {"metrics": [], "events": ["--events"], "trace": ["--trace"]}


def _run(cmd, cwd):
    r = subprocess.run(cmd, capture_output=True, env=ENV, cwd=cwd, timeout=60)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    d = tmp_path_factory.mktemp("obsdump")
    cfg = get_config("stablelm-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = d / "engine.json"
    res = serve_paged.run(cfg, params, "cpu", torch.float32, ring=64, snapshot=str(engine),
                          out=lambda *a: None)
    assert res["jit"]["completed"] == serve_paged.N_REQUESTS
    eng = JitServeEngine(cfg, params, dtype=torch.float32, device="cpu", ring_capacity=64,
                         trace=True, **serve_paged.GEOM, **serve_paged.JIT_GEOM)
    for req in serve_paged.burst(cfg.vocab_size):
        eng.submit(req)
    eng.run_to_completion(chunk=serve_paged.CHUNK)
    traced = d / "traced.json"
    traced.write_text(json.dumps(eng.snapshot(), indent=1))
    synthetic = d / "synthetic.json"
    synthetic.write_text(json.dumps(obsdump.self_test_snapshot(), indent=1))
    return {"engine": engine, "traced": traced, "synthetic": synthetic}


@pytest.mark.parametrize("snap", ["engine", "traced"])
def test_engine_snapshot_has_events_and_spans(snapshots, snap):
    snap = json.loads(snapshots[snap].read_text())
    assert snap["source"] == "jit_engine" and snap["config"]["ring_capacity"] == 64
    assert snap["events"] and snap["spans"]
    assert snap["metrics"]["ring_events"] == len(snap["events"]) + snap["metrics"]["ring_dropped"]
    assert snap["host_reads"]["lanes"] > 0 and snap["host_reads"]["claim"] > 0
    assert snap["host_reads"]["drain"] > 0
    for validate in (texport.validate_snapshot, jexport.validate_snapshot):
        validate(snap)


def test_traced_snapshot_holds_the_untraced_records(snapshots):
    plain, traced = (json.loads(snapshots[k].read_text()) for k in ("engine", "traced"))
    assert plain["metrics"] == traced["metrics"] and plain["events"] == traced["events"]
    assert plain["host_reads"] == traced["host_reads"]
    # each host read is one `sync.*` span of the traced log
    assert sum(traced["host_reads"].values()) == sum(
        sp["phase"].startswith("sync.") for sp in traced["spans"])
    phases = {sp["phase"] for sp in traced["spans"]}
    assert {"request", "claim", "sync.claim", "prefill", "prefill.attention", "prefill.ffn",
            "insert", "queued", "sync.lanes", "sync.drain"} <= phases
    assert all("id" in sp and "parent" in sp for sp in traced["spans"])

    def untimed(sp):
        return {k: v for k, v in sp.items() if k not in ("t0", "t1", "id", "parent")}

    # an untraced log keeps the rounds that admitted, every chunk, the
    # drains that drained; a traced one logs every round and drain
    top = [untimed(sp) for sp in traced["spans"] if sp["parent"] is None
           and (sp["phase"] == "decode" or "admitted" in sp or "drained" in sp)]
    assert top == [untimed(sp) for sp in plain["spans"]]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("snap", ["engine", "traced", "synthetic"])
def test_output_byte_equal_to_jax_tool(snapshots, tmp_path, snap, mode):
    args = [str(snapshots[snap])] + MODES[mode]
    if mode == "trace":
        args.append("out.trace.json")   # the same relative path: it is printed
    outs = {}
    for name, tool in (("jax", JAX_TOOL), ("twin", TWIN)):
        cwd = tmp_path / name
        cwd.mkdir()
        stdout = _run(tool + args, cwd)
        trace = (cwd / "out.trace.json").read_bytes() if mode == "trace" else b""
        outs[name] = (stdout, trace)
    assert outs["twin"][0] == outs["jax"][0]
    assert outs["twin"][1] == outs["jax"][1]
    assert outs["twin"][0]
    if mode == "trace":
        trace = json.loads(outs["twin"][1])
        obsdump.validate_trace(trace)
        assert any(e["ph"] == "X" and e["name"].startswith("step ")
                   for e in trace["traceEvents"])


def test_self_test_exits_0_as_the_jax_tool(tmp_path):
    twin = _run(TWIN + ["--self-test"], tmp_path)
    assert twin.startswith(b"self-test ok:")
    assert twin == _run(JAX_TOOL + ["--self-test"], tmp_path)


def test_twin_needs_no_torch():
    r = subprocess.run([sys.executable, "-c", "import sys, repro_torch.tools.obsdump; "
                        "print('torch' in sys.modules)"], capture_output=True, text=True,
                       env=ENV, timeout=60)
    assert r.returncode == 0 and r.stdout.strip() == "False", r.stderr
