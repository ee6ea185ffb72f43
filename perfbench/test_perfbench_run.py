"""A whole run at a tiny size on the CPU (`harness.run`, past the look for
a card): the last line's schema, the refusals of `run.py`, the contract
of `BENCHMARK.json`, and an import scan of the benchmark's sources."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.conftest import CELLS, tiny_spec

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_last_line_schema(name, few_threads):
    out, lines = harness.run(tiny_spec(name), 2 ** 31 + 5, 4.0, False, "cpu", time.perf_counter())
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool) and out["attempted"] > 0 and out["failed"] >= 0
    want = {m["name"]: m["unit"] for m in harness.cell_metrics(harness.cell_spec(name)["bench"],
                                                               name, False)}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(isinstance(v["value"], float) and v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.loads(json.dumps(out))
    # the numbers compared close the log, each beside its limit
    tail = lines[-len(out["checks"]):]
    assert [ln.split(":")[0] for ln in tail] == [f"check {k}" for k in out["checks"]]
    assert all(f"(limit {c['limit']})" in ln for ln, c in zip(tail, out["checks"].values()))


def run_py(cwd, *extra):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "stablelm-3b.chat-batch", "--seed", str(2 ** 31 + 9), "--seconds",
                           "1", *extra], cwd=cwd, capture_output=True, text=True, timeout=120)


def test_run_py_refuses_without_a_card():
    p = run_py(ROOT)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_run_py_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_py(tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()


def test_forbidden_modules_by_top_level_name():
    assert harness.forbidden_modules(["repro_torch.serve", "torch", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax"]) == ["flax", "jax",
                                                                               "repro"]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_import_scan():
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        names = top_level_imports(f)
        assert not names & {"jax", "jaxlib", "flax", "repro"}, f
        if "reference" in f.parts:
            assert not names & {"repro_torch"}, f
            assert names <= {"__future__", "contextlib", "numpy", "torch", "perfbench"}, f


def test_benchmark_json_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"] and b["paths"] == ["perfbench"]
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # 24 cells at this length fit a full check's 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert all(k in conf["arch"] for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "perfbench" / "workloads" / f"{w['name']}.json").exists()
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
        e2e = harness.cell_metrics(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.cell_metrics(b, w["name"], True)
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and m["name"] not in seen and UNIT.match(m["unit"])
            seen.add(m["name"])
            assert m["better"] in ("lower", "higher")
            harness.reader(m["name"])
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
            else:
                assert m["source"] in ("device_trace", "program_span", "program_counter",
                                       "host_clock")
                assert m["moves"] in {e["name"] for e in b["end_to_end"]}
                assert all(m["moves"] in {e["name"] for e in harness.cell_metrics(b, n, False)}
                           for n in m["workloads"])
    assert next(m for m in b["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
