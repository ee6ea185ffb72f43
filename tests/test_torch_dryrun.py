"""The port's dry run (`repro_torch.launch.dryrun`) on small fake worlds,
twin of tests/test_distribution.py::test_dryrun_cell_builder_on_small_mesh.

Reduced stablelm-3b on a fake (4, 2) ("data", "model") world of 8 ranks:
the train, prefill and decode cells build and run under the counter on
fake tensors.  Each cell's argument bytes per device equal JAX's
`compiled.memory_analysis().argument_size_in_bytes` for the same cell
(JAX's `build_cell` compiled in a subprocess with 8 host devices; every
dim here divides its mesh dims, so XLA pads nothing; JAX's decode cache
holds "pos" as an int32 scalar, 4 bytes the port's Python int does not
take), and the ratio of the port's per-device flops to JAX's
`analyze_hlo` flops lies in [0.5, 2] (printed).  Reduced phi3.5-moe's
`opt` cells (the einsum dispatch with one group, fewer than the 4 dp
shards) build and run on a fake (2, 2, 2) multi-pod world.  `main`
writes a full-width stablelm-3b decode_32k record on the 256-rank
production mesh with JAX's keys and the counter's, its peak bytes per
device (the memory tracker's) at least its arguments.  Each fake world is
this process's default group only while its test runs.
"""

import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.roofline.op_count import OpCounter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = {"t": ShapeSpec("t", 32, 8, "train"),
         "p": ShapeSpec("p", 32, 8, "prefill"),
         "d": ShapeSpec("d", 32, 8, "decode")}

JAX_CELLS = """
import json, sys
import jax
jax.devices()  # the 8 host devices of XLA_FLAGS, before dryrun's import resets the flag
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch import dryrun
from repro.launch.mesh import make_test_mesh, use_mesh
from repro.roofline.hlo_analysis import analyze_hlo

cfg = get_config("stablelm-3b").reduced()
mesh = make_test_mesh((4, 2), ("data", "model"))
out = {}
for key, (name, seq, batch, kind) in json.loads(sys.argv[1]).items():
    with use_mesh(mesh):
        lowered, meta = dryrun.build_cell(cfg, ShapeSpec(name, seq, batch, kind), mesh, False)
        compiled = lowered.compile()
    mem = compiled.memory_analysis()
    out[key] = dict(argument=mem.argument_size_in_bytes,
                    flops=analyze_hlo(compiled.as_text())["flops"], tokens=meta["tokens"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    arg = json.dumps({k: [s.name, s.seq_len, s.global_batch, s.kind] for k, s in SPECS.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", JAX_CELLS, arg], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _run(cfg, spec, mesh, multi_pod, variant="baseline"):
    with dryrun.fake_tensors(), use_mesh(mesh):
        cell, meta = dryrun.build_cell(cfg, spec, mesh, multi_pod, variant)
        counter = OpCounter()
        with counter:
            out = cell()
        return dryrun.memory_of(cell, out), counter.result(), meta


@pytest.fixture(scope="module")
def port_cells():
    dryrun.fake_world(8)
    try:
        mesh = make_test_mesh((4, 2), ("data", "model"), device_type="cpu")
        cfg = get_config("stablelm-3b").reduced()
        return {k: _run(cfg, s, mesh, False) for k, s in SPECS.items()}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("key", list(SPECS))
def test_dryrun_cell_builder_on_small_mesh(port_cells, jax_cells, key):
    mem, counts, meta = port_cells[key]
    want = jax_cells[key]
    assert meta["tokens"] == want["tokens"]
    pos_bytes = 4 if SPECS[key].kind == "decode" else 0
    assert mem["argument_bytes_per_device"] + pos_bytes == want["argument"]
    ratio = counts["flops"] / want["flops"]
    print(f"{key}: port / JAX flops per device = {ratio:.3f}")
    assert 0.5 <= ratio <= 2.0
    assert counts["bytes"] > 0 and counts["collective_bytes"] > 0
    if SPECS[key].kind != "prefill":  # train updates the state, decode the cache, in place
        assert mem["alias_bytes_per_device"] > 0


def test_moe_opt_cells_on_a_multi_pod_world():
    dryrun.fake_world(8)
    try:
        mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
        cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
        assert SPECS["t"].global_batch * SPECS["t"].seq_len < cfg.dispatch_group  # one group
        for key in ("t", "p", "d"):
            mem, counts, _ = _run(cfg, SPECS[key], mesh, True, "opt")
            assert counts["flops"] > 0 and mem["argument_bytes_per_device"] > 0
            assert not counts["warnings"]
    finally:
        dist.destroy_process_group()


def test_main_writes_a_full_width_record(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "stablelm-3b", "--shape", "decode_32k", "--mesh", "single",
                     "--device", "cpu", "--out", str(tmp_path)])
    assert done.value.code == 0
    assert not dist.is_initialized()
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "done; failures=0"
    assert any(line.startswith("[ok     ] stablelm-3b") and "dom=memory_s" in line
               for line in lines)
    with open(tmp_path / "stablelm-3b__decode_32k__single.json") as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["chips"] == 256 and r["device"] == "cpu"
    assert set(r["op_count_per_device"]) >= {"flops", "bytes", "layout_bytes",
                                             "collective_bytes", "per_collective", "warnings"}
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                  "bound_s", "overlap_fraction"}
    cfg = get_config("stablelm-3b")
    kv = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads * cfg.head_dim * 2  # bf16 K and V
    mem = r["memory_analysis"]
    assert mem["alias_bytes_per_device"] == kv // 256
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes_per_device"] >= kv // 256
    assert mem["temp_bytes_per_device"] == (mem["peak_bytes_per_device"]
                                            - mem["argument_bytes_per_device"])
    assert r["model_flops_global"] == dryrun.model_flops(
        cfg, cfg.supported_shapes()["decode_32k"], 128)
