"""A traced run at a tiny size on the CPU: the result line carries the
trace's device keys and breakdown, and the per-layer readers that read
host spans and event pairs find something (the device-trace readers
find no card here and stay silent)."""

from __future__ import annotations

import time

from perfbench import harness
from perfbench.conftest import tiny_spec


def test_traced_run_reports_the_layers(few_threads):
    name = "stablelm-3b.chat-batch"
    out, _ = harness.run(tiny_spec(name), 11, 3.0, True, "cpu", time.perf_counter())
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in harness.cell_metrics(harness.cell_spec(name)["bench"],
                                                         name, True)}
    # on the CPU the readers of host spans and event pairs find something
    assert {"admit_ms_per_request.batch", "decode_step_ms.batch", "decode_mfu"} \
        <= set(out["metrics"]) <= per_layer
