"""Telemetry snapshot dumper: metrics tables, event logs, Perfetto traces.

The port's twin of `tools/obsdump.py`, over the port's `obs/schema.py`
and `obs/trace_export.py`; for the same snapshot file its output and
its trace file are byte for byte the original's.  Input is a *snapshot*
JSON file, the host-side dump of the telemetry plane that
`JitServeEngine.snapshot()` produces (`python -m
repro_torch.examples.serve_paged --ring N --snapshot SNAP.json` writes
one).  It renders it three ways:

  python -m repro_torch.tools.obsdump SNAP.json                  # metric table
  python -m repro_torch.tools.obsdump SNAP.json --events         # ring event log
  python -m repro_torch.tools.obsdump SNAP.json --trace out.json # Perfetto trace

The trace is Chrome JSON: load it at https://ui.perfetto.dev or
chrome://tracing to scrub the admission -> alloc -> decode -> retire
timeline with free-page/occupancy counter tracks.

`--self-test` synthesizes a small snapshot, exports it, and validates
the result (structure, metric names, span/timestamp invariants).

Imports neither torch nor a device stack: it runs on any host.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

from repro_torch.obs.schema import spec
from repro_torch.obs.trace_export import (
    SNAPSHOT_VERSION,
    chrome_trace,
    save_trace,
    validate_snapshot,
    validate_trace,
)


def dump_metrics(snap) -> None:
    print(f"source: {snap['source']}   config: {snap.get('config', {})}")
    print(f"{'metric':<28} {'kind':<10} {'unit':<8} value")
    for name in sorted(snap["metrics"]):
        s = spec(name)
        val = snap["metrics"][name]
        if isinstance(val, list) and s.kind == "histogram":
            edges = list(s.buckets or ())
            labels = [f"<={e}" for e in edges] + ["inf"]
            val = " ".join(
                f"{lab}:{c}" for lab, c in zip(labels, val) if c
            ) or "(empty)"
        print(f"{name:<28} {s.kind:<10} {s.unit:<8} {val}")


def dump_events(snap) -> None:
    events = snap["events"]
    print(f"{len(events)} ring events "
          f"(dropped: {snap['metrics'].get('ring_dropped', 0)})")
    for ev in events:
        detail = " ".join(
            f"{k}={v}" for k, v in ev.items()
            if k not in ("step", "kind", "kind_name") and v
        )
        print(f"  step {ev['step']:>6}  {ev['kind_name']:<7} {detail}")


def self_test_snapshot() -> dict:
    """The synthetic snapshot of `--self-test`."""
    return {
        "obs_schema": SNAPSHOT_VERSION,
        "source": "obsdump --self-test",
        "config": {"n_shards": 2, "num_pages": 64},
        "metrics": {
            "steps": 8, "alloc_pages": 6, "freed_pages": 6,
            "free_pages": 64, "active_lanes": 0,
            "merged_writes": 40, "logical_rmws": 66,
            "fastpath_hits": 3, "fastpath_spills": 1,
            "magazine_hits": 4, "magazine_spills": 1,
            "magazine_refills": 2,
            "ring_events": 8, "ring_dropped": 0,
            "alloc_rounds_hist": [2, 4, 2, 0, 0, 0, 0, 0],
        },
        "events": [
            {"step": i, "kind": 1, "kind_name": "step",
             "lanes_won": i % 2, "lanes_overflowed": 0,
             "lanes_spilled": 0, "frees_merged": 1, "rounds": 1,
             "free_pages": 64 - i}
            for i in range(8)
        ],
        "spans": [
            {"phase": "admit", "t0": 0.0, "t1": 0.01,
             "step0": 0, "step1": 0, "admitted": 2},
            {"phase": "decode", "t0": 0.01, "t1": 0.09,
             "step0": 0, "step1": 8, "n": 8, "fused": 1},
            {"phase": "drain", "t0": 0.09, "t1": 0.10,
             "step0": 8, "step1": 8, "drained": 2},
        ],
    }


def self_test() -> int:
    """Synthesize a snapshot -> export -> validate."""
    snap = self_test_snapshot()
    validate_snapshot(snap)
    trace = chrome_trace(snap)
    validate_trace(trace)
    n_steps = sum(
        1 for e in trace["traceEvents"]
        if e["ph"] == "X" and e["name"].startswith("step ")
    )
    assert n_steps == 8, f"expected 8 step spans, got {n_steps}"
    counters = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    assert counters, "expected counter tracks"
    # the extended kernel stat slots (fastpath + magazine counters)
    # must be registered and render through the metric table
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dump_metrics(snap)
    table = buf.getvalue()
    for name in ("fastpath_hits", "magazine_hits", "magazine_spills",
                 "magazine_refills"):
        spec(name)  # registered in the schema
        assert name in table, f"metric table missing {name}"
    print(f"self-test ok: {len(trace['traceEvents'])} trace events, "
          f"{n_steps} step spans, {len(counters)} counter samples, "
          f"magazine counters rendered")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("snapshot", nargs="?", help="snapshot JSON file")
    ap.add_argument("--events", action="store_true",
                    help="print the drained ring event log")
    ap.add_argument("--trace", metavar="OUT",
                    help="write a Perfetto-loadable Chrome trace")
    ap.add_argument("--self-test", action="store_true",
                    help="synthesize+export+validate")
    args = ap.parse_args(argv)

    if args.self_test:
        return self_test()
    if not args.snapshot:
        ap.error("a snapshot file is required (or --self-test)")
    with open(args.snapshot) as f:
        snap = json.load(f)
    validate_snapshot(snap)
    if args.trace:
        path = save_trace(snap, args.trace)
        n = len(chrome_trace(snap)["traceEvents"])
        print(f"wrote {path} ({n} events) — load at ui.perfetto.dev")
        return 0
    if args.events:
        dump_events(snap)
        return 0
    dump_metrics(snap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
