"""Chrome-trace / Perfetto export of a drained telemetry snapshot.

A copy of `repro/obs/trace_export.py` (plain Python, with `spec` from
the port's `obs/schema.py`).  A *snapshot* is the host-side,
JSON-serialisable dump of the telemetry plane at a drain boundary
(`JitServeEngine.snapshot()` produces one):

  {
    "obs_schema": 1,
    "source": "jit_engine",
    "config": {...engine geometry...},
    "metrics": {name: int | [int, ...]},       # schema-checked names
    "events": [{step, kind, kind_name, ...}],  # drained ring window
    "spans": [{"phase": "admit"|"decode"|"drain",
               "t0": s, "t1": s, "step0": n, "step1": n, ...}],
  }

`chrome_trace` renders it as a Chrome JSON trace (the array-of-events
format Perfetto and chrome://tracing both load):

  * host-loop track: one "X" span per recorded host phase (admission
    bursts, decode chunks, drains) at real wall-clock times;
  * engine-steps track: one span per ring `step` event.  Device steps
    carry no wall clock, so step times are interpolated inside their
    enclosing decode chunk's measured window, and each step span is
    split into schematic alloc -> decode -> retire sub-spans (ordering
    is real, sub-durations are schematic; counts in args are exact);
  * counter tracks ("C" events) for free pages and lanes won over step
    time.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.schema import spec

SNAPSHOT_VERSION = 1

_PID = 1
_TID_HOST = 1
_TID_STEPS = 2

# schematic fractions of a step span (ordering real, widths schematic)
_SUBSPANS = (("alloc", 0.15), ("decode", 0.70), ("retire", 0.15))


def validate_snapshot(snap: Dict) -> None:
    """Structural check + metric-name check against the registry."""
    for key in ("obs_schema", "source", "metrics", "events", "spans"):
        if key not in snap:
            raise ValueError(f"snapshot missing {key!r}")
    if snap["obs_schema"] != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot version {snap['obs_schema']} != {SNAPSHOT_VERSION}"
        )
    for name in snap["metrics"]:
        spec(name)  # raises on unregistered names
    for ev in snap["events"]:
        if "step" not in ev or "kind" not in ev:
            raise ValueError(f"malformed ring event {ev}")
    for sp in snap["spans"]:
        if sp["t1"] < sp["t0"]:
            raise ValueError(f"span ends before it starts: {sp}")


def _meta(name: str, tid: int, what: str) -> Dict:
    return {
        "ph": "M", "name": what, "pid": _PID, "tid": tid,
        "args": {"name": name},
    }


def _span(name, tid, t0_us, dur_us, args=None) -> Dict:
    ev = {
        "ph": "X", "name": name, "pid": _PID, "tid": tid,
        "ts": float(t0_us), "dur": float(max(dur_us, 0.1)),
        "cat": "engine",
    }
    if args:
        ev["args"] = args
    return ev


def _counter(name, t_us, value) -> Dict:
    return {
        "ph": "C", "name": name, "pid": _PID, "ts": float(t_us),
        "args": {name: value}, "cat": "engine",
    }


def _step_clock(spans: List[Dict]):
    """Map a device step index to interpolated wall time (us) using the
    decode chunks' measured [step0, step1] x [t0, t1] windows."""
    windows = [
        s for s in spans
        if s.get("phase") == "decode" and s.get("step1", 0) > s.get("step0", 0)
    ]

    def at(step: float) -> Optional[float]:
        for w in windows:
            if w["step0"] <= step <= w["step1"]:
                f = (step - w["step0"]) / (w["step1"] - w["step0"])
                return 1e6 * (w["t0"] + f * (w["t1"] - w["t0"]))
        return None

    return at


def chrome_trace(snap: Dict) -> Dict:
    """Render a snapshot as a Chrome JSON trace object."""
    validate_snapshot(snap)
    events: List[Dict] = [
        _meta("nbbs-serve", _TID_HOST, "process_name"),
        _meta("host loop", _TID_HOST, "thread_name"),
        _meta("engine steps (device)", _TID_STEPS, "thread_name"),
    ]

    for sp in snap["spans"]:
        t0, t1 = 1e6 * sp["t0"], 1e6 * sp["t1"]
        args = {
            k: v for k, v in sp.items() if k not in ("phase", "t0", "t1")
        }
        events.append(_span(sp["phase"], _TID_HOST, t0, t1 - t0, args))

    clock = _step_clock(snap["spans"])
    step_events = [e for e in snap["events"] if e["kind_name"] == "step"]
    for ev in step_events:
        t0 = clock(ev["step"])
        t1 = clock(ev["step"] + 1)
        if t0 is None or t1 is None:
            continue
        args = {k: v for k, v in ev.items() if k != "kind_name"}
        events.append(
            _span(f"step {ev['step']}", _TID_STEPS, t0, t1 - t0, args)
        )
        # schematic sub-spans: real ordering, exact counts, split widths
        cursor = t0
        detail = {
            "alloc": {"lanes_won": ev.get("lanes_won", 0),
                      "lanes_spilled": ev.get("lanes_spilled", 0),
                      "rounds": ev.get("rounds", 0)},
            "decode": {},
            "retire": {"frees_merged": ev.get("frees_merged", 0),
                       "lanes_overflowed": ev.get("lanes_overflowed", 0)},
        }
        for name, frac in _SUBSPANS:
            dur = frac * (t1 - t0)
            events.append(
                _span(name, _TID_STEPS, cursor, dur, detail[name])
            )
            cursor += dur
        events.append(_counter("free_pages", t0, ev.get("free_pages", 0)))
        events.append(
            _counter("lanes_won", t0, ev.get("lanes_won", 0))
        )

    events.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": snap["source"],
            "obs_schema": snap["obs_schema"],
            "config": snap.get("config", {}),
        },
    }


def validate_trace(trace: Dict) -> None:
    """Sanity-check an exported trace object (the --self-test gate)."""
    if "traceEvents" not in trace:
        raise ValueError("trace missing traceEvents")
    last_ts = None
    for ev in trace["traceEvents"]:
        if ev["ph"] not in ("X", "C", "M", "B", "E", "i"):
            raise ValueError(f"unknown phase {ev['ph']!r}")
        if ev["ph"] == "M":
            continue
        if ev["ts"] < 0:
            raise ValueError("negative timestamp")
        if last_ts is not None and ev["ts"] < last_ts:
            raise ValueError("trace events not time-sorted")
        last_ts = ev["ts"]
        if ev["ph"] == "X" and ev["dur"] <= 0:
            raise ValueError("non-positive span duration")


def save_trace(snap: Dict, path: str) -> str:
    """Snapshot -> Perfetto-loadable .trace (Chrome JSON) file."""
    trace = chrome_trace(snap)
    validate_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
        f.write("\n")
    return path
