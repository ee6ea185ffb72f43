"""One run of a cell with the program's span log on (or off), read as the
per-layer metrics that would read it: the admission split per request,
host reads per request, prefill enqueue time, the device's idle share
inside the program's `serve.prefill` ranges, the queue wait, and where
trace A's idle time under admission falls by the innermost `serve.` span.

    python3 perfbench/probe_spans.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--spans 0|1] [--tiny]

from the root of a checkout.  It runs `harness.run` as `run.py` does,
with three things swapped in at run time and no file of the benchmark
changed: the engine is built with `trace=--spans`; the loop keeps the
engine's `host_reads` at each drain; and trace A is `Spans`, which keeps
the program's `serve.` ranges beside the harness's `perfbench:` ones and
out of the device's busy time (a profiler returns a range opened on the
host as a device annotation too).  Prints the run's summary lines on
standard error and one JSON object of readings on standard output.
`--tiny` runs the cell's tiny CPU version (`conftest.tiny_spec`).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the parts of an admission that the split names
PARTS = ("sync.lanes", "claim", "sync.claim", "prefill", "insert")
# the host-read sites of an admission
ADMIT_SITES = ("lanes", "claim", "fastpath", "magazine")
SERVE = "serve."


def admission_split(records: List[Dict], t_lo: float = float("-inf"),
                    t_hi: float = float("inf")) -> Dict[str, float]:
    """Per request admitted in the traced `admit` rounds that began in
    [t_lo, t_hi) (the span log's clock): ms of each of `PARTS`, the rest
    of `admit`, and `requests`.  Empty where no round admitted."""
    by_id = {r["id"]: r for r in records if "id" in r}

    def ms(r):
        return (r["t1"] - r["t0"]) * 1e3

    def round_of(r):
        while r["parent"] is not None:
            r = by_id[r["parent"]]
        return r

    rounds = {r["id"] for r in records
              if r["phase"] == "admit" and "id" in r and t_lo <= r["t0"] < t_hi}
    n = sum(r.get("admitted", 0) for r in records if r.get("id") in rounds)
    if not n:
        return {}
    total = dict.fromkeys(PARTS, 0.0)
    for r in records:
        if r["phase"] in total and r.get("parent") is not None and round_of(r)["id"] in rounds:
            total[r["phase"]] += ms(r)
    admit = sum(ms(r) for r in records if r.get("id") in rounds)
    out = {k: v / n for k, v in total.items()}
    out["rest"] = (admit - sum(total.values())) / n
    out["requests"] = n
    return out


class _Done:
    """A finished profiler's stand-in: the events kept, nothing to close."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def __exit__(self, *exc):
        return False


@contextlib.contextmanager
def probed(spans: bool):
    """While open, `harness.run` builds its engine with `trace=spans`; the
    dict yielded gains `engine`, `window`, `reads` (the engine's
    `host_reads` and the claims attempted, at each drain's time) and
    `traces` (each profiler window: trace A first)."""
    from perfbench import harness, tracing
    from repro_torch.serve import jit_engine as je

    got = {"engine": None, "window": None, "reads": {}, "traces": []}

    class Engine(je.JitServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, trace=spans, **kw)
            got["engine"] = self

    class Loop(harness.Loop):
        def drain(self):
            t = super().drain()
            st = self.eng.stats
            got["reads"][t] = collections.Counter(
                self.eng.host_reads, attempts=st["admitted"] + st["queued_full"])
            return t

    class Spans(tracing.Traced):
        """Also keeps the program's `serve.` host ranges as `serve` (name
        without the prefix, start us, end us), and leaves their device
        annotations out of `device`."""

        def __exit__(self, *exc):
            if exc[0] is not None:
                return super().__exit__(*exc)
            self.prof.__exit__(*exc)
            events = list(self.prof.events())
            self.serve = [(e.name[len(SERVE):], e.time_range.start, e.time_range.end)
                          for e in events if e.name.startswith(SERVE)
                          and not tracing.on_card(e)]
            self.prof = _Done([e for e in events if not e.name.startswith(SERVE)])
            super().__exit__(*exc)
            got["traces"].append(self)
            return False

    def measure(loop, *a, **kw):
        got["window"] = measured(loop, *a, **kw)
        return got["window"]

    measured = harness.measure
    swaps = [(je, "JitServeEngine", Engine), (harness, "Loop", Loop),
             (tracing, "Traced", Spans), (harness, "measure", measure)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, new in swaps:
            setattr(mod, name, new)
        yield got
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def window_reads(got) -> collections.Counter:
    """The host reads (and claims attempted) from the window's first
    drain to its last."""
    w = got["window"]
    return got["reads"][w.end] - got["reads"][w.start]


def readings(out: dict, got: dict) -> dict:
    """What the span log, the host reads and trace A say of the run."""
    from perfbench import tracing
    from perfbench.stats import percentile

    eng, w = got["engine"], got["window"]
    lo, hi = w.start - eng._t_origin, w.end - eng._t_origin
    reads = window_reads(got)
    n = len(w.admitted())
    res = {"correct": out["correct"], "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "admitted": n, "window_s": w.seconds, "reads": dict(reads),
           "admit_ms_per_request": w.admit_s * 1e3 / n if n else None,
           "admit_reads_per_request": sum(reads[k] for k in ADMIT_SITES) / n if n else None,
           "records": len(eng.spans)}
    split = admission_split(eng.spans, lo, hi)
    if split:
        res["split_ms_per_request"] = split
        res["split_share_of_admit"] = sum(split[k] for k in PARTS) / res["admit_ms_per_request"]
        res["admit_sync_ms_per_request"] = split["sync.lanes"] + split["sync.claim"]
        pre = [r for r in eng.spans if r["phase"] == "prefill" and lo <= r["t0"] < hi]
        res["prefills"] = len(pre)
        res["prefill_enqueue_ms_per_request"] = (
            sum(r["t1"] - r["t0"] for r in pre) * 1e3 / len(pre) if pre else None)
        dev = [r["device_ms"] for r in pre if "device_ms" in r]
        res["prefill_device_ms_mean"] = sum(dev) / len(dev) if dev else None
        rep = [r["device_ms"] for r in eng.spans if r["phase"] == "replay"
               and "device_ms" in r and lo <= r["t0"] < hi]
        res["replay_device_ms_mean"] = sum(rep) / len(rep) if rep else None
        kids = collections.Counter(r["parent"] for r in eng.spans
                                   if r["phase"].startswith("prefill."))
        res["spans_per_prefill"] = 1 + sum(kids[r["id"]] for r in pre) / len(pre) if pre else None
        res["records_per_admitted"] = sum(lo <= r["t0"] < hi for r in eng.spans) / n
        begun = {r["id"] for r in eng.spans if r["phase"] == "request" and lo <= r["t0"] < hi}
        waits = [(r["t1"] - r["t0"]) * 1e3 for r in eng.spans
                 if r["phase"] == "queued" and r["parent"] in begun]
        res["queue_wait_n"] = len(waits)
        if waits:
            res["queue_wait_ms_p50"] = percentile(waits, 50)
            res["queue_wait_ms_p95"] = percentile(waits, 95)
    if got["traces"] and got["traces"][0].serve:
        tr = got["traces"][0]
        ours = [(a, b) for nm, a, b in tr.serve if nm == "prefill"]
        theirs = [(a, b) for nm, a, b in tr.host if nm == "serve_prefill"]
        res["trace_prefill_ranges"] = [len(ours), len(theirs)]
        res["one_clock_nested"] = sum(sum(a <= c <= d <= b for c, d in theirs) == 1
                                      for a, b in ours)
        if ours and tr.device:
            host_us = sum(b - a for a, b in ours)
            res["prefill_idle_share"] = 100.0 * (1 - tracing.busy_within(tr.device, ours)
                                                 / host_us)
        win = [(a, b) for nm, a, b in tr.host if nm == "window"]
        admits = [(a, b) for nm, a, b in tr.host if nm == "admit"]
        if win and tr.device:
            by = admission_idle(tr.device, tr.serve, admits, *win[0])
            under = sum(by.values())
            res["admit_idle_s"] = under / 1e6
            res["admit_idle_by_span_s"] = {k: v / 1e6 for k, v in by.most_common()}
            res["admit_idle_named_share"] = 100.0 * (1 - by["other"] / under) if under else None
            pre_idle = sum(v for k, v in by.items() if k.startswith("prefill"))
            if pre_idle:
                res["prefill_idle_by_layer"] = {k: 100.0 * by[k] / pre_idle for k in
                                                ("prefill.attention", "prefill.ffn", "prefill")}
    return res


def admission_idle(device, serve, admits, t_lo: float, t_hi: float) -> collections.Counter:
    """Device idle us between t_lo and t_hi that began inside one of the
    harness's `admit` spans, by the innermost `serve.` range open then
    ("other" where none was)."""
    from perfbench import tracing

    gaps, edge = [], t_lo
    for a, b in tracing.busy_intervals(device) + [[t_hi, t_hi]]:
        if a > edge:
            gaps.append((edge, min(a, t_hi)))
        edge = max(edge, b)
    by = collections.Counter()
    for a, b in gaps:
        if b <= a or not any(s <= a < e for s, e in admits):
            continue
        inner = [(e - s, nm) for nm, s, e in serve if s <= a < e]
        by[min(inner)[1] if inner else "other"] += b - a
    return by


def probe(spec: dict, seed: int, seconds: float, trace: bool, spans: bool, device,
          t_process: float):
    """One `harness.run` of `spec` with the engine's span log on or off:
    (the readings, the run's summary lines, what `probed` kept)."""
    from perfbench import harness

    with probed(spans) as got:
        out, lines = harness.run(spec, seed, seconds, trace, device, t_process)
    return readings(out, got), lines, got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tiny", action="store_true", help="the cell's tiny CPU version")
    args = ap.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness

    if args.tiny:
        from perfbench.conftest import tiny_spec

        spec, device = tiny_spec(args.workload), torch.device("cpu")
        torch.set_num_threads(2)
    else:
        spec, device = harness.cell_spec(args.workload, ROOT), torch.device("cuda", 0)
        torch.set_num_threads(1)
    res, lines, _ = probe(spec, args.seed, args.seconds, bool(args.trace), bool(args.spans),
                          device, T_PROCESS)
    for line in lines:
        print(line, file=sys.stderr)
    res = dict(workload=args.workload, seed=args.seed, spans=args.spans,
               card=torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu", **res)
    sys.stderr.flush()
    print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
