"""One run of one cell: weights and traffic from the seed, warm-up, the
measured window, the traced windows (with `trace`), then the comparison
with the plain reference that decides `correct`.

The system under test is `repro_torch.serve.jit_engine.JitServeEngine`
with its default allocator path (one shard, unpacked tree, no fastpath,
no magazines, no event ring), bf16, greedy.  The harness drives its
loop as `run_to_completion` does, one iteration at a time:

    drain (`_drain`: one host sync; retired requests come back)
    submit (top the backlog up, or every request now due)
    admit (`_admit`: kernel A's claim, then a B=1 prefill per request)
    decode (`decode_steps(chunk, fused=True)`: one CUDA graph replay)

Every time the metrics use is the host clock right after a drain, which
waits for the device: a request's first token is out at the drain after
the chunk that followed its admission, and it is done at the drain that
returns it.  The window opens and closes at drains.

Everything a cell needs comes from files found by its name:
`BENCHMARK.json` (its configuration and traffic names, and which metrics
it reports), `workloads/<cell>.json` (engine geometry, loop, rate, limits),
`configs/<config>.json`, `traffic/<traffic>.json` and one reader per
metric in `metrics/`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import costs, generator, tracing
from perfbench.reference import compare, pages
from perfbench.weights import make_params, param_bytes

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """Everything one cell needs, by its name in `BENCHMARK.json`."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        "name": name,
        "entry": entry,
        "bench": bench,
        "cell": load_json(HERE / "workloads" / f"{name}.json"),
        "config": load_json(root / conf["file"]),
        "traffic": generator.load(entry["traffic"]),
    }


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The metrics a run of cell `name` prints: its end-to-end metrics, or
    with `trace` its per-layer metrics (those listing it, or those with
    no list whose `moves` metric it reports)."""
    def applies(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def reader(metric: str):
    """`read(run)` of `metrics/<metric>.py`, or of the file named by the
    part before the first dot (one quantity reported under several names)."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"perfbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {metric!r} in perfbench/metrics/")


@dataclasses.dataclass
class Req:
    idx: int
    prompt_len: int
    max_new: int
    due: Optional[float]            # host clock; None in a backlog
    submitted: float
    admit_iter: Optional[int] = None
    first_t: Optional[float] = None
    done_t: Optional[float] = None
    served: Optional[int] = None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Pair:
    """A device interval: CUDA events on a card, the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Loop:
    """The engine's host loop, an iteration at a time, with the times the
    metrics need."""

    def __init__(self, eng, stream, chunk: int, device):
        from repro_torch.serve.engine import Request

        self.Request = Request
        self.eng, self.stream, self.chunk, self.device = eng, stream, chunk, device
        self.lanes = eng.max_batch
        self.reqs: Dict[int, Req] = {}
        self.fresh: List[int] = []
        self.iters = 0
        self.spans = False                  # host spans into a trace
        self.chunk_marks = None             # list of event pairs while recording
        self.pair = Pair(device)
        self.admit_s = 0.0                  # host seconds in `_admit`
        self.live_pages = None              # mapped pages at each drain while sampling
        self.origin = time.perf_counter()
        self.last_t = self.origin          # host time of the last drain
        self.nxt = stream.next()

    def drain(self) -> float:
        with tracing.host_span("drain", self.spans):
            done = self.eng._drain()
            t = self.last_t = time.perf_counter()
        for sid in done:
            r = self.reqs[sid]
            r.done_t, r.served = t, len(self.eng.completed[sid].out_tokens)
        for sid in self.fresh:
            self.reqs[sid].first_t = t
        self.fresh = []
        if self.live_pages is not None:
            self.live_pages.append(int((self.eng.state.page_shard >= 0).sum()))
        return t

    def _push(self, now: float) -> None:
        idx, prompt, new, due = self.nxt
        self.eng.submit(self.Request(idx, prompt, new))
        backlog = self.stream.kind == "backlog"
        self.reqs[idx] = Req(idx, len(prompt), new, None if backlog else self.origin + due, now)
        self.nxt = self.stream.next()

    def next_due(self) -> float:
        return self.origin + self.nxt[3]

    def advance(self, cap: Optional[int] = None) -> None:
        """One iteration after a drain; `cap` bounds the requests submitted
        so far (the ramp's staggered start)."""
        now = time.perf_counter()
        if self.stream.kind == "backlog":
            while len(self.eng.waiting) < self.lanes and (cap is None or self.nxt[0] < cap):
                self._push(now)
        else:
            while self.next_due() <= now:
                self._push(now)
        eng = self.eng
        if not eng.running and not eng.waiting:
            with tracing.host_span("wait", self.spans):
                time.sleep(max(0.0, self.next_due() - now))
            return
        before = set(eng.running)
        with tracing.host_span("admit", self.spans):
            t0 = time.perf_counter()
            eng._admit()
            self.admit_s += time.perf_counter() - t0
        self.fresh = [sid for sid in eng.running if sid not in before]
        for sid in self.fresh:
            self.reqs[sid].admit_iter = self.iters
        if eng.running:
            with tracing.host_span("decode", self.spans):
                a = self.pair.mark() if self.chunk_marks is not None else None
                eng.decode_steps(self.chunk, fused=True)
                if a is not None:
                    self.chunk_marks.append((a, self.pair.mark()))
        self.iters += 1

    def tokens_now(self) -> Dict[int, int]:
        """Tokens served so far by each running request (after a drain)."""
        n_out = self.eng.state.n_out.cpu().numpy()
        return {sid: int(n_out[lane]) for sid, lane in self.eng._lane_of.items()}


@dataclasses.dataclass
class Window:
    start: float
    end: float
    seconds: float
    reqs: List[Req]
    before: Dict[int, int]
    after: Dict[int, int]
    iters: tuple
    admit_s: float
    grace_end: float
    stats0: dict
    stats1: dict
    queue: tuple                    # requests waiting at the window's start and end
    chunk_ms: List[float] = dataclasses.field(default_factory=list)
    live_pages: List[int] = dataclasses.field(default_factory=list)
    chunk: int = 8

    def finished(self) -> List[Req]:
        return [r for r in self.reqs if r.done_t is not None and self.start < r.done_t <= self.end]

    def token_spans(self):
        """(request, first, last): the tokens each request was served
        inside the window, as output indices first..last-1."""
        out = []
        for r in self.reqs:
            b = self.before.get(r.idx, 0)
            if r.idx in self.after:
                out.append((r, b, self.after[r.idx]))
            elif r.done_t is not None and self.start < r.done_t <= self.end:
                out.append((r, b, r.served))
        return out

    def admitted(self) -> List[Req]:
        lo, hi = self.iters
        return [r for r in self.reqs if r.admit_iter is not None and lo <= r.admit_iter < hi]

    def due(self) -> List[Req]:
        return [r for r in self.reqs if r.due is not None and self.start <= r.due < self.end]

    def tpot_ms(self) -> List[float]:
        """Per request retired in the window: ms per token after the first."""
        return [(r.done_t - r.first_t) / (r.served - 1) * 1e3 for r in self.finished()
                if r.first_t is not None and r.served > 1]

    def ttft_ms(self) -> List[float]:
        """Per request due in the window: ms from due to its first token, or
        to the end of the wait after the window where it has none."""
        return [((r.first_t if r.first_t is not None else self.grace_end) - r.due) * 1e3
                for r in self.due()]


@contextlib.contextmanager
def wrapped(module, names, wrap):
    """Replace `module.<name>` by `wrap(name, fn)` for each name, and back."""
    saved = {n: getattr(module, n) for n in names}
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def measure(loop: Loop, seconds: float, grace_s: float, record: bool) -> Window:
    """The measured window, from one drain to the first drain `seconds`
    later, with the pages mapped at each of its drains; with `record`,
    CUDA events around every chunk.  An open loop then runs on until
    every request due in the window has its first token, for at most
    `grace_s`."""
    eng = loop.eng
    if record:
        loop.chunk_marks = []
    loop.live_pages = []
    start = loop.drain()
    before, stats0, it0, admit0 = loop.tokens_now(), dict(eng.stats), loop.iters, loop.admit_s
    q0 = len(eng.waiting)
    loop.advance()
    while True:
        t = loop.drain()
        if t >= start + seconds:
            break
        loop.advance()
    end = t
    live, loop.live_pages = loop.live_pages, None
    after, stats1, it1, q1 = loop.tokens_now(), dict(eng.stats), loop.iters, len(eng.waiting)
    admit_s = loop.admit_s - admit0
    marks, loop.chunk_marks = loop.chunk_marks, None
    grace_end = end
    if loop.stream.kind != "backlog":
        def waiting():
            return loop.next_due() < end or any(
                r.first_t is None for r in loop.reqs.values()
                if r.due is not None and start <= r.due < end)
        while waiting() and grace_end < end + grace_s:
            loop.advance()
            grace_end = loop.drain()
    w = Window(start, end, end - start, list(loop.reqs.values()), before,
               after, (it0, it1), admit_s, grace_end, stats0, stats1, (q0, q1),
               live_pages=live, chunk=loop.chunk)
    if record:
        _sync(loop.device)
        w.chunk_ms = [loop.pair.ms(a, b) for a, b in marks]
    return w


def trace_loop(loop: Loop, seconds: float) -> dict:
    """Trace A: the loop itself, with admissions, for `seconds`: the
    device's busy time, the idle gaps by host phase, kernels by time,
    and the prompts prefilled with the device time of their kernels (the
    busy time inside the device ranges of the `serve_prefill` spans)."""
    from repro_torch.serve import jit_engine as je

    def spanned(name, fn):
        def run(*a, **kw):
            with torch.profiler.record_function(tracing.HOST + name):
                return fn(*a, **kw)
        return run

    paused = loop.last_t
    loop.drain()
    it0 = loop.iters
    with wrapped(je, ["admit_pages", "serve_prefill", "prefill_insert"], spanned):
        with tracing.Traced() as tr:
            # an open loop's arrivals stand still from its last drain to here
            # (the checks after the window, the trace's lead-in), so that the
            # trace sees the cell's load and not a burst of what fell due
            loop.origin += time.perf_counter() - paused
            loop.spans = True
            with torch.profiler.record_function(tracing.HOST + "window"):
                t0 = time.perf_counter()
                while time.perf_counter() < t0 + seconds:
                    loop.advance()
                    loop.drain()
                _sync(loop.device)
                wall = time.perf_counter() - t0
            loop.spans = False
    win = [(s, e) for n, s, e in tr.host if n == "window"]
    t_lo, t_hi = win[0] if win else (0.0, 0.0)
    busy = tracing.busy_us(tr.device) / 1e6
    prefills = [(s, e) for n, s, e in tr.ranges if n == "serve_prefill"]
    prompts = [r.prompt_len for r in loop.reqs.values()     # B=1 prefill for each above 1
               if r.admit_iter is not None and it0 <= r.admit_iter < loop.iters
               and r.prompt_len > 1]
    return {"busy_s": busy, "window_s": wall, "kernels_us": tracing.kernel_us(tr.device),
            "idle_us": tracing.idle_by_host(tr.device, tr.host, t_lo, t_hi),
            "lost": tr.lost, "events": len(tr.device), "prefill_prompts": prompts,
            "prefill_ranges": len(prefills),
            "prefill_busy_us": tracing.busy_within(tr.device, prefills),
            "prefill_host_us": sum(e - s for n, s, e in tr.host if n == "serve_prefill")}


def trace_decode(loop: Loop, chunks: int = 2) -> dict:
    """Trace B: `chunks` graph replays back to back (no admission between
    them), with the lanes they start from, for the per-step kernels."""
    eng, st = loop.eng, loop.eng.state
    loop.drain()
    lanes = list(zip(*(t.cpu().tolist() for t in (st.ctx, st.n_out, st.max_new, st.active))))
    with tracing.Traced() as tr:
        for _ in range(chunks):
            eng.decode_steps(loop.chunk, fused=True)
        _sync(loop.device)
    return {"steps": chunks * loop.chunk, "lanes": lanes,
            "kernels_us": tracing.kernel_us(tr.device), "lost": tr.lost,
            "paged_attention_launches": tracing.count(tr.device, tracing.PAGED_ATTENTION_KEY)}


def judge(values: dict, limits: dict, compared: int):
    """(checks, readings, correct): each number the cell sets a limit on
    beside its limit, the numbers without one, and whether every checked
    number is within its limit over a sample that compared some token."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items() if k in limits}
    info = {k: v for k, v in values.items() if k not in limits}
    return checks, info, all(c["value"] <= c["limit"] for c in checks.values()) and compared > 0


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""

    arch: dict
    cell: dict
    setup_s: float
    window: Window
    trace: Optional[dict]


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t_process: float,
        control: bool = False):
    """One run; returns (the result line's object, stderr summary lines)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serve.jit_engine import JitServeEngine
    from repro_torch.serve.paged_decode import serve_prefill

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    cell, arch, traffic = spec["cell"], spec["config"]["arch"], spec["traffic"]
    geo = cell["engine"]
    cfg = ArchConfig(**arch)
    dtype = getattr(torch, spec["config"]["dtype"])
    lines = []
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    params = make_params(arch, seed, device, dtype)
    eng = JitServeEngine(cfg, params, dtype=dtype, device=device, n_shards=1,
                         layout="unpacked", ring_capacity=0, **geo)
    stream = generator.Stream(traffic, seed, arch["vocab_size"], cell.get("rate_per_s"))
    cap = geo["max_lane_pages"] * geo["page_tokens"]
    if stream.longest() > cap or max(stream.outputs) > geo["max_out"]:
        raise SystemExit(f"traffic reaches {stream.longest()} tokens a lane, over {cap}")
    for n in stream.buckets():   # every prefill length the traffic reaches
        serve_prefill(cfg, params, {"tokens": torch.zeros((1, n), dtype=torch.int64,
                                                          device=device)},
                      max_len=n, dtype=dtype)
    # one chunk over the empty lanes builds kernels A and B (first run in a
    # checkout) and captures the chunk's graph before any request is due
    eng.decode_steps(cell["chunk"], fused=True)
    _sync(device)
    loop = Loop(eng, stream, cell["chunk"], device)
    if stream.kind == "backlog":
        # a staggered start: lanes / ramp_chunks more requests each chunk, so
        # the lanes' ages are spread as in steady state once they are full
        ramp = cell["ramp_chunks"]
        for i in range(ramp):
            loop.drain()
            loop.advance(cap=-(-eng.max_batch * (i + 1) // ramp))
    else:
        while time.perf_counter() < loop.origin + cell["warm_s"]:
            loop.drain()
            loop.advance()
    # what set-up made is never garbage: the window's collections skip it
    gc.collect()
    gc.freeze()
    try:
        w = measure(loop, seconds, cell.get("grace_s", 0.0), record=trace)
    finally:
        gc.unfreeze()
    setup_s = w.start - t_process

    st = eng.state
    shard, off = st.page_shard.cpu().numpy(), st.page_off.cpu().numpy()
    pool = pages.page_checks(
        st.trees[0].cpu().numpy(), np.where(shard >= 0, shard * geo["num_pages"] + off, -1),
        st.ctx.cpu().numpy(), st.active.cpu().numpy(), geo["page_tokens"], geo["num_pages"])
    traced = None
    if trace:
        traced = {"loop": trace_loop(loop, cell["trace_s"]), "decode": trace_decode(loop)}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    done = w.finished()
    finished = [{"prompt": eng.completed[r.idx].prompt,
                 "served": eng.completed[r.idx].out_tokens,
                 "max_new": r.max_new} for r in done]
    sample = compare.pick(finished, cell["check"]["sample"], seed)
    failed = sum(w.stats1[k] - w.stats0[k] for k in ("rejected", "overflow_retired"))
    if stream.kind == "backlog":
        attempted = len(w.admitted())
    else:
        due = w.due()
        attempted = len(due)
        failed += sum(r.first_t is None for r in due)
    del loop, eng, st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    gap, ctrl = compare.served_gap(arch, params, sample, device, control=control)
    ref_s = time.perf_counter() - t_ref
    compared = gap.pop("compared")
    limits = cell["check"]["limits"]
    values = dict(pool, **gap)
    values["served_short"] = sum(len(r["served"]) != r["max_new"] for r in finished)
    values["sample_short"] = cell["check"]["sample"] - len(sample)
    # every number is printed; those the cell sets a limit on decide `correct`
    checks, info, correct = judge(values, limits, compared)

    data = RunData(arch, cell, setup_s, w, traced)
    page_bytes = costs.kv_page_bytes(arch, geo["page_tokens"], torch.finfo(dtype).bits // 8)
    live = w.live_pages or [0]
    kv = {"live_bytes_mean": page_bytes * sum(live) / len(live),
          "live_bytes_peak": page_bytes * max(live),
          "pool_bytes": page_bytes * geo["num_pages"],
          "card_bytes": (torch.cuda.get_device_properties(device).total_memory
                         if device.type == "cuda" else 0)}
    metrics = {}
    for m in cell_metrics(spec["bench"], spec["name"], trace):
        v = reader(m["name"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": spec["entry"].get("chips", 1), "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if traced:
        lp = traced["loop"]
        dev["busy_s"], dev["window_s"] = lp["busy_s"], lp["window_s"]
        top = sorted(lp["kernels_us"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(lp["idle_us"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n[:160], t / 1e6] for n, t in top],
                            "idle_gaps": [[n, t / 1e6] for n, t in gaps]}
    out["kv_cache"] = kv
    if control:
        # the control in the program's place: its served-token numbers,
        # held to the cell's own limits on them
        c_checks, c_info, c_correct = judge(ctrl or {}, limits, compared)
        out["control"] = {"correct": bool(c_correct), "checks": c_checks, "readings": c_info}
    out["readings"] = info

    lines += summary(w, data, params, peak, sample, compared, ref_s, traced)
    lines.append(f"kv cache: live pages hold {kv['live_bytes_mean'] / 1e9:.2f} GB on average, "
                 f"{kv['live_bytes_peak'] / 1e9:.2f} GB at most, of a {kv['pool_bytes'] / 1e9:.2f} "
                 f"GB pool and a {kv['card_bytes'] / 1e9:.2f} GB card")
    lines += [f"reading {k}: {v} (no limit)" for k, v in info.items()]
    lines += [f"check {k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()]
    out["checks"] = checks
    return out, lines


def summary(w: Window, data: RunData, params, peak, sample, compared, ref_s, traced) -> list:
    """Median, counts and the generator's lateness, for the log."""
    from perfbench.stats import percentile

    fin = w.finished()
    lines = [f"window {w.seconds:.3f} s, iterations {w.iters[1] - w.iters[0]}, "
             f"admitted {len(w.admitted())}, finished {len(fin)}, queue {w.queue[0]}->{w.queue[1]}, "
             f"tokens {sum(b - a for _, a, b in w.token_spans())}, setup {data.setup_s:.3f} s, "
             f"weights {param_bytes(params) / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB"]
    tp = w.tpot_ms()
    if tp:
        lines.append(f"tpot ms: median {percentile(tp, 50):.3f} p95 {percentile(tp, 95):.3f} "
                     f"n {len(tp)}")
    due = w.due()
    if due:
        late = [r.submitted - r.due for r in due]
        tt = w.ttft_ms()
        lines.append(f"ttft ms: median {percentile(tt, 50):.3f} p95 {percentile(tt, 95):.3f} "
                     f"n {len(tt)}; generator late ms: median {percentile(late, 50) * 1e3:.3f} "
                     f"max {max(late) * 1e3:.3f}; without first token {sum(r.first_t is None for r in due)}")
    lines.append(f"reference: {len(sample)} requests, {compared} served tokens, {ref_s:.2f} s")
    if traced:
        lines.append(f"trace: loop {traced['loop']['events']} device events, lead-in lost "
                     f"{traced['loop']['lost']}; decode lead-in lost {traced['decode']['lost']}, "
                     f"paged attention launches {traced['decode']['paged_attention_launches']}")
        lp = traced["loop"]
        lines.append(f"trace prefills: {len(lp['prefill_prompts'])} prompts, "
                     f"{lp['prefill_ranges']} device ranges; ms: host spans "
                     f"{lp['prefill_host_us'] / 1e3:.3f}, device busy inside the ranges "
                     f"{lp['prefill_busy_us'] / 1e3:.3f}; window busy "
                     f"{lp['busy_s'] * 1e3:.3f} of {lp['window_s'] * 1e3:.3f}")
    return lines


def forbidden_modules(mods) -> list:
    """Loaded modules whose top-level name is one the run may not hold."""
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))
