"""Device traces for the per-layer metrics: a `torch.profiler` window
that opens with a lead-in of spin kernels, the device's busy time, the
idle gaps by what the host was doing, and kernel time by name.

A process that has traced before can lose the first device records of a
later trace; LEAD_IN spin kernels (`torch.cuda._sleep(0)`) open every
trace on a card and take that loss, and are left out of its events.
"""

from __future__ import annotations

import contextlib

import torch

LEAD_IN = 4096
HOST = "perfbench:"          # prefix of the host spans the harness records

# kernels whose names say they are matrix products (cuBLAS, CUTLASS, nvjet)
GEMM_KEYS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
PAGED_ATTENTION_KEY = "paged_decode_kernel"
NBBS_KEY = "nbbs_step_kernel"


def on_card(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def host_span(name: str, on: bool):
    """A named host span in the trace, or nothing when not tracing."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(HOST + name)


class Traced:
    """A profiler window (CPU and CUDA).  After it, `device` holds the
    device events without the lead-in, `host` the harness's host spans
    as (name, start_us, end_us), `ranges` the same spans' device ranges
    (from the first kernel launched inside a span to the end of its
    last), and `lost` the lead-in records the trace lost."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.lead = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.device, self.host, self.ranges, self.lost = [], [], [], 0

    def __enter__(self):
        self.prof.__enter__()
        if self.lead:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = list(self.prof.events())
        # the host spans' annotations come back as device ranges too: not work
        dev = sorted((e for e in events if on_card(e) and not e.name.startswith(HOST)),
                     key=lambda e: e.time_range.start)
        lead = 0
        if self.lead:
            while lead < len(dev) and "spin_kernel" in dev[lead].name:
                lead += 1
            self.lost = LEAD_IN - lead
        self.device = dev[lead:]
        spans = [(e.name[len(HOST):], e.time_range.start, e.time_range.end, on_card(e))
                 for e in events if e.name.startswith(HOST)]
        self.host = [(n, a, b) for n, a, b, card in spans if not card]
        self.ranges = [(n, a, b) for n, a, b, card in spans if card]
        return False


def busy_intervals(events) -> list:
    """The union of the events' device intervals, as sorted (start, end) us."""
    out = []
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(events) -> float:
    return sum(b - a for a, b in busy_intervals(events))


def busy_within(events, ranges) -> float:
    """Device busy us inside the given (start, end) ranges."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for lo, hi in ranges for a, b in busy_intervals(events) if a < hi and b > lo)


def idle_by_host(events, host, t0: float, t1: float) -> dict:
    """Device idle us between t0 and t1 (profiler clock), by the innermost
    host span open when each gap began ("other" where none was)."""
    out: dict = {}
    edge = t0
    gaps = []
    for a, b in busy_intervals(events) + [[t1, t1]]:
        if a > edge:
            gaps.append((edge, min(a, t1)))
        edge = max(edge, b)
    for a, b in gaps:
        if b <= a:
            continue
        inner = [(e - s, name) for name, s, e in host if s <= a < e]
        name = min(inner)[1] if inner else "other"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def kernel_us(events) -> dict:
    """Device us by kernel name."""
    out: dict = {}
    for e in events:
        out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return out


def matching_us(by_name: dict, keys) -> float:
    keys = (keys,) if isinstance(keys, str) else keys
    return sum(t for n, t in by_name.items() if any(k in n.lower() for k in keys))


def count(events, key: str) -> int:
    return sum(key in e.name for e in events)
