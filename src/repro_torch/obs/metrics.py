"""Schema-checked metric dicts, accumulated on the device.

Counterpart of `repro/obs/metrics.py`.  A `Metrics` value is a plain
`dict[str, torch.Tensor]` whose key set is validated against the
registry in `obs/schema.py`.  Accumulation follows each metric's kind:
counters and histograms sum, gauges keep the latest value.

Nothing here synchronises with the host except `to_host`, and nothing
builds a tensor from host data on the device (a blocking copy): the
histogram edges are folded into the ops as Python constants, so
`observe`/`observe_many` run inside a step under
`torch.cuda.set_sync_debug_mode("error")`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

import torch

from repro_torch.obs import schema as _schema
from repro_torch.obs.schema import REGISTRY, MetricSpec, spec  # noqa: F401

Metrics = Dict[str, torch.Tensor]
I32 = torch.int32


def validate(names: Iterable[str]) -> None:
    """Every name must be registered (raises KeyError with guidance)."""
    for name in names:
        spec(name)


def zeros(
    names: Iterable[str],
    vector_lens: Optional[Mapping[str, int]] = None,
    device="cuda",
) -> Metrics:
    """Fresh all-zero metrics: int32 scalars, histogram bucket vectors,
    and `vector_lens`-sized vectors."""
    vector_lens = dict(vector_lens or {})
    out: Metrics = {}
    for name in names:
        s = spec(name)
        if s.kind == "histogram":
            shape = (s.n_slots,)
        elif name in vector_lens:
            shape = (vector_lens[name],)
        else:
            shape = ()
        out[name] = torch.zeros(shape, dtype=I32, device=device)
    return out


def inc(metrics: Metrics, name: str, value) -> Metrics:
    """metrics[name] += value (counters) / = value (gauges)."""
    s = spec(name)
    out = dict(metrics)
    cur = metrics[name]
    value = torch.as_tensor(value, device=cur.device).to(cur.dtype)
    out[name] = value if s.kind == "gauge" else cur + value
    return out


def _bucket(s: MetricSpec, values: torch.Tensor) -> torch.Tensor:
    """searchsorted(edges, values, side='left') over static edges: the
    count of edges strictly below each value."""
    idx = torch.zeros_like(values, dtype=I32)
    for e in s.buckets:
        idx += (values > e).to(I32)
    return idx


def observe(metrics: Metrics, name: str, value, count=1) -> Metrics:
    """Add `count` observations of scalar `value` into a histogram
    (bucket i counts values <= buckets[i]; the last slot overflows)."""
    s = spec(name)
    if s.kind != "histogram":
        raise ValueError(f"{name} is a {s.kind}, not a histogram")
    hist = metrics[name]
    idx = _bucket(s, torch.as_tensor(value, device=hist.device).to(I32))
    slots = torch.arange(s.n_slots, dtype=I32, device=hist.device)
    out = dict(metrics)
    out[name] = hist + (slots == idx).to(I32) * count
    return out


def observe_many(metrics: Metrics, name: str, values, mask) -> Metrics:
    """Histogram a vector of observations (masked lanes dropped)."""
    s = spec(name)
    if s.kind != "histogram":
        raise ValueError(f"{name} is a {s.kind}, not a histogram")
    hist = metrics[name]
    idx = _bucket(s, values.to(I32))
    slots = torch.arange(s.n_slots, dtype=I32, device=hist.device)
    onehot = (idx[:, None] == slots[None, :]) & mask[:, None]
    out = dict(metrics)
    out[name] = hist + onehot.sum(dim=0, dtype=I32)
    return out


def merge(acc: Metrics, new: Metrics) -> Metrics:
    """Accumulate `new` into `acc` by registered kind.  Key sets must
    match."""
    if set(acc) != set(new):
        raise ValueError(f"metric key drift: {sorted(set(acc) ^ set(new))}")
    out: Metrics = {}
    for name, a in acc.items():
        out[name] = new[name] if spec(name).kind == "gauge" else a + new[name]
    return out


def reduce_trajectory(traj: Metrics) -> Metrics:
    """Collapse metrics stacked on a leading [T] axis (a decode chunk's
    trajectory) to totals: counters/histograms sum over T, gauges keep
    the final step's value."""
    out: Metrics = {}
    for name, v in traj.items():
        out[name] = v[-1] if spec(name).kind == "gauge" else v.sum(dim=0, dtype=v.dtype)
    return out


def to_host(metrics: Metrics) -> Dict[str, object]:
    """One copy to the host; scalars -> int, vectors -> list."""
    out: Dict[str, object] = {}
    for name, v in metrics.items():
        v = v.cpu()
        out[name] = int(v) if v.dim() == 0 else [int(x) for x in v.tolist()]
    return out


def host_counters(values: Mapping[str, int], device="cuda") -> Metrics:
    """Lift host-side int counters into a Metrics-shaped dict."""
    validate(values.keys())
    return {
        k: torch.full((), int(v), dtype=I32, device=device)
        for k, v in values.items()
    }


def hist_summary(name: str, counts) -> Dict[str, int]:
    """Label histogram counts with their '<=edge' / 'inf' buckets."""
    s = spec(name)
    labels = [f"<={e}" for e in (s.buckets or ())] + ["inf"]
    return {lab: int(c) for lab, c in zip(labels, counts)}


__all__ = [
    "Metrics", "MetricSpec", "REGISTRY", "spec", "validate", "zeros",
    "inc", "observe", "observe_many", "merge", "reduce_trajectory",
    "to_host", "host_counters", "hist_summary",
]

pack_slots = _schema.pack_slots
unpack_slots = _schema.unpack_slots
