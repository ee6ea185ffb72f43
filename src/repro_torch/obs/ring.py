"""Device event ring: a fixed-capacity log of allocator events.

Counterpart of `repro/obs/ring.py`, with the same names.  Counters say
how much; the ring says when and where.  It is a circular int32 buffer
in the engine's `EngineState`, written by the decode step with no host
synchronisation, and drained on the host at chunk boundaries.

  * fixed capacity `cap`; `cap == 0` keeps only the count of pushes;
  * drop-oldest: pushes land at `count % cap`, so when producers outrun
    drains the oldest events are overwritten; `dropped(ring)` is
    max(count - cap, 0), and `drain` returns the surviving window oldest
    to newest;
  * masked pushes: of a batch of candidate rows only the masked-in ones
    are written, each to its own slot (exclusive cumsum over the mask).

JAX drops a masked-out row by scattering it to row `cap` with
`mode="drop"`.  Here the buffer has one sink row past the capacity, row
`cap`, that takes those writes and that `drain` never reads (the KV
pool's sink page is the same device).  `buf` is `int32[cap + 1, W]`.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

I32 = torch.int32

# One row per event.  `kind` discriminates; unused fields stay 0.
EVENT_FIELDS: Tuple[str, ...] = (
    "step",        # engine/global step index
    "kind",        # EV_* discriminator
    "lanes_won",   # allocations committed this event
    "lanes_overflowed",  # lanes whose allocation failed (pool full)
    "lanes_spilled",     # fast-octave lanes that took the buddy climb
    "frees_merged",      # handles released by the merged burst
    "rounds",      # arbitration rounds the wavefront took
    "free_pages",  # pool-wide free units after the event
)

EV_STEP = 1     # one engine decode step (alloc + decode + retire)
EV_ADMIT = 2    # host-boundary admission burst
EV_RETIRE = 3   # retirement burst detail

KIND_NAMES = {EV_STEP: "step", EV_ADMIT: "admit", EV_RETIRE: "retire"}


class EventRing(NamedTuple):
    """Device-resident ring state."""

    buf: torch.Tensor    # int32[cap + 1, len(EVENT_FIELDS)], row cap a sink
    count: torch.Tensor  # int32 scalar: events ever pushed


def make_ring(capacity: int, device="cuda") -> EventRing:
    return EventRing(
        buf=torch.zeros((capacity + 1, len(EVENT_FIELDS)), dtype=I32, device=device),
        count=torch.zeros((), dtype=I32, device=device),
    )


def capacity(ring: EventRing) -> int:
    return int(ring.buf.shape[0]) - 1


def event(kind: int, **fields) -> torch.Tensor:
    """Build one int32 event row by field name (unset fields 0), on the
    device of the tensor fields (the CPU if there is none)."""
    unknown = set(fields) - set(EVENT_FIELDS)
    if unknown:
        raise KeyError(f"unknown event fields {sorted(unknown)}")
    dev = next((v.device for v in fields.values() if isinstance(v, torch.Tensor)),
               torch.device("cpu"))
    fields = {**fields, "kind": kind}

    def value(v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(I32).reshape(())
        # a fill on the device, not a host-to-device copy
        return torch.full((), int(v), dtype=I32, device=dev)

    return torch.stack([value(fields.get(f, 0)) for f in EVENT_FIELDS])


def _mask(mask, like: torch.Tensor) -> torch.Tensor:
    if isinstance(mask, torch.Tensor):
        return mask.to(torch.bool)
    return torch.full((), bool(mask), dtype=torch.bool, device=like.device)


def push(ring: EventRing, row: torch.Tensor, mask=True) -> EventRing:
    """Append one event row when `mask` (a device bool) is set: it lands
    at `count % cap`, a masked-out row in the sink row, so the step has
    no data-dependent control flow."""
    cap = capacity(ring)
    mask = _mask(mask, ring.count)
    count = ring.count + mask.to(I32)
    if cap == 0:  # telemetry off: keep only the total count
        return EventRing(ring.buf, count)
    pos = torch.where(mask, ring.count % cap, cap).long()
    buf = ring.buf.index_put((pos.reshape(1),), row.to(I32).reshape(1, -1))
    return EventRing(buf, count)


def push_many(ring: EventRing, rows: torch.Tensor, mask: torch.Tensor) -> EventRing:
    """Append the masked-in rows of an [N, W] candidate batch, in row
    order, each to its own slot (exclusive-cumsum positions)."""
    cap = capacity(ring)
    mask = mask.to(torch.bool)
    count = ring.count + mask.sum(dtype=I32)
    if cap == 0:
        return EventRing(ring.buf, count)
    rank = torch.cumsum(mask.to(I32), 0) - 1  # 0-based among accepted
    pos = torch.where(mask, (ring.count + rank) % cap, cap).long()
    buf = ring.buf.index_put((pos,), rows.to(I32))
    return EventRing(buf, count)


def dropped(ring: EventRing) -> torch.Tensor:
    """Events overwritten before any drain could see them."""
    return torch.clamp(ring.count - capacity(ring), min=0)


def drain(ring: EventRing) -> List[Dict[str, int]]:
    """Host side: the surviving window as dicts, oldest to newest.  The
    one deliberate sync of the ring: call it at chunk boundaries, never
    inside a decode chunk."""
    cap = capacity(ring)
    buf, count = ring.buf[:cap].cpu().numpy(), int(ring.count)
    n = min(count, cap)
    if n == 0:
        return []
    start = count % cap if count > cap else 0
    return [decode_row(buf[(start + i) % cap]) for i in range(n)]


def decode_row(row) -> Dict[str, int]:
    rec = {f: int(v) for f, v in zip(EVENT_FIELDS, row)}
    rec["kind_name"] = KIND_NAMES.get(rec["kind"], f"kind{rec['kind']}")
    return rec
