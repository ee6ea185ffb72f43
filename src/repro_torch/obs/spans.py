"""The serving engine's span log: its host phases on one clock, and with
`trace` the spans inside them.

Untraced (the default), the log holds the engine's phase records as the
JAX engine logs them: one `{"phase", "t0", "t1", "step0", "step1", ...}`
record per admission round that admitted, per decode chunk and per drain
that drained, in seconds since the engine was made.

Traced, every phase is logged and nests spans of its own (`admit` ->
`sync.lanes`, `request` -> `queued`, `claim`, `sync.claim`, `prefill`
-> `prefill.attention` / `prefill.ffn`, `insert`; `decode` -> `replay`,
`capture`, `step`; `drain` -> `sync.drain`).  Each record gains `id` and
`parent` (the id of the span open around it, or None); the spans of one
request carry its id as `req`.  Each span opens
`torch.profiler.record_function("serve.<phase>")`, so that a profiler
puts it on the timeline of the device's kernels.  A span opened with
`device=True` on a card also brings a CUDA event pair, resolved into
`device_ms` by `resolve()` once the device has passed its end.

A record is appended when its span closes, so children precede their
parent.  `queued` is the one child outside its parent: it runs from the
request's submission to the start of its `request` span.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

# what an untraced span opens: one shared context that does nothing
_NULL = contextlib.nullcontext()

# the log whose `prefill` span is open, for the model's per-layer spans
_PREFILL: contextvars.ContextVar[Optional["SpanLog"]] = contextvars.ContextVar(
    "serve_prefill_log", default=None)


class Phase:
    """A top-level phase being recorded: the fields its record gains, and
    whether an untraced log keeps it."""

    __slots__ = ("fields", "kept")

    def __init__(self):
        self.fields: Dict = {}
        self.kept = False

    def keep(self, **fields) -> None:
        self.fields.update(fields)
        self.kept = True


class SpanLog:
    """Phase records, and with `trace` nested spans, on the host clock
    (seconds since `origin`, a `time.perf_counter()` reading).  `steps`
    reads the engine's step counter for a phase's `step0` / `step1`;
    `cuda` says whether device spans take CUDA events."""

    def __init__(self, steps: Callable[[], int], *, trace: bool = False, cuda: bool = False):
        self.records: List[Dict] = []
        self.trace = trace
        self.origin = time.perf_counter()
        self._steps = steps
        self._cuda = cuda and trace
        self._ids = itertools.count()
        self._open: List[Dict] = []         # records of the spans open now
        self._pending: List[tuple] = []     # (record, start event, end event)
        self._submitted: Dict[int, float] = {}

    def now(self) -> float:
        return time.perf_counter() - self.origin

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[Phase]:
        """A top-level phase (`admit`, `decode`, `drain`): logged as
        `{phase, t0, t1, step0, step1, **fields}` where the caller kept it
        (`Phase.keep`), and always when tracing."""
        ph = Phase()
        t0, step0 = self.now(), self._steps()
        if self.trace:
            with self._opened(name) as rec:
                yield ph
            ids = {"id": rec["id"], "parent": rec["parent"]}
        else:
            yield ph
            ids = {}
        if ph.kept or self.trace:
            self.records.append({"phase": name, "t0": t0, "t1": self.now(), "step0": step0,
                                 "step1": self._steps(), **ph.fields, **ids})

    def span(self, name: str, *, device: bool = False, **fields):
        """A span inside the open one, logged when tracing (with `device`
        on a card, a CUDA event pair around it as well); nothing when not."""
        return self._span(name, device, fields) if self.trace else _NULL

    @contextlib.contextmanager
    def _span(self, name: str, device: bool, fields: Dict) -> Iterator[None]:
        with self._opened(name, fields) as rec:
            if self._cuda and device:
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                yield
                b.record()
                self._pending.append((rec, a, b))
            else:
                yield
        rec["t1"] = self.now()
        self.records.append(rec)

    @contextlib.contextmanager
    def _opened(self, name: str, fields: Optional[Dict] = None):
        """Open span `name`: its record (t1 not yet set), the profiler
        range, and the top of the stack of open spans."""
        rec = {"phase": name, "t0": self.now(), "id": next(self._ids),
               "parent": self._parent(), **self._req(), **(fields or {})}
        self._open.append(rec)
        try:
            with torch.profiler.record_function("serve." + name):
                yield rec
        finally:
            self._open.pop()

    def _parent(self) -> Optional[int]:
        return self._open[-1]["id"] if self._open else None

    def _req(self) -> Dict:
        """The `req` of the span open now, which its children carry too."""
        return {"req": self._open[-1]["req"]} if self._open and "req" in self._open[-1] else {}

    def layers(self):
        """While tracing, let the model's `layer_span`s record into this
        log (wrap the `prefill` span's call into the model)."""
        return self._layers() if self.trace else _NULL

    @contextlib.contextmanager
    def _layers(self) -> Iterator[None]:
        token = _PREFILL.set(self)
        try:
            yield
        finally:
            _PREFILL.reset(token)

    def submitted(self, req: int) -> None:
        """Stamp request `req`'s submission (tracing only)."""
        if self.trace:
            self._submitted[req] = self.now()

    def queued(self, req: int) -> None:
        """Log request `req`'s wait from its submission to the start of
        the span open now (its `request`) as `queued`, a child of it."""
        t0 = self._submitted.pop(req, None)
        if t0 is not None:
            self.records.append({"phase": "queued", "t0": t0, "t1": self._open[-1]["t0"],
                                 "id": next(self._ids), "parent": self._parent(), "req": req})

    def forget(self, req: int) -> None:
        """Drop request `req`'s stamp (it leaves the queue unadmitted)."""
        self._submitted.pop(req, None)

    def resolve(self) -> None:
        """`device_ms` of each device span whose end event the device has
        passed (call after a host sync; adds none)."""
        left = []
        for rec, a, b in self._pending:
            if b.query():
                rec["device_ms"] = a.elapsed_time(b)
            else:
                left.append((rec, a, b))
        self._pending = left


def layer_span(name: str):
    """`prefill.<name>` inside an engine's traced `prefill` span; nothing
    for any other caller of the model."""
    log = _PREFILL.get()
    return log.span("prefill." + name) if log is not None else _NULL
