"""Host-driven oracle of the jit-resident serving engine.

Counterpart of `repro/serve/oracle.py`, copied line for line (host
Python, no tensor): it shares no code with `serve/jit_engine.py` and
its kernels, so a run of the engine on the card can be held page for
page against it.  `tests/test_torch_oracle.py` holds it equal to the
original.

`HostOracleEngine` replays a request trace through exactly the same
scheduling policy as `serve.jit_engine.JitServeEngine` — same lane
assignment (lowest free lane first), same FIFO admission with
all-or-nothing prompt-page claims and rollback, same in-step page
growth at page boundaries, same retirement rules (output budget or
allocation overflow), same burst frees — but entirely from Python
against per-shard host `NBBSRef` trees (`memory.kv_cache.PageOracle`,
which emulates the device pool rounds exactly).

It runs **no model**: a decode step simply advances every writable
lane by one token.  That is sufficient for the differential contract,
because with `eos=None` the jitted engine's page assignments,
retirement order, and pool occupancy depend only on prompt lengths,
output budgets, and arrival order — never on token values.  The
differential tests (tests/test_serving.py, tests/test_properties.py)
replay one trace through both engines and assert:

  * identical per-sequence page tables while running,
  * identical retirement order and retirement steps,
  * identical final pool occupancy (total and per shard).

Anything the compiled step gets wrong — a lane double-claiming a page,
a retirement burst freeing the wrong shard, an argmax tie flipping
scheduling — shows up as a divergence from this oracle.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.memory.kv_cache import PageOracle
from repro_torch.obs.schema import spec
from repro_torch.serve.engine import Request


class _Lane:
    __slots__ = ("seq_id", "ctx", "pages", "n_out", "max_new",
                 "active", "overflowed", "done_step")

    def __init__(self) -> None:
        self.seq_id = -1
        self.ctx = 0
        self.pages: List[int] = []  # global page ids, in append order
        self.n_out = 0
        self.max_new = 0
        self.active = False
        self.overflowed = False
        self.done_step = -1


class HostOracleEngine:
    """Scheduling-exact host mirror of `JitServeEngine` (no model)."""

    def __init__(
        self,
        *,
        num_pages: int = 256,
        page_tokens: int = 16,
        max_batch: int = 8,
        max_lane_pages: Optional[int] = None,
        max_out: int = 64,
        n_shards: int = 1,
        max_rounds: int = 64,
        fastpath: bool = False,
        fastpath_slab_level: int = 2,
        magazines: int = 0,
    ) -> None:
        if max_lane_pages is None:
            max_lane_pages = min(num_pages, 128)
        self.page_tokens = page_tokens
        self.max_batch = max_batch
        self.max_lane_pages = max_lane_pages
        self.max_out = max_out
        self.num_pages = num_pages
        self.magazines = magazines
        # one magazine per engine lane, exactly the jitted engine's
        # `mag_lane = lane index` wiring
        self.pool = PageOracle(
            num_pages,
            page_tokens,
            n_shards=n_shards,
            max_rounds=max_rounds,
            fastpath=fastpath,
            fastpath_slab_level=fastpath_slab_level,
            magazines=magazines,
            mag_lanes=max_batch if magazines else 0,
        )
        self.lanes = [_Lane() for _ in range(max_batch)]
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}
        self._lane_of: Dict[int, int] = {}
        self.completed: Dict[int, Request] = {}
        self.done_steps: Dict[int, int] = {}
        self.retired_order: List[int] = []
        self.step_no = 0
        self.stats = {
            "admitted": 0, "queued_full": 0, "rejected": 0,
            "steps": 0, "overflow_retired": 0,
            "admit_fastpath_hits": 0, "admit_fastpath_spills": 0,
            "admit_magazine_spills": 0,
        }

    # -- admission (mirrors JitServeEngine line for line) -------------
    def _pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_tokens)

    def _oversized(self, req: Request) -> bool:
        total = len(req.prompt) + req.max_new_tokens
        return (
            self._pages_for(total) > self.max_lane_pages
            or self._pages_for(total) > self.num_pages
            or req.max_new_tokens > self.max_out
        )

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _free_lanes(self) -> List[int]:
        return [i for i, ln in enumerate(self.lanes) if ln.seq_id < 0]

    def _admit(self) -> None:
        free = self._free_lanes()
        while self.waiting and free:
            req = self.waiting[0]
            if self._oversized(req):
                self.waiting.pop(0)
                req.done = True
                self.completed[req.req_id] = req
                self.stats["rejected"] += 1
                continue
            need = self._pages_for(len(req.prompt) - 1)
            # all-or-nothing wavefront claim, homed by the sequence id
            # (`admit_pages`: one wavefront lane per prompt page)
            h0, s0 = self.pool.fastpath_hits, self.pool.fastpath_spills
            m0 = self.pool.magazine_spills
            # magazine-oblivious claims (no mag_lanes): admission pages
            # are nobody's recycled working set, but the exhaustion
            # spill-back inside the wavefront still applies
            got = self.pool.alloc_wavefront(
                [(k, req.req_id) for k in range(need)]
            )
            self.stats["admit_fastpath_hits"] += self.pool.fastpath_hits - h0
            self.stats["admit_fastpath_spills"] += (
                self.pool.fastpath_spills - s0
            )
            self.stats["admit_magazine_spills"] += (
                self.pool.magazine_spills - m0
            )
            pages = [got[k] for k in range(need)]
            if any(p is None for p in pages):
                self.pool.free_burst(p for p in pages if p is not None)
                self.stats["queued_full"] += 1
                break
            self.waiting.pop(0)
            lane = self.lanes[free[0]]
            self._lane_of[req.req_id] = free.pop(0)
            lane.seq_id = req.req_id
            lane.ctx = len(req.prompt) - 1
            lane.pages = pages
            lane.n_out = 0
            lane.max_new = req.max_new_tokens
            lane.active = True
            lane.overflowed = False
            lane.done_step = -1
            self.running[req.req_id] = req
            self.stats["admitted"] += 1

    # -- the decode step (mirrors `_engine_step_impl`) ----------------
    def decode_steps(self, n: int) -> None:
        for _ in range(n):
            self._decode_one()
        self.stats["steps"] += n

    def _decode_one(self) -> None:
        pt, MP = self.page_tokens, self.max_lane_pages
        # 1. page growth for lanes crossing a page boundary, as one
        #    wavefront in lane order (lane ids = sequence ids)
        needers = [
            (i, ln.seq_id) for i, ln in enumerate(self.lanes)
            if ln.active and ln.ctx == len(ln.pages) * pt and len(ln.pages) < MP
        ]
        # decode growth claims each lane's own magazine first (the
        # engine's `mag_lane = arange(B)` wiring)
        got = self.pool.alloc_wavefront(
            needers, mag_lanes=[i for i, _ in needers]
        )
        overflow = set()
        for i, _ in needers:
            page = got[i]
            if page is None:
                overflow.add(i)
            else:
                self.lanes[i].pages.append(page)
        for i, ln in enumerate(self.lanes):  # lane table full = overflow
            if ln.active and ln.ctx == len(ln.pages) * pt and i not in overflow:
                overflow.add(i)
        # 2. decode: every writable lane advances one token
        retired = []
        for i, ln in enumerate(self.lanes):
            if not ln.active:
                continue
            if i in overflow:
                ln.overflowed = True
                retired.append(i)
                continue
            ln.ctx += 1
            ln.n_out += 1
            if ln.n_out >= ln.max_new:
                retired.append(i)
        # 3. burst free of every retired lane's pages; each page stashes
        #    into its own lane's magazine first (the engine's broadcast
        #    `mag_lane` over the retirement burst)
        freed: List[int] = []
        stash_lanes: List[int] = []
        for i in retired:
            ln = self.lanes[i]
            freed.extend(ln.pages)
            stash_lanes.extend([i] * len(ln.pages))
            ln.pages = []
            ln.active = False
            ln.done_step = self.step_no
        self.pool.free_burst(freed, stash_lanes=stash_lanes)
        self.step_no += 1

    def _drain(self) -> List[int]:
        lanes = [
            i for i, ln in enumerate(self.lanes)
            if ln.seq_id >= 0 and not ln.active
        ]
        lanes.sort(key=lambda i: (self.lanes[i].done_step, i))
        drained = []
        for i in lanes:
            ln = self.lanes[i]
            sid = ln.seq_id
            req = self.running.pop(sid)
            self._lane_of.pop(sid)
            req.out_tokens = [0] * ln.n_out  # token values are not modeled
            req.done = True
            self.completed[sid] = req
            self.done_steps[sid] = ln.done_step
            self.retired_order.append(sid)
            if ln.overflowed:
                self.stats["overflow_retired"] += 1
            drained.append(sid)
            ln.seq_id = -1
            ln.ctx = 0
            ln.n_out = 0
            ln.overflowed = False
            ln.done_step = -1
        return drained

    # -- the loop (mirrors JitServeEngine) ----------------------------
    def step(self) -> int:
        self._drain()
        self._admit()
        if not self.running:
            return 0
        self.decode_steps(1)
        return sum(ln.active for ln in self.lanes)

    def run_to_completion(
        self, max_steps: int = 10_000, chunk: int = 1
    ) -> None:
        steps = 0
        while steps < max_steps:
            self._drain()
            self._admit()
            if not self.running and not self.waiting:
                return
            if not self.running:
                break
            n = min(chunk, max_steps - steps)
            self.decode_steps(n)
            steps += n

    # -- observability (same numbering as the device tables) ----------
    def stat_totals(self) -> Dict[str, int]:
        """Metric totals under the same schema names the jitted
        engine's `stat_totals` reports (keys validated against
        obs/schema.py), so differential tests compare the two sides
        key-for-key.  The slab counters are the pool's combined
        admission+decode accounting — exactly what the engine's single
        merge of host admit counters and device accumulator yields."""
        out = dict(self.stats)
        out["fastpath_hits"] = self.pool.fastpath_hits
        out["fastpath_spills"] = self.pool.fastpath_spills
        out["magazine_hits"] = self.pool.magazine_hits
        out["magazine_spills"] = self.pool.magazine_spills
        out["magazine_refills"] = self.pool.magazine_refills
        for name in out:
            spec(name)  # raises on unregistered metric names
        return out

    def block_table(self, seq_id: int) -> np.ndarray:
        lane = self.lanes[self._lane_of[seq_id]]
        out = np.full((self.max_lane_pages,), -1, np.int32)
        out[: len(lane.pages)] = lane.pages
        return out

    def free_pages(self) -> int:
        return self.pool.free_pages()
