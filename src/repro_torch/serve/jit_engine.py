"""Device-resident continuous-batching engine: one decode step with no
host synchronisation.

Counterpart of `repro/serve/jit_engine.py` with either tree layout
(`layout="unpacked"` or `"bunch-packed"`), the fastpath slab
(`fastpath=True`), the per-lane magazines (`magazines=mag_cap`) and the
event ring (`ring_capacity=cap`).  Each `engine_step` does, on the
device and without a host sync:

  1. boundary alloc: one page for every lane whose next token starts a
     page (`core.nbbs.nb_pool_alloc_pages`, one launch of the pooled
     NBBS kernel A on the card, slab claim included).  With magazines
     each lane first pops its own magazine with a zero rank
     (`nb_pool_alloc_pages_mag`): the claim, then kernel A for the
     misses, then a second launch for the spill-back and retry, masked
     to nothing unless a lane failed while magazines hold pages;
  2. paged decode of every writable lane (`serve.paged_decode`, one
     launch of the paged-attention kernel per layer on the card), then
     greedy sampling;
  3. retirement and one merged burst free of every retired lane's pages
     (`core.nbbs.nb_pool_free_pages`, one more launch of kernel A's
     release half).  With magazines a retired lane first stashes its
     pages in its own magazine, ranked by column, its handles known
     owned (`nb_pool_free_pages_mag`);
  4. the schema's per-step metrics (`obs.schema.ENGINE_METRICS`); the
     capacity gauges count stashed pages as free; one `EV_STEP` event
     pushed to the ring (`obs/ring.py`) when a lane was live.

Kernel A launches per decode step: 2 without magazines, 3 with them.

JAX threads a donated, immutable `EngineState` through a jitted step;
here `EngineState` is a set of tensors that keep their addresses for
the engine's life.  `engine_step` and `engine_run` (`num_steps` steps,
JAX's `lax.scan` chunk) run on a shallow copy of the state, whose small
per-lane registers the steps rebind, and copy the final tensors back
into the state's own; the KV pool and the output tokens are written in
place throughout, and the host helpers (`prefill_insert`,
`clear_lanes`, admission) write in place too.

`JitServeEngine.decode_steps(n, fused=True)` runs a chunk as one
dispatch, as JAX's does.  On the card the first fused chunk of each
`n` runs `engine_run` eagerly on a side stream (the warm-up: it builds
the kernels and sets their attributes and cuBLAS's workspace), then
captures it into a `torch.cuda.CUDAGraph` (`CAPTURE_COUNTS`); every
later fused chunk of that `n` is one replay, with no host sync and no
Python per op.  On the CPU a fused chunk is `engine_run` itself.  The
device decides, as it does for every kernel wrapper; a failed capture
or replay raises.  The host syncs where the JAX shim does, at admission
(free lanes, `admitted`) and at drain.

`JitServeEngine` logs its host phases (admission bursts, decode chunks,
drains) as wall-clock spans (`obs/spans.py`; with `trace=True` the spans
inside them too, each a `serve.<name>` profiler range, and the device
time of each graph replay and prefill), and `snapshot()` drains the
metric totals, the ring's surviving window and the spans into the format
that `obs/trace_export.py` renders as a Perfetto trace.  Every host read
of the loop (one wait for the device each) is counted by site in
`host_reads`, which the snapshot carries too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.concurrent import BUNCH_PACKED, I32, UNPACKED, TreeConfig
from repro_torch.core.fastpath import FastPathConfig
from repro_torch.core.magazine import MagazineConfig, MagazineState, mag_total
from repro_torch.core.nbbs import (
    nb_pool_alloc_pages,
    nb_pool_alloc_pages_mag,
    nb_pool_free_pages,
    nb_pool_free_pages_mag,
)
from repro_torch.core.pool import (
    PoolConfig,
    home_shard,
    pool_free_units,
    pool_init_magazines,
    pool_largest_run,
    pool_mag_free_per_shard,
)
from repro_torch.kernels import counters as kcounters
from repro_torch.models.transformer import ATTENTION_FAMILIES
from repro_torch.obs import metrics as om
from repro_torch.obs import ring as oring
from repro_torch.obs.schema import ENGINE_METRICS
from repro_torch.obs.spans import SpanLog
from repro_torch.obs.trace_export import SNAPSHOT_VERSION
from repro_torch.serve.engine import Request
from repro_torch.serve.paged_decode import init_pool, paged_decode_step, serve_prefill

Metrics = om.Metrics

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the span of each host-read site of the loop (`JitServeEngine._read`):
# the claim's counters are read with its result
_SYNC_SPANS = {"fastpath": "sync.claim", "magazine": "sync.claim"}

# CUDA graphs captured, keyed by (EngineConfig, chunk length) as JAX's
# TRACE_COUNTS is by config: a fused chunk of a given length is captured
# once per engine and replayed after, so tests can pin "captures once,
# then stable" by watching this counter.
CAPTURE_COUNTS: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static geometry of the engine."""

    arch: ArchConfig
    num_pages: int
    page_tokens: int
    max_batch: int
    max_lane_pages: int
    max_out: int
    n_shards: int = 1
    layout: str = "unpacked"
    eos: Optional[int] = None
    dtype: str = "float32"
    max_rounds: int = 64
    # fixed-size fast path (core/fastpath.py): a per-shard bitmap slab of
    # single pages carved out of the buddy tree
    fastpath: bool = False
    fastpath_slab_level: int = 2
    # per-lane magazine capacity (core/magazine.py); 0 disables them
    magazines: int = 0
    magazine_refill: int = 0
    # event ring capacity (obs/ring.py); 0 keeps only the count
    ring_capacity: int = 0

    def __post_init__(self):
        if self.num_pages & (self.num_pages - 1):
            raise ValueError("num_pages must be a power of two")
        if self.ring_capacity < 0:
            raise ValueError("ring_capacity must be >= 0")
        if self.n_shards < 1 or (self.n_shards & (self.n_shards - 1)):
            raise ValueError("n_shards must be a power of two >= 1")
        if self.num_pages % self.n_shards:
            raise ValueError("num_pages must divide evenly across shards")
        if self.layout not in ("unpacked", "bunch-packed"):
            raise ValueError(f"unknown tree layout {self.layout!r}")
        if self.magazines < 0 or self.magazine_refill < 0:
            raise ValueError("magazines/magazine_refill must be >= 0")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        if self.fastpath or self.magazines:
            self.pool_config()  # fail fast on bad slab/magazine geometry

    @property
    def pages_per_shard(self) -> int:
        return self.num_pages // self.n_shards

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def pool_config(self) -> PoolConfig:
        depth = (self.pages_per_shard - 1).bit_length()
        layout = BUNCH_PACKED if self.layout == "bunch-packed" else UNPACKED
        fp = (FastPathConfig(level=None, slab_level=self.fastpath_slab_level)
              if self.fastpath else None)
        mcfg = (MagazineConfig(mag_cap=self.magazines, refill_batch=self.magazine_refill)
                if self.magazines else None)
        return PoolConfig(TreeConfig(depth=depth, max_level=0, layout=layout),
                          self.n_shards, fastpath=fp, magazines=mcfg)

    def lane_capacity_tokens(self) -> int:
        return self.max_lane_pages * self.page_tokens


@dataclasses.dataclass
class EngineState:
    """Device-resident engine state.  `engine_step`, `engine_run` and the
    host helpers update its tensors in place: they keep their addresses,
    which a captured decode chunk reads and writes."""

    trees: torch.Tensor       # int32[S, n_state_words] pool tree state words
    kv_k: torch.Tensor        # [L, P+1, page, Hkv, D] page pool + sink page
    kv_v: torch.Tensor
    page_shard: torch.Tensor  # int32[B, MP] page handle shard, -1 = none
    page_off: torch.Tensor    # int32[B, MP] page handle unit offset
    seq_id: torch.Tensor      # int32[B]     -1 = empty lane
    ctx: torch.Tensor         # int32[B]     tokens in the KV cache
    n_pages: torch.Tensor     # int32[B]     pages mapped in the lane table
    last_tok: torch.Tensor    # int32[B]     next decode input token
    out_toks: torch.Tensor    # int32[B, MO] generated tokens
    n_out: torch.Tensor       # int32[B]     generated so far
    max_new: torch.Tensor     # int32[B]     per-lane output budget
    active: torch.Tensor      # bool[B]      decoding this step?
    overflowed: torch.Tensor  # bool[B]      retired by in-step alloc failure
    done_step: torch.Tensor   # int32[B]     retirement step, -1 live
    step_no: torch.Tensor     # int32 scalar global step counter
    ring: oring.EventRing     # event ring (capacity 0 = counts only)
    mag_pages: torch.Tensor   # int32[B, mag_cap] per-lane magazine, -1 empty
    mag_depth: torch.Tensor   # int32[B]     magazine fill depth
    logits: torch.Tensor      # float32[B, V] of the last step


def _engine_mags(state: EngineState) -> MagazineState:
    return MagazineState(pages=state.mag_pages, depth=state.mag_depth)


def _zero_metrics(ecfg: EngineConfig, device) -> Metrics:
    return om.zeros(
        ENGINE_METRICS, vector_lens={"free_pages_shard": ecfg.n_shards},
        device=device,
    )


def init_engine_state(ecfg: EngineConfig, device="cuda") -> EngineState:
    arch = ecfg.arch
    B, MP, MO = ecfg.max_batch, ecfg.max_lane_pages, ecfg.max_out
    pool = init_pool(arch, ecfg.num_pages, ecfg.page_tokens, ecfg.tdtype, device)

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return EngineState(
        trees=ecfg.pool_config().empty_trees(device),
        kv_k=pool["k"],
        kv_v=pool["v"],
        page_shard=full((B, MP), -1),
        page_off=full((B, MP), -1),
        seq_id=full((B,), -1),
        ctx=full((B,), 0),
        n_pages=full((B,), 0),
        last_tok=full((B,), 0),
        out_toks=full((B, MO), 0),
        n_out=full((B,), 0),
        max_new=full((B,), 0),
        active=full((B,), False, torch.bool),
        overflowed=full((B,), False, torch.bool),
        done_step=full((B,), -1),
        step_no=full((), 0),
        ring=oring.make_ring(ecfg.ring_capacity, device),
        **_init_mag_fields(ecfg, device),
        logits=torch.zeros((B, arch.vocab_size), dtype=torch.float32, device=device),
    )


def _init_mag_fields(ecfg: EngineConfig, device) -> dict:
    """One magazine per engine lane when magazines are on; zero-width
    placeholders when off."""
    B = ecfg.max_batch
    if ecfg.magazines:
        mags = pool_init_magazines(ecfg.pool_config(), B, device)
        return {"mag_pages": mags.pages, "mag_depth": mags.depth}
    return {
        "mag_pages": torch.zeros((B, 0), dtype=I32, device=device),
        "mag_depth": torch.zeros(B, dtype=I32, device=device),
    }


def global_tables(ecfg: EngineConfig, page_shard, page_off) -> torch.Tensor:
    """Global page ids (shard base folded in), -1 padded."""
    return torch.where(
        page_shard >= 0, page_shard * ecfg.pages_per_shard + page_off, -1
    ).to(I32)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    if src is not dst:
        dst.copy_(src)


def _write_back(state: EngineState, work: EngineState) -> None:
    """Copy the final tensors of steps run on `work`, a shallow copy of
    `state`, into `state`'s own."""
    for f in dataclasses.fields(EngineState):
        old, new = getattr(state, f.name), getattr(work, f.name)
        if f.name == "ring":
            _assign(old.buf, new.buf)
            _assign(old.count, new.count)
        else:
            _assign(old, new)


def engine_step(ecfg: EngineConfig, params: dict, state: EngineState) -> Metrics:
    """One decode iteration (alloc + decode + free) over every lane.
    Updates `state` in place and returns this step's metrics; no host
    sync."""
    work = dataclasses.replace(state)
    m = _step(ecfg, params, work)
    _write_back(state, work)
    return m


def engine_run(ecfg: EngineConfig, params: dict, state: EngineState,
               num_steps: int) -> Metrics:
    """`num_steps` decode iterations (JAX's `lax.scan` chunk), updating
    `state` in place once at the end.  Returns the chunk's metrics as
    JAX's trajectory reduces: one stack per metric, counters and
    histograms summed over the steps, gauges from the last step."""
    work = dataclasses.replace(state)
    traj = [_step(ecfg, params, work) for _ in range(num_steps)]
    _write_back(state, work)
    return om.reduce_trajectory({k: torch.stack([m[k] for m in traj]) for k in traj[0]})


def _step(ecfg: EngineConfig, params: dict, state: EngineState) -> Metrics:
    """The step on a working copy: the KV pool, block-table columns,
    output tokens and step counter are written in place, the other
    registers rebound."""
    pcfg = ecfg.pool_config()
    B, MP, MO = ecfg.max_batch, ecfg.max_lane_pages, ecfg.max_out
    pt = ecfg.page_tokens
    dev = state.ctx.device
    bidx = torch.arange(B, device=dev)

    # -- 1. page allocation for lanes crossing a page boundary --------
    boundary = state.active & (state.ctx == state.n_pages * pt)
    need = boundary & (state.n_pages < MP)  # lane table full = overflow
    mags = _engine_mags(state)
    if ecfg.magazines:
        # magazine-first claim; every lane owns its magazine, so the
        # claim rank is zero and no sort runs in the step
        trees, mags, a_shard, a_off, ok, astats = nb_pool_alloc_pages_mag(
            pcfg, state.trees, mags, need, state.seq_id, ecfg.max_rounds,
            mag_lane=bidx, mag_rank=torch.zeros(B, dtype=I32, device=dev),
        )
    else:
        trees, a_shard, a_off, ok, astats = nb_pool_alloc_pages(
            pcfg, state.trees, need, state.seq_id, ecfg.max_rounds
        )
    pos = state.n_pages.clamp(0, MP - 1).long()
    state.page_shard[bidx, pos] = torch.where(ok, a_shard, state.page_shard[bidx, pos])
    state.page_off[bidx, pos] = torch.where(ok, a_off, state.page_off[bidx, pos])
    n_pages = state.n_pages + ok.to(I32)
    overflow_now = boundary & ~ok

    # -- 2. one paged decode for every writable lane ------------------
    writable = state.active & ~overflow_now
    tables = global_tables(ecfg, state.page_shard, state.page_off)
    logits = paged_decode_step(
        ecfg.arch, params, {"k": state.kv_k, "v": state.kv_v}, tables,
        state.ctx, state.last_tok, page_tokens=pt, dtype=ecfg.tdtype,
        active=writable,
    )
    state.logits = logits
    nxt = logits.argmax(dim=-1).to(I32)
    wrote = writable
    ctx = state.ctx + wrote.to(I32)
    out_pos = state.n_out.clamp(0, MO - 1).long()
    state.out_toks[bidx, out_pos] = torch.where(
        wrote, nxt, state.out_toks[bidx, out_pos]
    )
    n_out = state.n_out + wrote.to(I32)
    last_tok = torch.where(wrote, nxt, state.last_tok)

    # -- 3. retirement + burst free of every retired lane's pages -----
    finished = wrote & (n_out >= state.max_new)
    if ecfg.eos is not None:
        finished = finished | (wrote & (nxt == ecfg.eos))
    retire = finished | overflow_now
    f_active = (retire[:, None] & (state.page_shard >= 0)).reshape(-1)
    if ecfg.magazines:
        # retired lanes stash their pages in their own magazine first;
        # block tables fill prefix-wise with distinct owned pages, so the
        # stash rank is the column index and the handles are known owned
        f_lane = bidx[:, None].expand(B, MP).reshape(-1)
        f_rank = torch.arange(MP, dtype=I32, device=dev)[None, :].expand(B, MP).reshape(-1)
        trees, mags, _, fstats = nb_pool_free_pages_mag(
            pcfg, trees, mags, state.page_shard.reshape(-1),
            state.page_off.reshape(-1), f_active,
            mag_lane=f_lane, mag_rank=f_rank, assume_owned=True,
        )
    else:
        trees, _, fstats = nb_pool_free_pages(
            pcfg, trees, state.page_shard.reshape(-1), state.page_off.reshape(-1),
            f_active,
        )
    retired = retire[:, None]
    state.page_shard = torch.where(retired, -1, state.page_shard).to(I32)
    state.page_off = torch.where(retired, -1, state.page_off).to(I32)
    was_active = state.active
    state.trees = trees
    state.mag_pages, state.mag_depth = mags.pages, mags.depth
    state.n_pages = torch.where(retire, 0, n_pages).to(I32)
    state.active = state.active & ~retire
    state.overflowed = state.overflowed | overflow_now
    state.done_step = torch.where(
        retire & (state.done_step < 0), state.step_no, state.done_step
    ).to(I32)
    state.ctx, state.n_out, state.last_tok = ctx, n_out, last_tok

    # -- 4. telemetry: named metrics + one ring event per live step ---
    fp_shard = pool_free_units(pcfg, trees)
    if ecfg.magazines:
        # stashed pages are allocated in the tree's eyes but claimable
        fp_shard = fp_shard + pool_mag_free_per_shard(pcfg, mags)
    free_total = fp_shard.sum(dtype=I32)
    won = ok.sum(dtype=I32)
    n_over = overflow_now.sum(dtype=I32)
    ring0 = state.ring
    live = was_active.any()
    if oring.capacity(ring0) == 0:
        # counts only: eager PyTorch would build the event row for nothing
        state.ring = oring.EventRing(ring0.buf, ring0.count + live.to(I32))
    else:
        state.ring = oring.push(
            ring0,
            oring.event(
                oring.EV_STEP,
                step=state.step_no,
                lanes_won=won,
                lanes_overflowed=n_over,
                lanes_spilled=astats["fastpath_spills"],
                frees_merged=fstats["freed"],
                rounds=astats["rounds"],
                free_pages=free_total,
            ),
            mask=live,
        )
    m = _zero_metrics(ecfg, dev)
    m["alloc_pages"] = won
    m["freed_pages"] = fstats["freed"]
    m["overflow_lanes"] = n_over
    m["probe_overflows"] = astats["overflows"]
    m["retired"] = retire.sum(dtype=I32)
    m["active_lanes"] = state.active.sum(dtype=I32)
    m["alloc_rounds"] = astats["rounds"]
    m["merged_writes"] = astats["merged_writes"]
    m["logical_rmws"] = astats["logical_rmws"]
    m["free_merged_writes"] = fstats["free_merged_writes"]
    m["free_logical_rmws"] = fstats["free_logical_rmws"]
    m["free_pages"] = free_total
    m["free_pages_shard"] = fp_shard
    run = pool_largest_run(pcfg, trees)
    if ecfg.magazines:
        # a non-empty magazine can always serve a 1-run
        run = torch.where(mag_total(mags) > 0, torch.clamp(run, min=1), run)
        m["magazine_hits"] = astats["magazine_hits"]
        m["magazine_spills"] = astats["magazine_spills"] + fstats["magazine_spills"]
        m["magazine_refills"] = astats["magazine_refills"]
    m["largest_run"] = run
    m["fastpath_hits"] = astats["fastpath_hits"]
    m["fastpath_spills"] = astats["fastpath_spills"]
    # ring counters as per-step deltas (merge sums them back up)
    m["ring_events"] = state.ring.count - ring0.count
    m["ring_dropped"] = oring.dropped(state.ring) - oring.dropped(ring0)
    m = om.observe(m, "alloc_rounds_hist", astats["rounds"])
    home = home_shard(pcfg, state.seq_id)
    dist = (a_shard - home) % pcfg.n_shards
    m = om.observe_many(m, "probe_distance_hist", dist, ok)
    state.step_no += 1
    return m


# ---------------------------------------------------------------------------
# Admission-boundary helpers (the host calls these between decode bursts)
# ---------------------------------------------------------------------------


def admit_pages(ecfg: EngineConfig, trees, mag_pages, mag_depth, seq_id: int, need: int):
    """All-or-nothing claim of `need` prompt pages for one sequence:
    every page is a leaf-unit lane homed by the sequence id; on partial
    failure the successes are rolled back by a second (free) pass, so a
    failed admission leaves the pool bit-identical.

    Admission claims no magazine page, but with magazines an exhaustion
    still spills every stashed page back and retries, so trees and
    magazines change even when the admission fails: callers keep both.

    Returns (trees, mag_pages, mag_depth, shards[MP], offs[MP], admitted,
    probe_overflows, fastpath_hits, fastpath_spills, magazine_spills);
    the counters come from the alloc pass alone (rolled-back claims
    included)."""
    pcfg = ecfg.pool_config()
    MP = ecfg.max_lane_pages
    dev = trees.device
    active = torch.arange(MP, device=dev) < need
    lane_ids = torch.full((MP,), seq_id, dtype=I32, device=dev)
    mag_spills = torch.zeros((), dtype=I32, device=dev)
    if ecfg.magazines:
        mags = MagazineState(pages=mag_pages, depth=mag_depth)
        trees1, mags, shard, off, ok, stats = nb_pool_alloc_pages_mag(
            pcfg, trees, mags, active, lane_ids, ecfg.max_rounds
        )
        mag_pages, mag_depth = mags.pages, mags.depth
        mag_spills = stats["magazine_spills"]
    else:
        trees1, shard, off, ok, stats = nb_pool_alloc_pages(
            pcfg, trees, active, lane_ids, ecfg.max_rounds
        )
    admitted = ok.sum() == need
    trees_rb, _, _ = nb_pool_free_pages(pcfg, trees1, shard, off, ok & ~admitted)
    trees_out = torch.where(admitted, trees1, trees_rb)
    keep = admitted & ok
    return (
        trees_out,
        mag_pages,
        mag_depth,
        torch.where(keep, shard, -1).to(I32),
        torch.where(keep, off, -1).to(I32),
        admitted,
        stats["overflows"],
        stats["fastpath_hits"],
        stats["fastpath_spills"],
        mag_spills,
    )


def prefill_insert(
    ecfg: EngineConfig,
    state: EngineState,
    lane: int,
    seq_id: int,
    shards: torch.Tensor,   # int32[MP] from admit_pages
    offs: torch.Tensor,     # int32[MP]
    n_pages: int,
    kv_len: int,            # prompt tokens to copy (= S-1)
    cache_k: torch.Tensor,  # [L, Spad, Hkv, D] prefill KV (bucketed)
    cache_v: torch.Tensor,
    last_tok: int,
    max_new: int,
) -> None:
    """Insert an admitted sequence into an empty lane: write the prefill
    KV of positions 0..kv_len-1 into its pages and set the lane's
    registers so the next step decodes position kv_len."""
    pt, P, MP = ecfg.page_tokens, ecfg.num_pages, ecfg.max_lane_pages
    dev = state.ctx.device
    gpage = torch.where(shards >= 0, shards * ecfg.pages_per_shard + offs, P)
    Spad = cache_k.shape[1]
    t = torch.arange(Spad, device=dev)
    pidx = gpage[(t // pt).clamp(0, MP - 1)]
    pidx = torch.where(t < kv_len, pidx, P).long()   # P is the sink page
    slot = t % pt
    state.kv_k[:, pidx, slot] = cache_k.to(state.kv_k.dtype)
    state.kv_v[:, pidx, slot] = cache_v.to(state.kv_v.dtype)
    state.page_shard[lane] = shards
    state.page_off[lane] = offs
    state.seq_id[lane] = seq_id
    state.ctx[lane] = kv_len
    state.n_pages[lane] = n_pages
    state.last_tok[lane] = last_tok
    state.n_out[lane] = 0
    state.max_new[lane] = max_new
    state.active[lane] = True
    state.overflowed[lane] = False
    state.done_step[lane] = -1


def clear_lanes(ecfg: EngineConfig, state: EngineState, mask: torch.Tensor) -> None:
    """Reset drained lanes to empty, in place (their pages were already
    freed by the retirement burst inside `engine_step`)."""
    state.seq_id.masked_fill_(mask, -1)
    state.ctx.masked_fill_(mask, 0)
    state.n_out.masked_fill_(mask, 0)
    state.overflowed.masked_fill_(mask, False)
    state.done_step.masked_fill_(mask, -1)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


# ---------------------------------------------------------------------------
# The thin host shim
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ChunkGraph:
    """A captured fused chunk: its graph, its metric outputs (rewritten
    by every replay) and the kernel launches of one replay."""

    graph: "torch.cuda.CUDAGraph"
    metrics: Metrics
    launches: kcounters.Counts


class JitServeEngine:
    """Request-queue shim around `engine_step`: admission and drain on
    the host, every per-token step on the device (`decode_steps` runs
    whole chunks with no host sync; `fused=True` as one dispatch)."""

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        num_pages: int = 256,
        page_tokens: int = 16,
        max_batch: int = 8,
        max_lane_pages: Optional[int] = None,
        max_out: int = 64,
        eos_token: Optional[int] = None,
        dtype=torch.float32,
        device="cuda",
        n_shards: int = 1,
        layout: Optional[str] = None,
        max_rounds: int = 64,
        fastpath: bool = False,
        fastpath_slab_level: int = 2,
        magazines: int = 0,
        magazine_refill: int = 0,
        ring_capacity: int = 0,
        trace: bool = False,
    ) -> None:
        if cfg.family not in ATTENTION_FAMILIES:  # before any pool is allocated
            raise ValueError("paged engine covers attention families")
        if max_lane_pages is None:
            max_lane_pages = min(num_pages, 128)
        self.ecfg = EngineConfig(
            arch=cfg,
            num_pages=num_pages,
            page_tokens=page_tokens,
            max_batch=max_batch,
            max_lane_pages=max_lane_pages,
            max_out=max_out,
            n_shards=n_shards,
            layout=layout or "unpacked",
            eos=eos_token,
            dtype=str(dtype).replace("torch.", ""),
            max_rounds=max_rounds,
            fastpath=fastpath,
            fastpath_slab_level=fastpath_slab_level,
            magazines=magazines,
            magazine_refill=magazine_refill,
            ring_capacity=ring_capacity,
        )
        self.device = torch.device(device)
        self.cfg = cfg
        self.params = params
        self.page_tokens = page_tokens
        self.max_batch = max_batch
        self.state = init_engine_state(self.ecfg, self.device)
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}   # seq_id -> request
        self._lane_of: Dict[int, int] = {}
        self.completed: Dict[int, Request] = {}
        self.done_steps: Dict[int, int] = {}    # seq_id -> retire step
        self.retired_order: List[int] = []      # drain-observed order
        self.stats = {
            "admitted": 0, "queued_full": 0, "rejected": 0,
            "steps": 0, "overflow_retired": 0,
            "admit_fastpath_hits": 0, "admit_fastpath_spills": 0,
            "admit_magazine_spills": 0,
        }
        self.acc = _zero_metrics(self.ecfg, self.device)
        self._graphs: Dict[int, _ChunkGraph] = {}   # chunk length -> graph
        # host-phase span log for the trace exporter: wall-clock windows
        # of admissions, decode chunks and drains (with `trace`, the spans
        # inside them), in seconds since `_t_origin`
        self._log = SpanLog(lambda: self.stats["steps"], trace=trace,
                            cuda=self.device.type == "cuda")
        self.spans: List[Dict] = self._log.records
        self._t_origin = self._log.origin
        # host reads by site, kept apart from `stats`, which mirror the
        # JAX engine's
        self.host_reads: Counter = Counter()

    def _read(self, site: str, *tensors) -> List[np.ndarray]:
        """Host copies of `tensors`: one read, counted by `site` in
        `host_reads`, whose first copy waits for the device."""
        self.host_reads[site] += 1
        with self._log.span(_SYNC_SPANS.get(site, "sync." + site)):
            return [t.cpu().numpy() for t in tensors]

    # -- admission ----------------------------------------------------
    def _pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_tokens)

    def _oversized(self, req: Request) -> bool:
        """A request that can never fit the lane geometry: reject it
        instead of blocking the queue behind it."""
        total = len(req.prompt) + req.max_new_tokens
        return (
            self._pages_for(total) > self.ecfg.max_lane_pages
            or self._pages_for(total) > self.ecfg.num_pages
            or req.max_new_tokens > self.ecfg.max_out
        )

    def submit(self, req: Request) -> None:
        self._log.submitted(req.req_id)
        self.waiting.append(req)

    def _free_lanes(self) -> List[int]:
        seq, = self._read("lanes", self.state.seq_id)
        return [int(i) for i in np.nonzero(seq < 0)[0]]

    def _admit(self) -> None:
        with self._log.phase("admit") as ph:
            admitted0 = self.stats["admitted"]
            free = self._free_lanes()
            while self.waiting and free:
                req = self.waiting[0]
                if self._oversized(req):
                    self.waiting.pop(0)
                    req.done = True
                    self.completed[req.req_id] = req
                    self.stats["rejected"] += 1
                    self._log.forget(req.req_id)
                    continue
                with self._log.span("request", req=req.req_id):
                    if not self._claim(req, free):
                        break  # pool full: natural admission control
            n_adm = self.stats["admitted"] - admitted0
            if n_adm:
                ph.keep(admitted=n_adm)

    def _claim(self, req: Request, free: List[int]) -> bool:
        """Claim `req`'s prompt pages; if they were all free, prefill it
        into the first free lane.  Returns whether it was admitted."""
        need = self._pages_for(len(req.prompt) - 1)
        st = self.state
        with self._log.span("claim"):
            (trees, mag_pages, mag_depth, shards, offs, admitted,
             _, fp_h, fp_s, mag_sp) = admit_pages(
                self.ecfg, st.trees, st.mag_pages, st.mag_depth, req.req_id, need
            )
            # in place: a captured decode chunk reads these tensors
            _assign(st.trees, trees)
            _assign(st.mag_pages, mag_pages)
            _assign(st.mag_depth, mag_depth)
        # admission syncs on `admitted` anyway
        if self.ecfg.fastpath:
            hits, spills = self._read("fastpath", fp_h, fp_s)
            self.stats["admit_fastpath_hits"] += int(hits)
            self.stats["admit_fastpath_spills"] += int(spills)
        if self.ecfg.magazines:
            self.stats["admit_magazine_spills"] += int(self._read("magazine", mag_sp)[0])
        if not bool(self._read("claim", admitted)[0]):
            self.stats["queued_full"] += 1
            return False
        self._log.queued(req.req_id)
        self.waiting.pop(0)
        self._insert(free.pop(0), req, shards, offs, need)
        self.stats["admitted"] += 1
        return True

    def _insert(self, lane: int, req: Request, shards, offs, n_pages) -> None:
        S = len(req.prompt)
        arch, ecfg = self.cfg, self.ecfg
        Spad = _next_pow2(S)
        if S > 1:
            toks = np.zeros((1, Spad), np.int64)
            toks[0, :S] = req.prompt
            with self._log.span("prefill", device=True, tokens=S, padded=Spad), \
                    self._log.layers():
                _, cache = serve_prefill(
                    arch, self.params,
                    {"tokens": torch.from_numpy(toks).to(self.device)},
                    max_len=Spad, dtype=ecfg.tdtype,
                )
            cache_k, cache_v = cache["k"][:, 0], cache["v"][:, 0]
        else:
            kv_shape = (arch.n_layers, Spad, arch.n_kv_heads, arch.head_dim)
            cache_k = torch.zeros(kv_shape, dtype=ecfg.tdtype, device=self.device)
            cache_v = torch.zeros(kv_shape, dtype=ecfg.tdtype, device=self.device)
        with self._log.span("insert"):
            prefill_insert(
                ecfg, self.state, lane, req.req_id, shards, offs, n_pages, S - 1,
                cache_k, cache_v, int(req.prompt[S - 1]), req.max_new_tokens,
            )
        self.running[req.req_id] = req
        self._lane_of[req.req_id] = lane

    # -- the device loop ----------------------------------------------
    def decode_steps(self, n: int, *, fused: bool = False) -> None:
        """Run n decode iterations with no host sync.  With `fused=True`
        the whole chunk is one dispatch: on the card the replay of its
        captured CUDA graph (`_fused_chunk`)."""
        with self._log.phase("decode") as ph:
            if fused:
                self.acc = om.merge(self.acc, self._fused_chunk(n))
            else:
                for _ in range(n):
                    with self._log.span("step", n=1):
                        m = engine_step(self.ecfg, self.params, self.state)
                    self.acc = om.merge(self.acc, m)
            self.stats["steps"] += n
            ph.keep(n=n, fused=int(fused))

    def _fused_chunk(self, n: int) -> Metrics:
        """The metrics of one fused chunk of n steps: `engine_run` on the
        CPU; on the card a replay of the chunk's graph (captured by the
        first chunk of each n), whose metric outputs the next replay
        overwrites, so they are cloned.  The kernels' launch counters
        gain the graph's launches at every replay."""
        if self.device.type != "cuda":
            with self._log.span("step", n=n):
                return engine_run(self.ecfg, self.params, self.state, n)
        g = self._graphs.get(n)
        if g is None:
            with self._log.span("capture", n=n):
                return self._capture(n)
        with self._log.span("replay", device=True, n=n):
            g.graph.replay()
        kcounters.add(g.launches)
        return {k: v.clone() for k, v in g.metrics.items()}

    def _capture(self, n: int) -> Metrics:
        """The first fused chunk of n steps on the card: `engine_run`
        eagerly on a side stream, then captured into a CUDA graph (the
        capture launches nothing and leaves the state as it is).
        Returns the eager chunk's metrics."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = engine_run(self.ecfg, self.params, self.state, n)
            before = kcounters.launch_counts()
            graph = torch.cuda.CUDAGraph()
            # the collector stays off: another engine's graph freed while
            # this one captures would end the capture
            collecting = gc.isenabled()
            gc.disable()
            graph.capture_begin()
            try:
                out = engine_run(self.ecfg, self.params, self.state, n)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            else:
                graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            launches = kcounters.since(before)
            kcounters.add(launches, -1)  # the capture launched nothing
        cur.wait_stream(side)
        CAPTURE_COUNTS[(self.ecfg, n)] += 1
        self._graphs[n] = _ChunkGraph(graph, out, launches)
        return warm

    def _drain(self) -> List[int]:
        """Collect retired lanes (one host sync), clear them, and return
        the drained seq ids in retirement-step order."""
        with self._log.phase("drain") as ph:
            st = self.state
            seq, act, n_out, out_toks, over, done = self._read(
                "drain", st.seq_id, st.active, st.n_out, st.out_toks, st.overflowed,
                st.done_step)
            self._log.resolve()   # the read waited for every device span before it
            lanes = np.nonzero((seq >= 0) & ~act)[0]
            lanes = sorted(lanes, key=lambda i: (int(done[i]), int(i)))
            drained = []
            for lane in lanes:
                sid = int(seq[lane])
                req = self.running.pop(sid)
                self._lane_of.pop(sid)
                req.out_tokens = [int(t) for t in out_toks[lane, : n_out[lane]]]
                req.done = True
                self.completed[sid] = req
                self.done_steps[sid] = int(done[lane])
                self.retired_order.append(sid)
                if over[lane]:
                    self.stats["overflow_retired"] += 1
                drained.append(sid)
            if drained:
                mask = np.zeros((self.ecfg.max_batch,), bool)
                mask[list(lanes)] = True
                clear_lanes(self.ecfg, self.state, torch.from_numpy(mask).to(self.device))
                ph.keep(drained=len(drained))
        return drained

    # -- ServeEngine-compatible surface --------------------------------
    def step(self) -> int:
        """Drain + admit + one decode step.  Returns the number of
        running sequences (a host sync)."""
        self._drain()
        self._admit()
        if not self.running:
            return 0
        self.decode_steps(1)
        return int(self._read("step", self.state.active.sum())[0])

    def run_to_completion(self, max_steps: int = 10_000, chunk: int = 1) -> None:
        steps = 0
        while steps < max_steps:
            self._drain()
            self._admit()
            if not self.running and not self.waiting:
                return
            if not self.running:
                break
            n = min(chunk, max_steps - steps)
            self.decode_steps(n, fused=chunk > 1)
            steps += n

    # -- observability -------------------------------------------------
    def stat_totals(self) -> Dict[str, object]:
        """Sync and return all accumulated metrics: the device
        accumulator and the host scheduler counters folded through one
        schema-aware merge."""
        host = om.host_counters({
            "steps": self.stats["steps"],
            "admitted": self.stats["admitted"],
            "queued_full": self.stats["queued_full"],
            "rejected": self.stats["rejected"],
            "overflow_retired": self.stats["overflow_retired"],
            "admit_fastpath_hits": self.stats["admit_fastpath_hits"],
            "admit_fastpath_spills": self.stats["admit_fastpath_spills"],
            "fastpath_hits": self.stats["admit_fastpath_hits"],
            "fastpath_spills": self.stats["admit_fastpath_spills"],
            "admit_magazine_spills": self.stats["admit_magazine_spills"],
            "magazine_spills": self.stats["admit_magazine_spills"],
        }, device=self.device)
        acc = dict(self.acc)
        for k in host:
            acc.setdefault(k, torch.zeros((), dtype=I32, device=self.device))
        base = {k: host.get(k, torch.zeros_like(v)) for k, v in acc.items()}
        return om.to_host(om.merge(base, acc))

    def snapshot(self) -> Dict[str, object]:
        """Drain the telemetry plane into the exporter's snapshot format
        (obs/trace_export.py): schema-checked metric totals, the event
        ring's surviving window, the host-phase span log, and the host
        reads by site (`host_reads`, a key the JAX engine's snapshot lacks
        and that both packages' `validate_snapshot` pass).  A deliberate
        host sync: call it at run boundaries."""
        ecfg = self.ecfg
        return {
            "obs_schema": SNAPSHOT_VERSION,
            "source": "jit_engine",
            "config": {
                "num_pages": ecfg.num_pages,
                "page_tokens": ecfg.page_tokens,
                "max_batch": ecfg.max_batch,
                "max_lane_pages": ecfg.max_lane_pages,
                "n_shards": ecfg.n_shards,
                "layout": ecfg.layout,
                "fastpath": ecfg.fastpath,
                "magazines": ecfg.magazines,
                "ring_capacity": ecfg.ring_capacity,
            },
            "metrics": self.stat_totals(),
            "events": oring.drain(self.state.ring),
            "spans": list(self.spans),
            "host_reads": dict(self.host_reads),
        }

    def device_free_pages(self) -> int:
        free = int(pool_free_units(self.ecfg.pool_config(), self.state.trees).sum())
        if self.ecfg.magazines:  # stashed pages are claimable
            free += int(self.state.mag_depth.sum())
        return free

    def device_block_table(self, seq_id: int) -> np.ndarray:
        """Global-page-id table of one running sequence (a host sync)."""
        lane = self._lane_of[seq_id]
        tables = global_tables(self.ecfg, self.state.page_shard, self.state.page_off)
        return tables[lane].cpu().numpy()
