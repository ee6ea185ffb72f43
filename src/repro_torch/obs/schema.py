"""The named-metrics registry (a copy of `repro/obs/schema.py`).

One flat catalogue of `MetricSpec`s (name, kind, unit, paper anchor)
that every producer in the port takes its slot names and, for the
positional kernel stat rows, its slot order from.  The registry is
plain Python; `pack_slots` stacks tensors with torch instead of jnp.
`tests/test_torch_alloc.py` holds the catalogue equal to the JAX one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

KINDS = ("counter", "gauge", "histogram", "derived")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One named observable.

    `paper` anchors the metric to the source-paper observable it
    reproduces (e.g. Fig. 7's per-operation RMW count); empty for
    framework metrics with no paper analogue."""

    name: str
    kind: str
    unit: str = ""
    desc: str = ""
    paper: str = ""
    buckets: Optional[Tuple[int, ...]] = None  # histogram edges (static)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown metric kind {self.kind!r}")
        if (self.kind == "histogram") != (self.buckets is not None):
            raise ValueError(
                f"{self.name}: buckets iff kind == 'histogram'"
            )
        if self.buckets is not None and list(self.buckets) != sorted(
            set(self.buckets)
        ):
            raise ValueError(f"{self.name}: buckets must be sorted, unique")

    @property
    def n_slots(self) -> int:
        """Device slots this metric occupies (histograms: one count per
        bucket plus the overflow bucket)."""
        return 1 if self.buckets is None else len(self.buckets) + 1


def _counter(name, desc, unit="ops", paper=""):
    return MetricSpec(name, "counter", unit, desc, paper)


def _gauge(name, desc, unit="units", paper=""):
    return MetricSpec(name, "gauge", unit, desc, paper)


def _derived(name, desc, unit="", paper=""):
    return MetricSpec(name, "derived", unit, desc, paper)


_SPECS = [
    # -- allocator core (the paper's Fig. 7 ledger) ---------------------
    _counter("rounds", "pool/tree arbitration rounds run", "rounds"),
    _counter("alloc_rounds", "arbitration rounds on the alloc side",
             "rounds"),
    _counter(
        "merged_writes",
        "alloc-side tree words actually written by the merged climb",
        "words",
        paper="Fig. 7 (merged)",
    ),
    _counter(
        "logical_rmws",
        "alloc-side RMWs a per-thread sequential climb would issue "
        "(one CAS per level per winner)",
        "rmws",
        paper="Fig. 7 (logical)",
    ),
    _counter(
        "free_merged_writes",
        "release-side words written by the merged O(depth) sweep",
        "words",
        paper="Fig. 7 (merged, release)",
    ),
    _counter(
        "free_logical_rmws",
        "release-side RMWs of sequential FREENODE/UNMARK climbs",
        "rmws",
        paper="Fig. 7 (logical, release)",
    ),
    _counter("free_writes", "alias of free_merged_writes (legacy rows)",
             "words"),
    _counter("freed", "handles released (junk/double frees excluded)"),
    _counter(
        "overflows",
        "allocations served off their home shard (probe distance > 0)",
    ),
    _counter("probe_overflows",
             "engine allocs served off their home shard"),
    _counter(
        "fastpath_hits",
        "fast-octave allocations served by the O(1) slab claim "
        "(admission + decode combined at the engine level)",
        paper="Blelloch & Wei O(1) front end",
    ),
    _counter("fastpath_spills",
             "fast-octave allocations that fell through to the climb"),
    _counter("admit_fastpath_hits",
             "slab hits on the host-driven admission path only"),
    _counter("admit_fastpath_spills",
             "slab spills on the host-driven admission path only"),
    _counter(
        "magazine_hits",
        "allocations served by a per-lane magazine pop "
        "(zero shared-state RMWs)",
        paper="scalloc span cache / SpeedMalloc local pool",
    ),
    _counter(
        "magazine_spills",
        "pages returned to the shared pool instead of a magazine "
        "(stash drop-through on a full magazine, plus exhaustion "
        "spill-back bursts)",
    ),
    _counter(
        "magazine_refills",
        "pages pre-claimed from the shared pool into magazines by the "
        "batched refill burst (one wavefront per refill, not per page)",
    ),
    _counter("admit_magazine_spills",
             "magazine spill-backs on the host-driven admission path "
             "only (also folded into magazine_spills)"),
    # -- jitted engine per-step metrics --------------------------------
    _counter("alloc_pages", "KV pages claimed in-graph", "pages"),
    _counter("freed_pages", "KV pages released by retirement bursts",
             "pages"),
    _counter("overflow_lanes",
             "lanes retired because page allocation failed", "lanes"),
    _counter("retired", "lanes retired (any reason)", "lanes"),
    _gauge("active_lanes", "lanes still decoding after the step",
           "lanes"),
    _gauge("free_pages", "pool-wide free pages", "pages",
           paper="Fig. 11 (occupancy factor)"),
    _gauge("largest_run",
           "largest allocatable run across shards (fragmentation)",
           "pages"),
    _gauge("free_pages_shard", "per-shard free pages (vector gauge)",
           "pages"),
    MetricSpec(
        "alloc_rounds_hist",
        "histogram",
        "steps",
        "decode steps bucketed by pool rounds-to-completion of their "
        "page-boundary wavefront",
        paper="Fig. 7 (rounds distribution)",
        buckets=(0, 1, 2, 4, 8, 16, 32),
    ),
    MetricSpec(
        "probe_distance_hist",
        "histogram",
        "allocs",
        "engine page allocations bucketed by overflow probe distance "
        "(0 = served on the home shard)",
        buckets=(0, 1, 2, 4, 8),
    ),
    # -- event ring ----------------------------------------------------
    _counter("ring_events", "events pushed into the device ring",
             "events"),
    _counter("ring_dropped",
             "ring events overwritten before a drain (drop-oldest)",
             "events"),
    # -- serving / scheduler counters (host shim + oracle) -------------
    _counter("steps", "decode steps driven", "steps"),
    _counter("admitted", "requests admitted", "requests"),
    _counter("queued_full", "admissions deferred: pool full",
             "requests"),
    _counter("rejected", "requests rejected: exceed geometry",
             "requests"),
    _counter("overflow_retired",
             "sequences retired by in-step alloc overflow", "requests"),
    _counter("tokens_out", "tokens generated", "tokens"),
    _counter("decode_steps", "decode-step clock at completion", "steps"),
    # -- benchmark outcome counters ------------------------------------
    _counter("ok", "requests satisfied in a burst"),
    _counter("ok_final", "requests satisfied at churn end"),
    _counter("demand_units", "units requested by the burst", "units"),
    _counter("rounds_total", "arbitration rounds across the workload",
             "rounds"),
    _counter("churn_allocs", "churn-phase allocations"),
    _counter("unpacked_merged_writes",
             "merged climb words, Unpacked layout", "words",
             paper="§III-D"),
    _counter("unpacked_logical_rmws",
             "logical RMWs, Unpacked layout", "rmws", paper="§III-D"),
    _counter("packed_merged_writes",
             "merged climb words, BunchPacked layout", "words",
             paper="§III-D"),
    _counter("packed_logical_rmws",
             "logical RMWs, BunchPacked layout", "rmws",
             paper="§III-D"),
    _counter("free_merged_per_shard",
             "release merged words, per shard (vector)", "words"),
    _counter("free_logical_per_shard",
             "release logical RMWs, per shard (vector)", "rmws"),
    # -- timing / throughput (host-measured) ---------------------------
    _gauge("seconds", "wall time of the measured section", "s"),
    _gauge("seconds_per_burst", "wall time per burst", "s"),
    _gauge("wall_s", "end-to-end wall time", "s"),
    _gauge("toks_per_s", "tokens per second over the whole run",
           "tok/s"),
    _gauge("steady_toks_per_s",
           "decode throughput over the 10%%-90%% completion window",
           "tok/s"),
    _gauge("p50_latency_steps", "median request sojourn", "steps"),
    _gauge("p99_latency_steps", "p99 request sojourn", "steps"),
    _gauge("p50_latency_s", "median request sojourn", "s"),
    _gauge("p99_latency_s", "p99 request sojourn", "s"),
    # -- derived ratios (host-side summaries) --------------------------
    _derived("free_ratio", "free merged/logical ratio",
             paper="Fig. 7"),
    _derived("merged_per_op", "merged words per operation",
             paper="Fig. 7"),
    _derived("logical_per_alloc", "logical RMWs per allocation",
             paper="Fig. 7"),
    _derived("rmws_per_op",
             "shared-state logical RMWs per alloc/free operation "
             "(alloc + release climbs over total ops; magazine churn "
             "drives this toward zero)", paper="Fig. 7"),
    _derived("merged_writes_per_alloc",
             "merged words per claimed page", paper="Fig. 7"),
    _derived("merged_reduction",
             "unpacked/packed merged-write ratio", paper="§III-D"),
    _derived("state_ratio",
             "packed/unpacked persistent state words", paper="§III-D"),
    _derived("telemetry_overhead",
             "steady throughput telemetry-off / telemetry-on"),
    _derived("jit_host_speedup",
             "jit/host steady decode throughput"),
]

REGISTRY: Dict[str, MetricSpec] = {s.name: s for s in _SPECS}
if len(REGISTRY) != len(_SPECS):  # pragma: no cover - authoring guard
    raise AssertionError("duplicate metric name in the registry")


def spec(name: str) -> MetricSpec:
    """Look up one metric, raising on unregistered names."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unregistered metric {name!r} — add a MetricSpec to "
            "repro/obs/schema.py (the single catalogue every stat row, "
            "engine metric and BENCH_*.json key must come from)"
        ) from None


# ---------------------------------------------------------------------------
# Positional slot orders for the kernel stat rows.
#
# The kernels write fixed-width int32 stat rows; these tuples are the
# ONLY definition of their slot order.  `kernels/nbbs_alloc.py` packs
# rows with `pack_slots` and `kernels/ops.py` / `core/pool.py` unpack
# with `unpack_slots`, so the layout cannot drift between producer and
# consumer.
# ---------------------------------------------------------------------------

# single-tree alloc-only kernel (`wavefront_alloc_pallas`)
WAVEFRONT_ALLOC_SLOTS: Tuple[str, ...] = (
    "rounds", "merged_writes", "logical_rmws",
)

# single-tree mixed free+alloc kernel (`wavefront_step_pallas`)
WAVEFRONT_STEP_SLOTS: Tuple[str, ...] = (
    "rounds", "merged_writes", "logical_rmws",
    "free_merged_writes", "free_logical_rmws", "freed",
)

# pooled grid-over-shards kernel (`pool_wavefront_step_pallas`),
# one row per shard.  The magazine slots are zero in kernel-emitted
# rows (magazines are per-lane state that lives *outside* the per-shard
# VMEM row; the `ops.nbbs_pool_wavefront_step` dispatcher fills them in
# after its claim/stash phases) but they are part of the row so the
# producer and every consumer share one slot order.
POOL_STEP_SLOTS: Tuple[str, ...] = WAVEFRONT_STEP_SLOTS + (
    "fastpath_hits", "magazine_hits", "magazine_spills",
    "magazine_refills",
)

for _slots in (WAVEFRONT_ALLOC_SLOTS, WAVEFRONT_STEP_SLOTS,
               POOL_STEP_SLOTS):
    for _name in _slots:
        spec(_name)  # every slot must be a registered metric


def pack_slots(slots: Tuple[str, ...], values: Dict[str, object]):
    """Stack a stats dict into the positional row the kernel emits
    (torch imported lazily so host tools can import the schema)."""
    import torch

    return torch.stack([torch.as_tensor(values[name]) for name in slots])


def unpack_slots(slots: Tuple[str, ...], row) -> Dict[str, object]:
    """Name the entries of a positional kernel stat row."""
    if int(row.shape[-1]) != len(slots):
        raise ValueError(
            f"stat row width {row.shape[-1]} != {len(slots)} schema "
            f"slots {slots}"
        )
    return {name: row[..., i] for i, name in enumerate(slots)}


# The engine's per-step metric set (obs/metrics.py builds the dict
# pytree from this): name -> static vector length, where None means a
# scalar and "S" means one slot per pool shard (resolved at engine
# build time).  Order is the canonical reporting order.
ENGINE_METRICS: Tuple[str, ...] = (
    "alloc_pages",
    "freed_pages",
    "overflow_lanes",
    "probe_overflows",
    "retired",
    "active_lanes",
    "alloc_rounds",
    "merged_writes",
    "logical_rmws",
    "free_merged_writes",
    "free_logical_rmws",
    "free_pages",
    "largest_run",
    "fastpath_hits",
    "fastpath_spills",
    "magazine_hits",
    "magazine_spills",
    "magazine_refills",
    "free_pages_shard",
    "alloc_rounds_hist",
    "probe_distance_hist",
    "ring_events",
    "ring_dropped",
)

for _name in ENGINE_METRICS:
    spec(_name)
