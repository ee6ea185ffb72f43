"""Paged KV-cache management on the non-blocking buddy system.

Counterpart of `repro/memory/kv_cache.py`, copied line for line (host
Python and numpy); only `device_pool_config` differs: it returns the
port's own `core.pool.PoolConfig`.  `tests/test_torch_kv_cache.py` holds
both classes equal to the originals: block tables, trees, counters.

This is where the paper's contribution becomes a first-class framework
feature: the serving engine's KV page pool is managed by the NBBS
(host-side: the paper-faithful `NBBSRef`; burst admission: the pooled
wavefront, kernel A on the card — the same data structure, so both
views stay coherent).

Design points (docs/design.md §2):
  * a sequence's KV cache is a list of buddy *runs* — power-of-two
    contiguous page spans.  Growth allocates a run of the current run
    size (doubling), so a sequence of T tokens holds O(log T) runs and
    its block table is a concatenation of contiguous id ranges (large
    DMA-friendly spans for the paged-attention kernel);
  * admission control is allocation success: when the buddy cannot
    serve a run, the scheduler queues the request instead of thrashing
    (fragmentation is visible in O(1) through the status-bit tree);
  * frees coalesce automatically (paper §III-C), so long-lived serving
    does not degrade — the property the Constant Occupancy benchmark
    measures;
  * with `n_shards > 1` the page pool is split across S replicated
    buddy trees (the host mirror of `core/pool.py`): a sequence's home
    shard is the Fibonacci hash of its id, admission probes shards in
    the fixed cyclic order home, home+1, …, and the serving shard is
    recorded in `SeqAlloc.shard` so a burst release frees per-shard —
    one `free_round`-equivalent burst per shard, never a cross-shard
    scan.

Invariants (deep-linked from docs/architecture.md):

  * page-id numbering: shard s owns the global page ids
    [s * pages_per_shard, (s+1) * pages_per_shard); each shard's
    `NBBSRef` is constructed with that `base_address`, so every address
    it returns is already a global page id and block tables are
    shard-agnostic;
  * a sequence's runs all live on its recorded shard (`SeqAlloc.shard`)
    — admission probes whole-sequence, growth never migrates — so
    `free_sequence(s)` is exactly one per-shard burst;
  * occupancy encoding inside each shard is the 5-bit status-bit tree
    of `core/bits.py`; occupancy/fragmentation introspection
    (`fragmentation`) is the per-shard O(tree) scan, reported per shard
    and pool-wide;
  * double frees cannot cross shards: a handle resolves through its own
    shard's index[] only (see `core/nbbs.py` for the
    arbitration rule on the device path).

Two host views live here (docs/design.md §8):

  * `PagedKVManager` — the run-granularity manager the host-driven
    `ServeEngine` allocates through (buddy runs, growth by doubling);
  * `PageOracle` — the page-granularity differential oracle of the
    *jit-resident* engine: per-shard `NBBSRef` trees driven through an
    exact host emulation of `core/pool.pool_wavefront_alloc`'s round
    semantics, handing out the same global page ids the device tables
    carry.  The jitted engine must match it bit-for-bit on page
    assignments and pool occupancy (tests/test_serving.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bits import FIB_HASH, OCC, is_free  # host/device routing must agree
from repro_torch.core.ref import NBBSRef, _ilog2


@dataclasses.dataclass
class SeqAlloc:
    seq_id: int
    runs: List[range]          # page-id ranges (global ids), in order
    n_tokens: int = 0
    shard: int = 0             # serving shard: all runs live here

    @property
    def n_pages(self) -> int:
        return sum(len(r) for r in self.runs)


class PagedKVManager:
    """Page-granularity KV allocator for the serving engine."""

    def __init__(
        self,
        num_pages: int,
        page_tokens: int,
        max_run_pages: Optional[int] = None,
        scattered: bool = True,
        n_shards: int = 1,
        layout: Optional[str] = None,
        fastpath: bool = False,
        fastpath_slab_level: int = 2,
        magazines: int = 0,
        magazine_refill: int = 0,
        mag_lanes: int = 16,
    ) -> None:
        if num_pages & (num_pages - 1):
            raise ValueError("num_pages must be a power of two")
        if n_shards < 1 or (n_shards & (n_shards - 1)):
            raise ValueError("n_shards must be a power of two >= 1")
        if num_pages % n_shards:
            raise ValueError("num_pages must divide evenly across shards")
        if layout not in (None, "unpacked", "bunch-packed"):
            raise ValueError(f"unknown tree layout {layout!r}")
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        self.n_shards = n_shards
        # Device tree-state layout for the wavefront-backed admission
        # path (docs/design.md §3).  The host-side NBBSRef trees below
        # are layout-independent; this knob only shapes what
        # `device_pool_config()` exports, so handles — (shard, page id)
        # pairs — and the whole public API are unchanged.
        self.layout = layout or "unpacked"
        self.pages_per_shard = num_pages // n_shards
        self.max_run_pages = min(
            max_run_pages or num_pages, self.pages_per_shard
        )
        self.scattered = scattered
        # One allocation unit == one page; shard s serves global ids
        # [s * pages_per_shard, (s+1) * pages_per_shard) via base_address.
        self.buddies = [
            NBBSRef(
                self.pages_per_shard,
                1,
                max_size=self.max_run_pages,
                base_address=s * self.pages_per_shard,
            )
            for s in range(n_shards)
        ]
        # Per-lane magazines (host mirror of core/magazine.py): a
        # sequence group (`seq_id % mag_lanes`) keeps a small LIFO of
        # recently freed single pages and recycles them without
        # touching the slab or the tree.  Because this manager's
        # invariant is "a sequence's runs all live on its recorded
        # shard", the host magazines are *shard-local* stacks —
        # `_mags[lane][shard]`, capacity `magazines` each — a benign
        # divergence from the device's flat per-lane magazine
        # (docs/design.md §10): a cross-shard pop would migrate a run
        # off the sequence's shard.
        if magazines < 0 or magazine_refill < 0 or mag_lanes < 1:
            raise ValueError("bad magazine configuration")
        self.magazines = magazines
        self.magazine_refill = magazine_refill
        self.mag_lanes = mag_lanes
        self.magazine_hits = 0
        self.magazine_spills = 0
        self.magazine_refills = 0
        self._mags: List[List[List[int]]] = [
            [[] for _ in range(n_shards)] for _ in range(mag_lanes)
        ]
        # Fixed-size fast path (host mirror of core/fastpath.py): the
        # leftmost 1/2^slab_level of each shard is carved out of its
        # buddy tree at init and served as single pages from a bitmap.
        # Single-page runs claim a slab slot first and spill into the
        # buddy only when the slab is full; frees route by page-id
        # range.  Handles stay ordinary global page ids throughout.
        self.fastpath = fastpath
        self.fastpath_slab_level = fastpath_slab_level
        self.fastpath_hits = 0
        self.fastpath_spills = 0
        self._slab_free: List[np.ndarray] = []
        if fastpath:
            slab_pages = self.pages_per_shard >> fastpath_slab_level
            if slab_pages < 1:
                raise ValueError(
                    "fastpath slab_level too deep for "
                    f"{self.pages_per_shard} pages per shard"
                )
            self.slab_pages = slab_pages
            for s, buddy in enumerate(self.buddies):
                base = s * self.pages_per_shard
                got = 0
                while got < slab_pages:  # carve leftmost, contiguous
                    run = min(self.max_run_pages, slab_pages - got)
                    addr = buddy.nb_alloc(run, scattered=False)
                    assert addr == base + got, "carve must be leftmost"
                    got += run
                self._slab_free.append(np.ones(slab_pages, bool))
            self.device_pool_config()  # fail fast on bad slab geometry
        else:
            self.slab_pages = 0
        self.seqs: Dict[int, SeqAlloc] = {}

    def mag_lane(self, seq_id: int) -> int:
        """Magazine lane of a sequence (-1 with magazines off)."""
        return seq_id % self.mag_lanes if self.magazines else -1

    def mag_stashed(self) -> int:
        """Pages currently held across every magazine."""
        return sum(
            len(st) for lane in self._mags for st in lane
        )

    def _mag_spill_all(self) -> None:
        """Release every stashed page back to its shard (slab/tree
        routing) and empty the magazines — the host mirror of the
        pool's exhaustion spill-back burst."""
        for lane in self._mags:
            for s, stack in enumerate(lane):
                for p in stack:
                    self.magazine_spills += 1
                    local = p - s * self.pages_per_shard
                    if (
                        self.fastpath
                        and 0 <= local < self.slab_pages
                    ):
                        self._slab_free[s][local] = True
                    else:
                        self.buddies[s].nb_free(p)
                stack.clear()

    @property
    def buddy(self) -> NBBSRef:
        """The single tree of an unsharded pool (back-compat accessor)."""
        assert self.n_shards == 1, "sharded pool: use .buddies[s]"
        return self.buddies[0]

    def device_pool_config(self):
        """The device-side `core.pool.PoolConfig` mirroring this pool's
        geometry: S shards of a depth-log2(pages_per_shard) tree, one
        allocation unit per page, with the configured tree-state layout
        (`layout="bunch-packed"` gives the §III-D packed words — ~1/7
        the VMEM words, ~B x fewer climb writes; see `core/layout.py`).
        Burst admission through `core.nbbs.nb_pool_alloc` /
        `kernels.ops.nbbs_pool_wavefront_step` (kernel A on the card) on
        this config produces the same (shard, page) handles this host
        manager hands out."""
        from repro_torch.core.concurrent import BUNCH_PACKED, TreeConfig, UNPACKED
        from repro_torch.core.fastpath import FastPathConfig
        from repro_torch.core.pool import PoolConfig

        tree = TreeConfig(
            depth=_ilog2(self.pages_per_shard),
            max_level=_ilog2(self.pages_per_shard // self.max_run_pages),
            layout=(
                BUNCH_PACKED if self.layout == "bunch-packed" else UNPACKED
            ),
        )
        fp = (
            FastPathConfig(level=None, slab_level=self.fastpath_slab_level)
            if self.fastpath
            else None
        )
        mcfg = None
        if self.magazines:
            from repro_torch.core.magazine import MagazineConfig

            mcfg = MagazineConfig(
                mag_cap=self.magazines,
                refill_batch=self.magazine_refill,
            )
        return PoolConfig(tree, self.n_shards, fastpath=fp, magazines=mcfg)

    # ------------------------------------------------------------------
    def home_shard(self, seq_id: int) -> int:
        """Deterministic home shard of a sequence (Fibonacci hash, the
        same spread as `core/pool.home_shard` for device lanes)."""
        return ((seq_id * FIB_HASH) & 0xFFFFFFFF) % self.n_shards

    def pages_for_tokens(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_tokens))

    def _next_pow2(self, n: int) -> int:
        return 1 << (n - 1).bit_length()

    def _alloc_run(
        self, shard: int, run: int, mag_lane: int = -1
    ) -> Optional[range]:
        """One run on one shard: single-page runs pop the requester's
        magazine first (pure recycling, zero allocator work), then
        probe the fastpath slab, then take the buddy climb."""
        if self.magazines and run == 1 and mag_lane >= 0:
            stack = self._mags[mag_lane][shard]
            if not stack and self.magazine_refill:
                # Batched refill: pre-claim a burst of single pages
                # into the magazine so the next misses become pops
                # (one burst per refill, not one climb per page).
                room = min(
                    self.magazine_refill, self.magazines - len(stack)
                )
                for _ in range(room):
                    rr = self._alloc_run_raw(shard, 1)
                    if rr is None:
                        break
                    stack.append(rr.start)
                    self.magazine_refills += 1
            if stack:
                self.magazine_hits += 1
                page = stack.pop()
                return range(page, page + 1)
        return self._alloc_run_raw(shard, run)

    def _alloc_run_raw(self, shard: int, run: int) -> Optional[range]:
        """The magazine-oblivious slab-then-buddy path."""
        if self.fastpath and run == 1:
            free = np.flatnonzero(self._slab_free[shard])
            if len(free):
                slot = int(free[0])
                self._slab_free[shard][slot] = False
                self.fastpath_hits += 1
                page = shard * self.pages_per_shard + slot
                return range(page, page + 1)
            self.fastpath_spills += 1
        addr = self.buddies[shard].nb_alloc(run, scattered=self.scattered)
        if addr is None:
            return None
        return range(addr, addr + run)

    def _maybe_stash(self, shard: int, r: range, mag_lane: int) -> bool:
        """Try to park a single-page run in the requester's magazine
        instead of releasing it.  True = stashed (the page stays
        allocated in the slab/tree and is owned by the magazine); a
        full magazine counts a drop-through spill and falls back to
        the ordinary release routing."""
        if not self.magazines or mag_lane < 0 or len(r) != 1:
            return False
        stack = self._mags[mag_lane][shard]
        if len(stack) < self.magazines:
            stack.append(r.start)
            return True
        self.magazine_spills += 1
        return False

    def _free_run(self, shard: int, r: range, mag_lane: int = -1) -> None:
        """Release one run, routing by page-id range: single-page runs
        stash into the requester's magazine when there is room, pages
        under the shard's slab clear their bitmap bit, the rest free
        through the buddy (the host mirror of `pool_free_round_mag`'s
        stash-then-route)."""
        if self._maybe_stash(shard, r, mag_lane):
            return
        local = r.start - shard * self.pages_per_shard
        if self.fastpath and len(r) == 1 and 0 <= local < self.slab_pages:
            self._slab_free[shard][local] = True
            return
        self.buddies[shard].nb_free(r.start)

    def _try_admit_on(
        self, shard: int, need: int, mag_lane: int = -1
    ) -> Optional[List[range]]:
        """Allocate `need` pages worth of runs on one shard, or roll back
        and return None (an admission is all-on-one-shard or nothing).
        Rolled-back magazine-claimed pages go back to the *same lane's*
        magazine, leaving the tree untouched by the failed attempt."""
        runs: List[range] = []
        remaining = need
        while remaining:
            run = min(remaining, self.max_run_pages)
            r = self._alloc_run(shard, run, mag_lane)
            if r is None:
                for old in runs:  # roll back partial admission
                    self._free_run(shard, old, mag_lane)
                return None
            runs.append(r)
            remaining -= run
        return runs

    def add_sequence(self, seq_id: int, n_tokens: int) -> bool:
        """Admit a sequence with a prompt of n_tokens. False = pool full
        (the scheduler should queue/evict — admission control).

        Probes shards in the fixed order home, home+1, …, home+S-1: the
        first shard that can hold the whole sequence serves it (overflow
        routing, mirroring `core/pool.py`)."""
        assert seq_id not in self.seqs
        need = self._next_pow2(self.pages_for_tokens(max(n_tokens, 1)))
        if need > self.pages_per_shard:
            # Not "pool full" — the request exceeds the pool geometry
            # and no amount of waiting or probing can ever admit it.
            # Raising (instead of returning False) keeps an impossible
            # request from head-of-line blocking the scheduler forever.
            raise ValueError(
                f"sequence needs {need} pages but a shard holds only "
                f"{self.pages_per_shard} (num_pages={self.num_pages}, "
                f"n_shards={self.n_shards})"
            )
        home = self.home_shard(seq_id)
        lane = self.mag_lane(seq_id)
        for spill in range(2):
            for attempt in range(self.n_shards):
                shard = (home + attempt) % self.n_shards
                runs = self._try_admit_on(shard, need, lane)
                if runs is not None:
                    self.seqs[seq_id] = SeqAlloc(
                        seq_id, runs, n_tokens, shard=shard
                    )
                    return True
            # Every probe failed: pages parked in magazines may be the
            # only free capacity left.  Spill them all back (one burst)
            # and retry the probe sequence once — the host mirror of
            # the wavefront's exhaustion spill-back.
            if spill or not self.magazines or not self.mag_stashed():
                return False
            self._mag_spill_all()
        return False

    def append_tokens(self, seq_id: int, n_new: int = 1) -> bool:
        """Reserve space for n_new more tokens; grows by buddy doubling
        on the sequence's recorded shard (runs never migrate shards).
        On failure the sequence is left exactly as before the call: both
        n_tokens and any runs grown by earlier loop iterations are rolled
        back (a partially grown sequence would silently leak pages the
        token count never accounts for)."""
        s = self.seqs[seq_id]
        lane = self.mag_lane(seq_id)
        n_runs_before = len(s.runs)
        s.n_tokens += n_new
        while self.pages_for_tokens(s.n_tokens) > s.n_pages:
            grow = min(self._next_pow2(max(s.n_pages, 1)), self.max_run_pages)
            r = self._alloc_run(s.shard, grow, lane)
            if r is None:
                s.n_tokens -= n_new
                grown = s.runs[n_runs_before:]
                del s.runs[n_runs_before:]
                # Roll back to the *same lane's* magazine: a page that
                # was claimed from this sequence's magazine moments ago
                # must land back on it, not leak into the shared pool
                # (which would silently drain the lane's cache and
                # change the tree state of a failed, no-op call).
                self._free_runs(s.shard, grown, lane)
                return False
            s.runs.append(r)
        return True

    def _free_runs(
        self, shard: int, runs: List[range], mag_lane: int = -1
    ) -> None:
        """Release a burst of runs on one shard: single-page runs stash
        into the lane's magazine while it has room, slab pages clear
        their bitmap bits, the rest go back in one merged buddy burst."""
        buddy_addrs: List[int] = []
        for r in runs:
            if self._maybe_stash(shard, r, mag_lane):
                continue
            local = r.start - shard * self.pages_per_shard
            if (
                self.fastpath
                and len(r) == 1
                and 0 <= local < self.slab_pages
            ):
                self._slab_free[shard][local] = True
            else:
                buddy_addrs.append(r.start)
        if buddy_addrs:
            self.buddies[shard].nb_free_many(buddy_addrs)

    def free_sequence(self, seq_id: int) -> None:
        """Release a sequence: all of its runs go back in one burst call
        on its shard (one merged release pass on wavefront-backed pools);
        single-page runs recycle through the sequence's magazine lane."""
        s = self.seqs.pop(seq_id)
        self._free_runs(s.shard, s.runs, self.mag_lane(seq_id))

    def free_sequences(self, seq_ids: List[int]) -> None:
        """Batch eviction: release every run of every sequence, grouped
        by shard so each shard gets a single burst (one `free_round`
        each on wavefront-backed pools).  Validates the whole batch
        before mutating any state so an unknown id cannot strand
        already-popped sequences' pages."""
        unique = list(dict.fromkeys(seq_ids))
        missing = [i for i in unique if i not in self.seqs]
        if missing:
            raise KeyError(missing[0])
        per_shard: Dict[int, List[Tuple[range, int]]] = {}
        for seq_id in unique:
            s = self.seqs.pop(seq_id)
            lane = self.mag_lane(seq_id)
            per_shard.setdefault(s.shard, []).extend(
                (r, lane) for r in s.runs
            )
        for shard, pairs in per_shard.items():
            buddy_addrs: List[int] = []
            for r, lane in pairs:
                if self._maybe_stash(shard, r, lane):
                    continue
                local = r.start - shard * self.pages_per_shard
                if (
                    self.fastpath
                    and len(r) == 1
                    and 0 <= local < self.slab_pages
                ):
                    self._slab_free[shard][local] = True
                else:
                    buddy_addrs.append(r.start)
            if buddy_addrs:
                self.buddies[shard].nb_free_many(buddy_addrs)

    # ------------------------------------------------------------------
    def block_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        """Flat page-id table, -1 padded, for the paged-attention kernel.
        Ids are global (shard base already folded in by `base_address`)."""
        s = self.seqs[seq_id]
        ids = [p for r in s.runs for p in r]
        used = self.pages_for_tokens(s.n_tokens)
        ids = ids[: max(used, 1)]
        out = np.full((max_pages,), -1, np.int32)
        out[: len(ids)] = ids
        return out

    def block_tables(self, seq_ids: List[int], max_pages: int) -> np.ndarray:
        return np.stack([self.block_table(s, max_pages) for s in seq_ids])

    # ------------------------------------------------------------------
    def free_pages(self) -> int:
        """Allocatable pages: slab + tree + magazine-stashed (a stashed
        page is allocated in the tree's eyes but instantly claimable,
        so capacity accounting must count it as free)."""
        slab = sum(int(f.sum()) for f in self._slab_free)
        return (
            slab
            + sum(b.free_bytes() for b in self.buddies)
            + self.mag_stashed()
        )

    def _mag_stashed_on(self, shard: int) -> int:
        return sum(len(lane[shard]) for lane in self._mags)

    def _largest_run_on(self, shard: int) -> int:
        best = _largest_free_run(self.buddies[shard], self.max_run_pages)
        if self.fastpath and self._slab_free[shard].any():
            best = max(best, 1)  # slab serves single pages only
        if self._mag_stashed_on(shard):
            best = max(best, 1)  # magazines serve single pages only
        return best

    def fragmentation(self) -> dict:
        """Occupancy + largest allocatable run (O(tree) introspection),
        pool-wide plus the per-shard breakdown."""
        free = self.free_pages()
        per_shard_largest = [
            self._largest_run_on(s) for s in range(self.n_shards)
        ]
        per_shard_free = [b.free_bytes() for b in self.buddies]
        if self.fastpath:
            per_shard_free = [
                n + int(f.sum())
                for n, f in zip(per_shard_free, self._slab_free)
            ]
        per_shard_free = [
            n + self._mag_stashed_on(s)
            for s, n in enumerate(per_shard_free)
        ]
        return {
            "free_pages": free,
            "used_pages": self.num_pages - free,
            "largest_run": max(per_shard_largest),
            "n_seqs": len(self.seqs),
            "runs_per_seq": (
                float(np.mean([len(s.runs) for s in self.seqs.values()]))
                if self.seqs
                else 0.0
            ),
            "per_shard_free": per_shard_free,
            "per_shard_largest_run": per_shard_largest,
            "fastpath_hits": self.fastpath_hits,
            "fastpath_spills": self.fastpath_spills,
            "magazine_hits": self.magazine_hits,
            "magazine_spills": self.magazine_spills,
            "magazine_refills": self.magazine_refills,
            "magazine_stashed": self.mag_stashed(),
        }

    def _occupied_ancestor(self, buddy: NBBSRef, n: int) -> bool:
        return _occupied_ancestor(buddy, n)


def _occupied_ancestor(buddy: NBBSRef, n: int) -> bool:
    n >>= 1
    while n >= 1:
        if buddy.tree[n] & OCC:
            return True
        n >>= 1
    return False


def _largest_free_run(buddy: NBBSRef, max_probe: int) -> int:
    """Largest allocatable run on one tree (non-destructive probe)."""
    probe = max_probe
    while probe >= 1:
        level = buddy.level_for_size(probe)
        base = 1 << level
        if any(
            is_free(buddy.tree[i]) and not _occupied_ancestor(buddy, i)
            for i in range(base, 2 * base)
        ):
            return probe
        probe //= 2
    return 0


# ---------------------------------------------------------------------------
# PageOracle: host differential oracle of the jit-resident engine pool
# ---------------------------------------------------------------------------


class PageOracle:
    """Leaf-only page allocator mirroring the jitted engine's in-graph
    pool, page by page.

    The jit-resident engine (`serve/jit_engine.py`) claims KV pages one
    leaf unit at a time through `pool_wavefront_alloc`.  This class
    drives per-shard `NBBSRef` trees through an *exact* host emulation
    of those pool rounds, so a host-driven replay of the same request
    trace must produce identical page ids and identical final trees:

      * each request's home shard is the Fibonacci hash of its lane id
        (`home_shard`, shared constant with `core/pool.py`);
      * per round, per shard, the routed requests allocate sequentially
        in lane order with first-fit leaf scans (`scattered=False`) —
        equivalent to the device round's rank/prefix-sum assignment,
        because allocating the rank-r allocatable leaf never changes the
        allocatability of leaves ranked above it;
      * a shard whose *first* attempted allocation of the round fails
        had zero allocatable leaves at round start — the device round's
        `exhausted` condition — so every request routed there advances
        its probe (`shard+1`, cyclic), failing after S probes.  A
        request that fails *after* wins on its shard merely lost
        arbitration and retries the same shard next round;
      * releases are burst frees grouped per shard (`nb_free_many`),
        the host mirror of `pool_free_round`.

    Page ids are global (`base_address` folds the shard base in), the
    same numbering the engine's device block tables carry.
    """

    def __init__(
        self,
        num_pages: int,
        page_tokens: int,
        n_shards: int = 1,
        max_rounds: int = 64,
        fastpath: bool = False,
        fastpath_slab_level: int = 2,
        magazines: int = 0,
        mag_lanes: int = 0,
    ) -> None:
        if num_pages & (num_pages - 1):
            raise ValueError("num_pages must be a power of two")
        if n_shards < 1 or (n_shards & (n_shards - 1)):
            raise ValueError("n_shards must be a power of two >= 1")
        if num_pages % n_shards:
            raise ValueError("num_pages must divide evenly across shards")
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        self.n_shards = n_shards
        self.max_rounds = max_rounds
        self.pages_per_shard = num_pages // n_shards
        self.buddies = [
            NBBSRef(
                self.pages_per_shard,
                1,
                max_size=self.pages_per_shard,
                base_address=s * self.pages_per_shard,
            )
            for s in range(n_shards)
        ]
        # Fastpath mirror (core/fastpath.py): the leftmost
        # 1/2^slab_level of each shard is carved out of its tree at init
        # and served from a find-first-zero bitmap.  Every page request
        # probes the slab of its *current* shard before the tree scan —
        # the host linearization of the device round's slab claim, exact
        # because the claim's rank order over free slots equals lane
        # order and a slab page's id equals the leaf it replaced.
        self.fastpath = fastpath
        self.fastpath_slab_level = fastpath_slab_level
        self.fastpath_hits = 0
        self.fastpath_spills = 0
        self._slab_free: List[np.ndarray] = []
        if fastpath:
            slab_pages = self.pages_per_shard >> fastpath_slab_level
            if slab_pages < 1 or fastpath_slab_level < 1:
                raise ValueError(
                    "fastpath slab_level must carve a proper subtree of "
                    f"{self.pages_per_shard} pages per shard"
                )
            self.slab_pages = slab_pages
            for s, buddy in enumerate(self.buddies):
                addr = buddy.nb_alloc(slab_pages, scattered=False)
                assert addr == s * self.pages_per_shard, "carve is leftmost"
                self._slab_free.append(np.ones(slab_pages, bool))
        else:
            self.slab_pages = 0
        # Magazine mirror (core/magazine.py): per-lane LIFO stacks of
        # stashed global page ids.  A stashed page stays allocated in
        # the slab/tree; the stack end is the magazine top, so
        # list.pop()/append() in lane order reproduce the device
        # claim/stash rank assignment exactly.
        if magazines < 0 or mag_lanes < 0:
            raise ValueError("bad magazine configuration")
        self.magazines = magazines
        self.mag: List[List[int]] = [[] for _ in range(mag_lanes)]
        self.magazine_hits = 0
        self.magazine_spills = 0
        self.magazine_refills = 0

    def home_shard(self, lane_id: int) -> int:
        return ((lane_id * FIB_HASH) & 0xFFFFFFFF) % self.n_shards

    def mag_stashed(self) -> int:
        return sum(len(m) for m in self.mag)

    def _page_owned(self, page: int) -> bool:
        """The stash-phase ownership predicate: a page may be parked in
        a magazine only if the pool currently considers it allocated —
        its slab bit is claimed, or its tree leaf carries OCC (exactly
        the validity tests `slab_release`/`free_round` would apply)."""
        s = page // self.pages_per_shard
        local = page - s * self.pages_per_shard
        if self.fastpath and local < self.slab_pages:
            return not bool(self._slab_free[s][local])
        return bool(self.buddies[s].tree[self.pages_per_shard + local] & OCC)

    def _spill_all_magazines(self) -> int:
        """Release every stashed page back to the slab/tree, one merged
        burst per shard (the exhaustion spill-back), and empty the
        magazines.  Returns the number of pages spilled."""
        pages = [p for m in self.mag for p in m]
        for m in self.mag:
            m.clear()
        if pages:
            self.magazine_spills += len(pages)
            self.free_burst(pages)
        return len(pages)

    def alloc_wavefront(
        self, requests, mag_lanes=None
    ) -> Dict[int, Optional[int]]:
        """Emulate one `pool_wavefront_alloc` over `requests`, a list of
        (key, lane_id) pairs **in device lane order**.  Returns
        key -> global page id (None = failed after probing S shards).

        `mag_lanes` (parallel to `requests`; None or -1 entries opt
        out) routes each request through a magazine pop first — the
        device claim phase: pops resolve in lane order before any round
        runs, cost zero shared-state RMWs, and never count as overflow
        probes.  If every shard probe fails while magazines still hold
        pages, the whole stash spills back in one burst and the failed
        requests retry once from their home shards (the wavefront's
        exhaustion spill-back)."""
        out: Dict[int, Optional[int]] = {k: None for k, _ in requests}
        lanes = (
            list(mag_lanes)
            if mag_lanes is not None
            else [-1] * len(requests)
        )
        mag_claims = 0
        pend = []
        for (k, lid), ml in zip(requests, lanes):
            if (
                self.magazines
                and ml is not None
                and 0 <= ml < len(self.mag)
                and self.mag[ml]
            ):
                out[k] = self.mag[ml].pop()
                self.magazine_hits += 1
                mag_claims += 1
            else:
                pend.append((k, lid, self.home_shard(lid), 0))
        call_hits, failed = self._run_rounds(pend, out)
        if failed and self.magazines and self.mag_stashed():
            self._spill_all_magazines()
            retry = [
                (k, lid, self.home_shard(lid), 0) for k, lid in failed
            ]
            hits2, _ = self._run_rounds(retry, out)
            call_hits += hits2
        if self.fastpath:
            # device spill accounting: every fast-octave request that was
            # not served by a magazine pop or a slab claim — including
            # outright failures
            self.fastpath_spills += len(requests) - mag_claims - call_hits
        return out

    def _run_rounds(self, pend, out):
        """The round loop shared by the first pass and the post-spill
        retry.  Mutates `out` in place; returns (slab call hits, list
        of (key, lane_id) that failed after probing every shard)."""
        call_hits = 0
        failed: List[tuple] = []
        for _ in range(self.max_rounds):
            if not pend:
                break
            nxt = []
            for s in range(self.n_shards):
                entries = [e for e in pend if e[2] == s]
                if not entries:
                    continue
                exhausted = False
                won = 0
                for idx, (k, lid, sh, att) in enumerate(entries):
                    if exhausted:
                        # the slab was already empty when the tree ran
                        # dry (it serves the lane-order prefix first),
                        # so post-exhaustion entries skip both paths
                        if att + 1 < self.n_shards:
                            nxt.append(
                                (k, lid, (sh + 1) % self.n_shards, att + 1)
                            )
                        else:  # probed every shard: give up
                            failed.append((k, lid))
                        continue
                    if self.fastpath:
                        free = np.flatnonzero(self._slab_free[s])
                        if len(free):
                            slot = int(free[0])
                            self._slab_free[s][slot] = False
                            self.fastpath_hits += 1
                            call_hits += 1
                            out[k] = s * self.pages_per_shard + slot
                            continue
                    addr = self.buddies[s].nb_alloc(1, scattered=False)
                    if addr is not None:
                        out[k] = addr
                        won += 1
                    elif won:
                        # lost arbitration (rank >= cnt): the shard still
                        # had pages this round, so stay and retry it
                        nxt.extend(entries[idx:])
                        break
                    else:
                        exhausted = True
                        if att + 1 < self.n_shards:
                            nxt.append(
                                (k, lid, (sh + 1) % self.n_shards, att + 1)
                            )
                        else:
                            failed.append((k, lid))
            pend = nxt
        return call_hits, failed

    def free_burst(self, pages, stash_lanes=None) -> None:
        """Release global page ids, one merged burst per shard (the
        host mirror of the engine's in-graph `pool_free_round`).  With
        the fastpath on, ids under a shard's slab set their bitmap bit
        instead — a double free of a slab page is a silent no-op, the
        mirror of `slab_release`'s validity mask.

        `stash_lanes` (parallel to `pages`; None or -1 entries opt out)
        runs the device stash pre-pass first: the *first* occurrence of
        a page in the burst may park in its lane's magazine if the pool
        still owns the page and the magazine has room; every later
        occurrence of a stashed page is dropped from the burst (the
        device kills duplicates of stashed pages before the free
        round), and a full magazine counts a drop-through spill."""
        pages = list(pages)
        lanes = (
            list(stash_lanes)
            if stash_lanes is not None
            else [-1] * len(pages)
        )
        per_shard: Dict[int, List[int]] = {}
        first_seen: set = set()
        stashed: set = set()
        for p, ml in zip(pages, lanes):
            if p in stashed:
                continue  # duplicate of a stashed page: killed
            if (
                self.magazines
                and ml is not None
                and 0 <= ml < len(self.mag)
                and p not in first_seen
            ):
                first_seen.add(p)
                if self._page_owned(p):
                    if len(self.mag[ml]) < self.magazines:
                        self.mag[ml].append(p)
                        stashed.add(p)
                        continue
                    self.magazine_spills += 1
            else:
                first_seen.add(p)
            s = p // self.pages_per_shard
            local = p - s * self.pages_per_shard
            if self.fastpath and local < self.slab_pages:
                self._slab_free[s][local] = True
            else:
                per_shard.setdefault(s, []).append(p)
        for s, addrs in per_shard.items():
            self.buddies[s].nb_free_many(addrs)

    # -- occupancy ----------------------------------------------------
    def free_pages(self) -> int:
        slab = sum(int(f.sum()) for f in self._slab_free)
        return (
            slab
            + sum(b.free_bytes() for b in self.buddies)
            + self.mag_stashed()
        )

    def per_shard_free(self) -> List[int]:
        out = [b.free_bytes() for b in self.buddies]
        if self.fastpath:
            out = [n + int(f.sum()) for n, f in zip(out, self._slab_free)]
        for m in self.mag:
            for p in m:
                out[p // self.pages_per_shard] += 1
        return out

    def fragmentation(self) -> dict:
        per_shard_largest = [
            _largest_free_run(b, self.pages_per_shard) for b in self.buddies
        ]
        if self.fastpath:
            per_shard_largest = [
                max(n, 1) if f.any() else n
                for n, f in zip(per_shard_largest, self._slab_free)
            ]
        for m in self.mag:
            for p in m:  # a stashed page is claimable as a 1-run
                s = p // self.pages_per_shard
                per_shard_largest[s] = max(per_shard_largest[s], 1)
        free = self.free_pages()
        return {
            "free_pages": free,
            "used_pages": self.num_pages - free,
            "largest_run": max(per_shard_largest),
            "per_shard_free": self.per_shard_free(),
            "per_shard_largest_run": per_shard_largest,
        }

    def check_invariants(self) -> None:
        for b in self.buddies:
            b.check_invariants()
