"""Baseline allocators the paper compares against (§IV).

Counterpart of `repro/core/baselines.py`, copied line for line (host
code); `tests/test_torch_host_alloc.py` holds both allocators, their
stats and lock counts equal to the originals'.

1. ``SpinlockTreeBuddy`` — the ``1lvl-sl`` configuration of the paper:
   the *same* tree data structure as the non-blocking buddy system, but
   with every operation executed under one global lock.  On this
   substrate (no preemptive threads inside a batched device step) a global lock
   is modelled by its defining property: concurrent requests are admitted
   strictly one at a time.  The wavefront benchmarks therefore charge it
   ``K`` serialized rounds for a batch of ``K`` requests, against the
   handful of arbitration rounds of the non-blocking version — exactly
   the scalability axis of the paper's Figures 8-11.  Lock acquire/release
   costs are additionally instrumented so wall-clock comparisons on the
   host include them.

2. ``FreeListBuddy`` — the Linux-kernel-style buddy allocator (Fig. 12
   comparison): per-order free lists, split-on-alloc, buddy-merge-on-free,
   single lock.  We cannot load a kernel module in this container, so the
   algorithm (as described in Gorman, "Understanding the Linux Virtual
   Memory Manager", ch. 6) is reimplemented in user space.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

from repro_torch.core.ref import NBBSRef, _ilog2


class SpinlockTreeBuddy(NBBSRef):
    """Same tree as NBBS, global-lock discipline (paper's 1lvl-sl)."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.lock_acquisitions = 0

    def nb_alloc(self, size: int, scattered: bool = False) -> Optional[int]:
        self.lock_acquisitions += 1  # lock()
        out = super().nb_alloc(size, scattered=scattered)
        return out  # unlock()

    def nb_free(self, addr: int) -> None:
        self.lock_acquisitions += 1  # lock()
        super().nb_free(addr)  # unlock()


@dataclasses.dataclass
class FreeListStats:
    allocs_ok: int = 0
    allocs_failed: int = 0
    frees: int = 0
    splits: int = 0
    merges: int = 0
    lock_acquisitions: int = 0


class FreeListBuddy:
    """Linux-style multi-list buddy allocator (single global lock).

    State: for every order ``o`` (block of ``min_size * 2**o`` bytes) a
    set of free block start-offsets.  Allocation pops from the smallest
    sufficient order, splitting larger blocks as needed; free re-inserts
    and greedily merges with the buddy while it is also free.
    """

    def __init__(
        self,
        total_memory: int,
        min_size: int,
        max_size: Optional[int] = None,
        base_address: int = 0,
    ) -> None:
        if max_size is None:
            max_size = total_memory
        self.total_memory = total_memory
        self.min_size = min_size
        self.max_size = max_size
        self.base_address = base_address
        self.max_order = _ilog2(total_memory // min_size)
        self.max_alloc_order = _ilog2(max_size // min_size)
        # free_lists[order] = set of unit-offsets of free blocks
        self.free_lists: List[Set[int]] = [set() for _ in range(self.max_order + 1)]
        self.free_lists[self.max_order].add(0)
        self.alloc_order: Dict[int, int] = {}  # unit-offset -> order
        self.stats = FreeListStats()

    def _order_for_size(self, size: int) -> int:
        if size <= self.min_size:
            return 0
        units = (size + self.min_size - 1) // self.min_size
        order = _ilog2(units)
        if (1 << order) < units:
            order += 1
        return order

    def nb_alloc(self, size: int) -> Optional[int]:
        self.stats.lock_acquisitions += 1
        if size > self.max_size:
            self.stats.allocs_failed += 1
            return None
        order = self._order_for_size(max(size, 1))
        # Find the smallest order with a free block.
        o = order
        while o <= self.max_order and not self.free_lists[o]:
            o += 1
        if o > self.max_order:
            self.stats.allocs_failed += 1
            return None
        off = min(self.free_lists[o])  # deterministic pop
        self.free_lists[o].discard(off)
        # Split down to the requested order.
        while o > order:
            o -= 1
            self.free_lists[o].add(off + (1 << o))
            self.stats.splits += 1
        self.alloc_order[off] = order
        self.stats.allocs_ok += 1
        return self.base_address + off * self.min_size

    def nb_free(self, addr: int) -> None:
        self.stats.lock_acquisitions += 1
        off = (addr - self.base_address) // self.min_size
        order = self.alloc_order.pop(off)
        # Merge with the buddy while possible.
        while order < self.max_order:
            buddy = off ^ (1 << order)
            if buddy not in self.free_lists[order]:
                break
            self.free_lists[order].discard(buddy)
            off = min(off, buddy)
            order += 1
            self.stats.merges += 1
        self.free_lists[order].add(off)
        self.stats.frees += 1

    def free_bytes(self) -> int:
        return sum(
            len(s) * (self.min_size << o) for o, s in enumerate(self.free_lists)
        )

    def allocated_ranges(self) -> List[range]:
        out = []
        for off, order in self.alloc_order.items():
            start = self.base_address + off * self.min_size
            out.append(range(start, start + (self.min_size << order)))
        return out
