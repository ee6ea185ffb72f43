"""Deterministic synthetic LM data pipeline.

Counterpart of `repro/data/pipeline.py`: the same stateless, seekable
token stream (numpy only, so a batch equals the JAX package's element
for element), per-host slicing of the global batch, and background
prefetch.  `to_device` moves a batch to one device and `place_on_mesh`
shards it over a mesh's dp axes (DTensors).

Tokens are an order-2 Markov-ish stream derived from a splitmix-style
integer hash, so the tiny-LM example has actual learnable structure
(next token depends on the previous two) while remaining fully
reproducible.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.models.sharding import P, placements


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class SyntheticLM:
    """Deterministic, seekable synthetic token stream."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        structured: bool = True,
    ) -> None:
        if global_batch % process_count:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{process_count} processes")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // process_count
        self.seed = seed
        self.process_index = process_index
        self.structured = structured

    def batch_at(self, step: int) -> dict:
        """Local slice of the global batch for `step` (stateless/seekable)."""
        b0 = self.process_index * self.local_batch
        rows = np.arange(b0, b0 + self.local_batch, dtype=np.uint64)
        cols = np.arange(self.seq_len + 1, dtype=np.uint64)
        base = (
            np.uint64(self.seed) * np.uint64(0x100000001B3)
            + np.uint64(step) * np.uint64(0x9E3779B1)
        )
        grid = _splitmix(base + rows[:, None] * np.uint64(1 << 20) + cols)
        toks = (grid % np.uint64(self.vocab_size)).astype(np.int32)
        if self.structured:
            # next token correlated with the previous two -> learnable
            toks[:, 2:] = (
                toks[:, 2:] // 4 * 4 + (toks[:, :-2] + toks[:, 1:-1]) % 4
            ) % self.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a (possibly device-placing) iterator."""

    def __init__(self, it: Iterator, depth: int = 2, place=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._place = place or (lambda x: x)
        self._it = it
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(self._place(item))
        except BaseException as e:  # surfaced on next()
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays or tensors) as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def place_on_mesh(batch: dict, mesh, dp_axes) -> dict:
    """A host batch (the global batch, the same on every rank) as
    DTensors on `mesh`: the leading dim sharded over the dp axes,
    replicated over the rest."""
    spec = lambda nd: P(dp_axes if len(dp_axes) > 1 else dp_axes[0],
                        *([None] * (nd - 1)))
    return {
        k: distribute_tensor(torch.as_tensor(v).to(mesh.device_type), mesh,
                             placements(spec(np.ndim(v)), mesh))
        for k, v in batch.items()
    }
