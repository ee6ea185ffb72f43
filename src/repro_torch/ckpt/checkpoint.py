"""Async, atomic checkpointing.

Counterpart of `repro/ckpt/checkpoint.py`, in the same on-disk format,
so either package restores the other's checkpoints:
  <dir>/step_<N>/
    manifest.json   — tree structure, per-leaf file/shape/dtype/crc32,
                      step, wall time
    leaf_<i>.npy    — one array per leaf (np.save), in `jax.tree_util`'s
                      flattening order (`repro_torch.tree_util`)

Write protocol: everything lands in `step_<N>.tmp/` first and the
directory is renamed on completion, so `latest_step` only ever sees
complete checkpoints (the restart path of `runtime.supervisor`).

Async: `save()` copies every leaf to host memory synchronously (the
trainer updates its state in place, so step N+1 must not run before
step N's snapshot is taken), then hands file I/O to a background
thread.  A full-width train state is tens of GB, so leaves are written
and read by `IO_THREADS` threads at once (zlib's checksum and file I/O
run outside the interpreter lock), each file's crc32 is taken from its
bytes as they are written, and a restore reads each file once.  numpy
has no bfloat16: a bfloat16 leaf is refused, not widened.  `restore`
places each leaf on the device of the matching leaf of `like`, in the
dtype the file holds.

Sharded trees and elastic restore: a DTensor leaf is saved as its
global array (`full_tensor()`, a collective: every rank gathers the
leaves in the same order, on the calling thread, and only rank 0
writes; the writer thread runs no collective).  `restore(...,
shardings=...)` places each leaf by a matching tree of
`models.sharding.NamedSharding` (a mesh and a spec), so restarting on
another mesh is the same code path as a same-mesh restart.  With more
than one rank, `latest_step` waits at a barrier first, so that every
rank sees the checkpoints rank 0 has finished.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import io
import json
import os
import shutil
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.sharding import placements
from repro_torch.tree_util import flatten

IO_THREADS = 4


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf cannot be checkpointed: numpy has no "
                            "bfloat16 (keep the train state's leaves in float32)")
        if isinstance(x, DTensor):
            x = x.full_tensor()
        # a copy even of a CPU tensor: the trainer updates it in place
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


class _CrcWriter:
    """A file that keeps the crc32 of the bytes written to it."""

    def __init__(self, f):
        self._f, self.crc = f, 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        return self._f.write(b)


def _write_leaf(path: str, leaf: np.ndarray) -> int:
    """np.save's bytes; returns their crc32."""
    with open(path, "wb") as f:
        w = _CrcWriter(f)
        np.lib.format.write_array(w, leaf)
    return w.crc


def _multi_rank() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _read_leaf(path: str, crc32: Optional[int]) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if crc32 is not None and zlib.crc32(data) != crc32:
        raise IOError(f"checksum mismatch in {path}")
    return np.load(io.BytesIO(data))


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_io: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1)
            if self.async_io
            else None
        )
        self._pending: Optional[concurrent.futures.Future] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> None:
        """Snapshot now, write in background (if async)."""
        self.wait()  # one in flight at a time
        leaves, treedef = flatten(tree)
        host_leaves = [_to_host(x) for x in leaves]
        if _multi_rank() and dist.get_rank() != 0:
            return
        if self._pool is not None:
            self._pending = self._pool.submit(
                self._write, step, host_leaves, str(treedef)
            )
        else:
            self._write(step, host_leaves, str(treedef))

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, leaves, treedef_str: str) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "time": time.time(),
            "treedef": treedef_str,
            "leaves": [],
        }
        names = [f"leaf_{i:05d}.npy" for i in range(len(leaves))]
        with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as pool:
            crcs = list(pool.map(_write_leaf, [os.path.join(tmp, n) for n in names],
                                 leaves))
        for fname, leaf, crc in zip(names, leaves, crcs):
            manifest["leaves"].append(
                {
                    "file": fname,
                    "shape": list(leaf.shape),
                    "dtype": str(leaf.dtype),
                    "crc32": crc,
                }
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        if _multi_rank():
            self.wait()
            dist.barrier()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, verify: bool = True,
                shardings: Any = None) -> Any:
        """Restore into the structure of `like`: each leaf a tensor on the
        device of `like`'s leaf (the CPU where that leaf is no tensor), or,
        with `shardings` (a tree like `like` of `NamedSharding`s: the NEW
        mesh's for an elastic restore), a DTensor placed by its sharding."""
        self.wait()
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like_leaves, treedef = flatten(like)
        if len(like_leaves) != len(manifest["leaves"]):
            raise ValueError(f"{d} holds {len(manifest['leaves'])} leaves, the "
                             f"tree to restore {len(like_leaves)}")
        metas = manifest["leaves"]
        shard_leaves = ([None] * len(metas) if shardings is None else
                        flatten(shardings)[0])
        with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as pool:
            arrays = pool.map(_read_leaf, [os.path.join(d, m["file"]) for m in metas],
                              [m["crc32"] if verify else None for m in metas])
            out = []
            for meta, lk, arr, sh in zip(metas, like_leaves, arrays, shard_leaves):
                if list(arr.shape) != meta["shape"]:
                    raise IOError(f"{meta['file']} in {d} has shape {arr.shape}, its "
                                  f"manifest {meta['shape']}")
                if sh is not None:
                    t = torch.from_numpy(arr).to(sh.mesh.device_type)
                    out.append(distribute_tensor(t, sh.mesh, placements(sh.spec, sh.mesh)))
                    continue
                dev = lk.device if isinstance(lk, torch.Tensor) else "cpu"
                out.append(torch.from_numpy(arr).to(dev))
        return treedef.unflatten(out)
