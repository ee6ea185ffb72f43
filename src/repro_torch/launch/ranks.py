"""Run a script on N ranks of `torch.distributed`, each rank a subprocess
of its own on 127.0.0.1, all under one deadline.

The port's counterpart of the JAX examples' subprocess with
`--xla_force_host_platform_device_count=N`: a world of N gloo ranks on
the CPU (a free TCP port, one thread per rank, CUDA hidden from every
rank).  A rank that fails, or a run that outlives its deadline, ends
every rank, so no caller hangs on a collective that a dead peer never
joins.  `backend="nccl"` gives rank r card r instead (a machine with at
least N cards).

The script runs after a preamble that starts the process group and
defines RANK, WORLD, OUT (a directory shared by the ranks and the
caller, for inputs and results) and `save(name, **arrays)` (rank 0
writes `OUT/name.npz`).  `save_tree` / `load_tree` move a nested dict
of arrays through one npz file ("/"-joined keys).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

SRC = str(Path(__file__).resolve().parents[2])

PREAMBLE = """\
import datetime, os, sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD, OUT = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), sys.argv[1]
BACKEND = os.environ["RANKS_BACKEND"]
torch.set_num_threads(1)
if BACKEND == "nccl":
    torch.cuda.set_device(RANK)
dist.init_process_group(BACKEND, init_method="tcp://127.0.0.1:" + os.environ["MASTER_PORT"],
                        rank=RANK, world_size=WORLD,
                        timeout=datetime.timedelta(seconds=float(os.environ["RANKS_PG_TIMEOUT"])))

def save(name, **arrays):
    if RANK == 0:
        np.savez(os.path.join(OUT, name + ".npz"), **arrays)

"""

POSTAMBLE = """
dist.barrier()
dist.destroy_process_group()
"""


def save_tree(path, tree) -> None:
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)
    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *parents, last = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = z[key]
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """`n` rank subprocesses running a script; `wait` collects them.
    `path` adds directories to the ranks' PYTHONPATH after the port's
    `src`; a collective that waits `pg_timeout` seconds for a peer
    raises (the process group's timeout)."""

    def __init__(self, n: int, script: str, out_dir, *, path=(), backend: str = "gloo",
                 pg_timeout: float = 1800.0) -> None:
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be gloo or nccl, not {backend!r}")
        out_dir = str(out_dir)
        script_path = os.path.join(out_dir, "rank_script.py")
        with open(script_path, "w") as f:
            f.write(PREAMBLE + textwrap.dedent(script) + POSTAMBLE)
        port = free_port()
        env = dict(os.environ, WORLD_SIZE=str(n), MASTER_PORT=str(port), RANKS_BACKEND=backend,
                   RANKS_PG_TIMEOUT=str(pg_timeout), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([SRC, *map(str, path)]))
        if backend == "gloo":   # the ranks never touch a card
            env["CUDA_VISIBLE_DEVICES"] = ""
        self.logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w+") for r in range(n)]
        self.procs = [
            subprocess.Popen([sys.executable, script_path, out_dir], stdout=self.logs[r],
                             stderr=subprocess.STDOUT, env=dict(env, RANK=str(r)))
            for r in range(n)
        ]
        self.started = time.monotonic()

    def wait(self, timeout: float = 120.0) -> list:
        """Each rank's output, once all have ended.  Raises if a rank
        fails or `timeout` seconds from the start pass; every rank still
        running then is killed."""
        procs = self.procs
        try:
            while any(p.poll() is None for p in procs):
                if (any(p.poll() not in (None, 0) for p in procs)
                        or time.monotonic() > self.started + timeout):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for f in self.logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        n = len(procs)
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {n} exited {p.returncode}:\n{out[-6000:]}")
        return outs


def run_ranks(n: int, script: str, out_dir, timeout: float = 120.0, **kw) -> list:
    """Run `script` on `n` ranks; returns each rank's output."""
    return Ranks(n, script, out_dir, **kw).wait(timeout)
