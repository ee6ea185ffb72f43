"""Run a script on N gloo ranks of `torch.distributed` on the CPU, each
rank a subprocess of its own (a free TCP port on 127.0.0.1, one
deadline for all of them: a rank that fails or outlives it ends every
rank, so no test hangs on a collective that a dead peer never joins).

The script runs after a preamble that starts the process group and
defines RANK, WORLD, OUT (a directory shared by the ranks and the test,
for inputs and results) and `save(name, **arrays)` (rank 0 writes
`OUT/name.npz`).  `save_tree` / `load_tree` move a nested dict of arrays
through one npz file ("/"-joined keys).
"""

import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PREAMBLE = """\
import os, sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD, OUT = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), sys.argv[1]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["MASTER_PORT"],
                        rank=RANK, world_size=WORLD)

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
    """`n` rank subprocesses running a script; `wait` collects them."""

    def __init__(self, n: int, script: str, out_dir) -> None:
        out_dir = str(out_dir)
        path = os.path.join(out_dir, "rank_script.py")
        with open(path, "w") as f:
            f.write(PREAMBLE + textwrap.dedent(script) + POSTAMBLE)
        port = free_port()
        self.logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w+") for r in range(n)]
        self.procs = [
            subprocess.Popen(
                [sys.executable, path, out_dir], stdout=self.logs[r],
                stderr=subprocess.STDOUT,
                env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), MASTER_PORT=str(port),
                         PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                                     os.path.join(REPO, "tests")]),
                         OMP_NUM_THREADS="1"))
            for r in range(n)
        ]
        self.started = time.monotonic()

    def wait(self, timeout: float = 120.0) -> list:
        """Each rank's output, once all have ended.  Fails the test if a
        rank fails or `timeout` seconds from the start pass."""
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
            assert p.returncode == 0, f"rank {r} of {n} exited {p.returncode}:\n{out[-6000:]}"
        return outs


def run_ranks(n: int, script: str, out_dir, timeout: float = 120.0) -> list:
    """Run `script` on `n` ranks; returns each rank's output."""
    return Ranks(n, script, out_dir).wait(timeout)
