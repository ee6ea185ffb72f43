"""Run a script on N gloo ranks of `torch.distributed` on the CPU, each
rank a subprocess of its own: the port's launcher
(`repro_torch.launch.ranks`), with this directory on the ranks'
PYTHONPATH so that rank scripts import `save_tree` / `load_tree` from
here.

The script runs after a preamble that starts the process group and
defines RANK, WORLD, OUT (a directory shared by the ranks and the test,
for inputs and results) and `save(name, **arrays)` (rank 0 writes
`OUT/name.npz`).  `save_tree` / `load_tree` move a nested dict of arrays
through one npz file ("/"-joined keys).
"""

import os

from repro_torch.launch import ranks as _ranks
from repro_torch.launch.ranks import PREAMBLE, free_port, load_tree, save_tree  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


class Ranks(_ranks.Ranks):
    """`n` rank subprocesses running a script; `wait` collects them."""

    def __init__(self, n: int, script: str, out_dir) -> None:
        super().__init__(n, script, out_dir, path=(TESTS,))


def run_ranks(n: int, script: str, out_dir, timeout: float = 120.0) -> list:
    """Run `script` on `n` ranks; returns each rank's output."""
    return Ranks(n, script, out_dir).wait(timeout)
