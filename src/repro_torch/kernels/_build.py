"""Build the port's CUDA kernels with `nvcc` and load them with ctypes.

Each `src/repro_torch/csrc/<name>.cu` exposes a plain C interface (no
PyTorch headers, so it builds in seconds) and is compiled at first use
into `build/torch_kernels/<name>.so` under the checkout root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/<name>.so csrc/<name>.cu

A library is rebuilt when its source is newer than it.  `build_all`
starts one `nvcc` per source at once.  `build` and `use` serve timing
another build of a kernel (another commit's source, other `-D` flags)
beside this one in one process.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("nbbs_pool_step", "paged_attention", "flash_attention")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use"
    )


def _command(source: Path, out: Path, flags: Sequence[str] = ()) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags,
        "-o", str(out), str(source),
    ]


def _stale(name: str) -> bool:
    so, cu = BUILD_DIR / f"{name}.so", CSRC / f"{name}.cu"
    return not so.exists() or so.stat().st_mtime < cu.stat().st_mtime


def build(jobs: Dict[str, Tuple[Path, Path, Sequence[str]]]) -> Dict[str, str]:
    """Compile each job's (source, library, extra nvcc flags), one `nvcc`
    per job, all started at once.  Returns each compiler's diagnostics
    (registers, shared memory) by job name."""
    procs = {}
    for job, (source, out, flags) in jobs.items():
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        procs[job] = subprocess.Popen(
            _command(source, out, flags), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
    logs = {}
    for job, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {jobs[job][0]} ({job}):\n{out}")
        logs[job] = out
    return logs


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale library, one `nvcc` per source in parallel.
    Returns each compiler's diagnostics (registers, shared memory)."""
    return build({n: (CSRC / f"{n}.cu", BUILD_DIR / f"{n}.so", ())
                  for n in names if _stale(n)})


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(str(BUILD_DIR / f"{name}.so"))
            _LIBS[name] = lib
        return lib


def use(name: str, path: Path) -> ctypes.CDLL:
    """Load the library at `path` in place of `csrc/<name>.cu`'s: later
    launches of that kernel in this process run it."""
    with _LOCK:
        lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch wrapper."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
