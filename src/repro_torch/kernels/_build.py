"""Build the port's CUDA kernels with `nvcc` and load them with ctypes.

Each `src/repro_torch/csrc/<name>.cu` exposes a plain C interface (no
PyTorch headers, so it builds in seconds) and is compiled at first use
into `build/torch_kernels/<name>.so` under the checkout root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/<name>.so csrc/<name>.cu

A library is rebuilt when its source is newer than it.  `build_all`
starts one `nvcc` per source at once.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

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


def _command(name: str) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(BUILD_DIR / f"{name}.so"), str(CSRC / f"{name}.cu"),
    ]


def _stale(name: str) -> bool:
    so, cu = BUILD_DIR / f"{name}.so", CSRC / f"{name}.cu"
    return not so.exists() or so.stat().st_mtime < cu.stat().st_mtime


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale library, one `nvcc` per source in parallel.
    Returns each compiler's diagnostics (registers, shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {
        n: subprocess.Popen(
            _command(n), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for n in names if _stale(n)
    }
    logs = {}
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n{out}")
        logs[n] = out
    return logs


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


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch wrapper."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
