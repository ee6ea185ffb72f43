"""Run one cell of the benchmark of `repro_torch` on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the run's summary and, as its last
lines, each number compared beside its limit on standard error, and one
JSON object as the last line of standard output (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`checks`).  Exits non-zero, printing no result, without a CUDA card (or
with fewer than the cell asks for), without the program beside it, or
if the process holds JAX or the JAX package once the window has closed.

Kernel builds stay inside the checkout: the program builds its CUDA
sources into `build/torch_kernels/`, and any PyTorch extension or Triton
cache goes under `build/` as well.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    # one process with few threads: the host loop is single-threaded Python
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness

    torch.set_num_threads(1)

    spec = harness.cell_spec(args.workload, ROOT)
    chips = spec["entry"].get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 4
    out, lines = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_PROCESS)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"perfbench: the process holds {found} after the window", file=sys.stderr)
        return 5
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
