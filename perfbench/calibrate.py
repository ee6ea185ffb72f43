"""Readings that set a cell's limits and rate, on the card, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 8 [--control]
    python3 perfbench/calibrate.py --workload <cell> --seeds 21 --seconds 8 --rates 20,30,40

Without `--rates`: one run of the cell per seed (weights and traffic
from that seed, the cell's own geometry and load), printing the widest
served gap (the lower reading of `served_gap_sd`) and, with
`--control`, the same numbers of the control (the reference in fp8) over
the same prompts and tokens (their upper readings), judged by the cell's
own limits as the program's are: the exit code is 1 unless every
program run is correct and every control run is not.  With `--rates`: the
open loop's sweep, one run per rate, printing the queue at the window's
start and end and the latencies, for finding the knee.  With `--out F`
each run's result is appended to F as one JSON line.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rates", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    base = harness.cell_spec(args.workload, ROOT)
    runs = [(int(s), None) for s in args.seeds.split(",")]
    if args.rates:
        runs = [(runs[0][0], float(r)) for r in args.rates.split(",")]
    wrong = []
    for seed, rate in runs:
        spec = copy.deepcopy(base)
        if rate is not None:
            spec["cell"]["rate_per_s"] = rate
        t0 = time.perf_counter()
        res, lines = harness.run(spec, seed, args.seconds, False, torch.device("cuda", 0),
                                 time.perf_counter(), control=args.control)
        res.update(seed=seed, rate=rate, wall_s=time.perf_counter() - t0, log=lines)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
        m = {k: round(v["value"], 4) for k, v in res["metrics"].items()}
        gap = {k: round(c["value"], 5) for k, c in res["checks"].items() if "served" in k}
        gap.update({k: round(v, 5) for k, v in res["readings"].items() if "served" in k})
        ctrl = res.get("control")
        if not res["correct"] or (ctrl is not None and ctrl["correct"]):
            wrong.append(seed)
        print(f"seed {seed} rate {rate}: correct {res['correct']} program {gap} control "
              f"{ctrl} {m} kv {res['kv_cache']} "
              f"peak {res['device']['memory_peak_bytes'] / 1e9:.2f} GB "
              f"wall {res['wall_s']:.1f} s", flush=True)
        for line in lines:
            if not line.startswith("check "):
                print("   ", line, flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if args.control and wrong:
        print(f"calibrate: program not correct, or control correct, on seeds {wrong}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
