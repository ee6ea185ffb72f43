"""Serving launcher: continuous batching on NBBS-paged KV memory.

Counterpart of `repro/launch/serve.py`, with the same flags and the same
JSON line, plus `--device` (default `cuda`).  The weights are random,
drawn on the device by a generator seeded with `--seed`; the working
dtype is bf16 on the card and fp32 on the CPU, as JAX picks it by
backend.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
      --reduced --device cpu --requests 16 --max-new 8
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--num-pages", type=int, default=256)
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                         device=device, dtype=dtype)
    eng = ServeEngine(
        cfg,
        params,
        num_pages=args.num_pages,
        page_tokens=args.page_tokens,
        max_batch=args.max_batch,
        dtype=dtype,
        device=device,
    )
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(2, args.prompt_len + 1))
        eng.submit(
            Request(
                i,
                rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
                max_new_tokens=args.max_new,
            )
        )
    t0 = time.perf_counter()
    eng.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in eng.completed.values())
    print(
        json.dumps(
            {
                "completed": len(eng.completed),
                "generated_tokens": toks,
                "tokens_per_s": toks / dt,
                "engine_stats": eng.stats,
                "kv": eng.kv.fragmentation(),
            }
        )
    )


if __name__ == "__main__":
    main()
