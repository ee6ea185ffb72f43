"""End-to-end serving example: continuous batching on NBBS-paged KV memory.

    PYTHONPATH=src python -m repro_torch.examples.serve_paged          # the card: stablelm-3b, bf16
    PYTHONPATH=src python -m repro_torch.examples.serve_paged --reduced --device cpu --dtype float32
    PYTHONPATH=src python -m repro_torch.examples.serve_paged --ring 4096 --snapshot SNAP.json

The twin of `examples/serve_paged.py`.  A burst of 12 variable-length
requests hits one shared pool of 128 pages of 4 tokens; the buddy
system handles admission control, page placement (contiguous buddy
runs), and coalescing on completion, while the model decodes all
running sequences together through paged attention.

Two engines run the same burst: the host-loop `ServeEngine` (host
tables over the paper's `NBBSRef`, one host sync per token) and the
jit-resident `JitServeEngine` (page alloc and retirement frees in
kernel A, paged attention in kernel B, sampling, all in one decode
step; a chunk of 4 steps per dispatch, a CUDA graph on the card).
`--ring N` gives the jit engine an event ring of N rows and
`--snapshot PATH` writes its `snapshot()` for
`python -m repro_torch.tools.obsdump PATH` (docs/observability.md's
capture workflow).  The weights are random, from seed 0; the dtype
defaults to bf16 on the card and float32 on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.examples import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.jit_engine import JitServeEngine

GEOM = dict(num_pages=128, page_tokens=4, max_batch=6)
JIT_GEOM = dict(max_lane_pages=8, max_out=16)
N_REQUESTS, CHUNK = 12, 4


def burst(vocab_size: int) -> list:
    """The example's requests: prompts of 3-13 tokens, 3-8 new tokens."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQUESTS):
        plen = int(rng.integers(3, 14))
        reqs.append(Request(
            req_id=i,
            prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(3, 9)),
        ))
    return reqs


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg, params, device, dtype, *, ring: int = 0, snapshot=None, out=print) -> dict:
    """The burst through both engines; returns what they printed and
    each request's tokens."""
    dev = torch.device(device)
    engine = ServeEngine(cfg, params, dtype=dtype, device=dev, **GEOM)
    for req in burst(cfg.vocab_size):
        engine.submit(req)
    out(f"pool: {engine.kv.num_pages} pages x {engine.page_tokens} tokens")
    t0 = time.perf_counter()
    step = 0
    while engine.waiting or engine.running:
        engine.step()
        step += 1
        if step % 3 == 1:
            f = engine.kv.fragmentation()
            out(f"step {step:3d}: running={len(engine.running)} "
                f"waiting={len(engine.waiting)} done={len(engine.completed)} "
                f"used={f['used_pages']:3d}p largest_run={f['largest_run']:3d}p")
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in engine.completed.values())
    out(f"\ncompleted {len(engine.completed)} requests, {toks} tokens "
        f"in {dt:.1f}s ({toks/dt:.1f} tok/s on {dev.type})")
    f = engine.kv.fragmentation()
    coalesced = f["largest_run"] == engine.kv.num_pages
    out(f"pool after completion: used={f['used_pages']} "
        f"largest_run={f['largest_run']} (fully coalesced: {coalesced})")
    for i in sorted(engine.completed)[:3]:
        out(f"  req {i}: generated {engine.completed[i].out_tokens}")
    res = dict(host=dict(completed=len(engine.completed), tokens=toks, seconds=dt,
                         tokens_per_s=toks / dt, steps=step, used_pages=f["used_pages"],
                         largest_run=f["largest_run"], fully_coalesced=coalesced,
                         out_tokens={i: list(r.out_tokens)
                                     for i, r in sorted(engine.completed.items())}))

    # --- the same burst through the jit-resident engine ----------------
    jit_engine = JitServeEngine(cfg, params, dtype=dtype, device=dev, ring_capacity=ring,
                                **GEOM, **JIT_GEOM)
    for req in burst(cfg.vocab_size):  # same seed -> same requests
        jit_engine.submit(req)
    t0 = time.perf_counter()
    jit_engine.run_to_completion(chunk=CHUNK)  # 4 steps per dispatch
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in jit_engine.completed.values())
    tot = jit_engine.stat_totals()
    free = jit_engine.device_free_pages()
    out(f"\njit engine: {len(jit_engine.completed)} requests, {toks} tokens "
        f"in {dt:.1f}s ({toks/dt:.1f} tok/s, graph capture included)")
    out(f"  in-graph allocator: {tot['alloc_pages']} pages allocated, "
        f"{tot['freed_pages']} freed, {tot['merged_writes']} merged tree "
        f"writes; pool free={free}/{GEOM['num_pages']}")
    res["jit"] = dict(completed=len(jit_engine.completed), tokens=toks, seconds=dt,
                      tokens_per_s=toks / dt, steps=jit_engine.stats["steps"],
                      free_pages=free, stat_totals=tot,
                      out_tokens={i: list(r.out_tokens)
                                  for i, r in sorted(jit_engine.completed.items())})
    if snapshot:
        with open(snapshot, "w") as fh:
            json.dump(jit_engine.snapshot(), fh, indent=1)
        out(f"  snapshot: {snapshot} (render with python -m repro_torch.tools.obsdump)")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reduced", action="store_true", help="the config's reduced widths")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="default: bfloat16 on the card, float32 on the CPU")
    ap.add_argument("--ring", type=int, default=0, help="the jit engine's ring_capacity")
    ap.add_argument("--snapshot", metavar="PATH", help="write the jit engine's snapshot()")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype or ("float32" if dev.type == "cpu" else "bfloat16"))
    cfg = get_config("stablelm-3b")
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=dtype)
    return run(cfg, params, dev, dtype, ring=args.ring, snapshot=args.snapshot)


if __name__ == "__main__":
    main()
