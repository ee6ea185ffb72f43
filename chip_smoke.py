#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure fails the run, exit code 1):

  1. device: the card's name and power limit; build both CUDA kernels
     from `src/repro_torch/csrc/` (one nvcc per source, in parallel);
  2. kernel B (paged decode attention) against its plain version on the
     card at the main path's shapes (B=256, 32 heads, D=80, page 4, 32
     pages per lane, lengths 0..128 with empty rows) in fp32 and bf16,
     and at D=128, group 4, softcap 50;
  3. kernel A (pooled NBBS step) against its plain version on the card:
     a seeded churn of 200 mixed alloc/free bursts (K=256, F=8192) at
     S=1, depth 12 and S=4, depth 10, overflow included; bit-identical,
     and so is its release half alone (`pool_free`, the engine's
     retirement burst) with its per-handle freed flags;
  4. the main path: `JitServeEngine` serving stablelm-3b at full width
     (random bf16 weights from a seed) with 4096 pages of 4 tokens, 256
     lanes, 32 pages per lane, decode chunks of 8, no EOS: 64 seeded
     requests at S=1 and at S=4, every decode chunk under
     torch.cuda.set_sync_debug_mode("error"); both kernels' launch
     counts are read around this phase; then a `torch.profiler` window
     of 8 steady decode steps at S=1 (device busy share, kernels by
     device time);
  5. the same trace and geometry through the port's engine on the CPU at
     stablelm-3b's reduced config: with EOS off the schedule does not
     depend on tokens, so the retirement order and steps and every
     `stat_totals()` counter must equal phase 4's;
  6. full-width fp32 correctness: one request (prompt 6, 8 new tokens)
     against greedy decoding through the port's dense `prefill` over the
     growing sequence (no kernel on that path): logits within 1e-3 at
     each step, tokens equal wherever the top-2 gap exceeds 1e-3.

Before the last line it prints the `nvidia-smi` name/power-limit line
and one JSON line `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`.  Details go to
`chiprun_out/chip_smoke.json`.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s, fp32 and bf16 FLOP/s
HBM_BPS = 3.35e12
PEAK = {"float32": 67e12, "bfloat16": 989e12}

GEOM = dict(num_pages=4096, page_tokens=4, max_batch=256, max_lane_pages=32,
            max_out=64)
CHUNK = 8
PROMPT_BUCKETS = (2, 4, 8, 16, 32)


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Device time of one call, from CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# Phase 2: paged decode attention
# ---------------------------------------------------------------------------


def attention_inputs(torch, dev, dtype, *, B=256, Hq=32, Hkv=32, D=80, page=4,
                     max_pages=32, P=4096, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, Hq, D), generator=g).to(dev, dtype)
    k = torch.randn((P, page, Hkv, D), generator=g).to(dev, dtype)
    v = torch.randn((P, page, Hkv, D), generator=g).to(dev, dtype)
    lens = torch.randint(0, max_pages * page + 1, (B,), generator=g)
    lens[::9] = 0                                     # empty rows
    tables = torch.full((B, max_pages), -1, dtype=torch.int32)
    for b in range(B):
        n = -(-int(lens[b]) // page)
        if b % 18 == 9:
            n = 3                                     # pages, zero context
        tables[b, :n] = torch.randperm(P, generator=g)[:n].to(torch.int32)
    return q, k, v, tables.to(dev), lens.to(torch.int32).to(dev)


def phase_attention(torch, dev, report):
    from repro_torch.kernels import paged_attention as pa

    cases = [
        ("bf16 main path", torch.bfloat16, {}, None, 3e-2),
        ("fp32 main path", torch.float32, {}, None, 2e-5),
        ("fp32 D=128 group 4 softcap 50", torch.float32,
         {"Hq": 32, "Hkv": 8, "D": 128}, 50.0, 2e-5),
    ]
    rows = []
    for name, dtype, shape, softcap, tol in cases:
        q, k, v, tables, lens = attention_inputs(torch, dev, dtype, **shape)
        out = pa.paged_attention(q, k, v, tables, lens, softcap=softcap)
        want = pa.paged_attention_plain(q, k, v, tables, lens, softcap=softcap)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs()
        max_err = float(err.max())
        ok = bool((err <= tol + tol * want.float().abs()).all())
        empty = (lens == 0)
        zeros_ok = bool((out[empty] == 0).all())
        ms = cuda_ms(torch, lambda: pa.paged_attention(q, k, v, tables, lens, softcap=softcap))
        plain_ms = cuda_ms(torch, lambda: pa.paged_attention_plain(
            q, k, v, tables, lens, softcap=softcap), reps=5)
        B, Hq, D = q.shape
        Hkv = k.shape[2]
        e = q.element_size()
        ctx_total = int(lens.sum())
        nbytes = (2 * B * Hq * D * e + tables.numel() * 4 + B * 4
                  + 2 * ctx_total * Hkv * D * e)
        ops = 4 * ctx_total * Hq * D
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = ops / PEAK[str(dtype).replace("torch.", "")] * 1e3
        row = dict(case=name, max_abs_err=max_err, tol=tol, ok=ok and zeros_ok,
                   ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   kv_bytes=2 * ctx_total * Hkv * D * e)
        log(f"[attention] {name}: max_abs_err {max_err:.3e} (tol {tol}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) empty-rows-zero {zeros_ok}")
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"paged attention disagrees with its plain version: {name}")
    report["attention"] = rows
    return rows


# ---------------------------------------------------------------------------
# Phase 3: pooled NBBS step
# ---------------------------------------------------------------------------


def phase_alloc(torch, dev, report):
    import numpy as np

    from repro_torch.core.concurrent import TreeConfig
    from repro_torch.core.pool import PoolConfig, pool_free_round, pool_wavefront_step
    from repro_torch.kernels import nbbs_alloc

    big_ids = np.array([2**31 - 1, 2**31 - 2, 2**30 + 7, -1, 2, 3], np.int32)
    rows = []
    for S, depth in ((1, 12), (4, 10)):
        pcfg = PoolConfig(TreeConfig(depth=depth), S)
        rng = np.random.default_rng(depth)
        K, F, steps = 256, 8192, 200
        N = pcfg.n_words
        trees = pcfg.empty_trees(dev)
        live = np.zeros((0, 2), np.int64)        # (shard, node)
        kern_ms = plain_ms = 0.0
        tot = {"overflows": 0, "rounds": 0, "freed": 0, "won": 0}
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for step in range(steps):
            p_free = 0.6 if step % 4 == 3 else 0.08
            take = live[rng.random(len(live)) < p_free]
            fn = rng.integers(0, N, size=F).astype(np.int32)
            fs = rng.integers(0, S, size=F).astype(np.int32)
            fa = np.zeros(F, bool)
            n = len(take)
            fs[:n], fn[:n], fa[:n] = take[:, 0], take[:, 1], True
            fa[n : n + 32] = True                    # junk and stale handles
            fn[n + 32 : n + 40], fs[n + 32 : n + 40] = fn[:8], fs[:8]
            fa[n + 32 : n + 40] = fa[:8]             # duplicates
            fs[n + 40], fa[n + 40] = S + 3, True     # shard out of range
            levels = np.where(rng.random(K) < 0.7, depth,
                              rng.integers(depth - 4, depth, size=K)).astype(np.int32)
            act = rng.random(K) < 0.9
            ids = rng.integers(0, 100_000, size=K).astype(np.int32)
            ids[rng.integers(0, K, size=len(big_ids))] = big_ids
            args = [torch.from_numpy(a).to(dev) for a in (fn, fs, fa, levels, act, ids)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = pool_wavefront_step(pcfg, trees, *args[:5], 64, args[5])
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t0) * 1e3
            ev0.record()
            got = nbbs_alloc.pool_step(pcfg, trees, *args)
            ev1.record()
            torch.cuda.synchronize()
            kern_ms += ev0.elapsed_time(ev1)
            for a, b, what in zip(want[:4], got[:4], ("trees", "nodes", "shard", "ok")):
                if not torch.equal(a, b):
                    raise AssertionError(f"pool step S={S} step {step}: {what} differ")
            for k_ in want[4]:
                if int(want[4][k_]) != int(got[4][k_]):
                    raise AssertionError(
                        f"pool step S={S} step {step}: stat {k_} "
                        f"{int(want[4][k_])} != {int(got[4][k_])}")
            # the release half alone, with its per-handle freed flags
            want_f = pool_free_round(pcfg, trees, *args[:3])
            got_f = nbbs_alloc.pool_free(pcfg, trees, *args[:3])
            if not (torch.equal(want_f[0], got_f[0]) and torch.equal(want_f[3], got_f[1])):
                raise AssertionError(f"pool free S={S} step {step}: trees or freed differ")
            trees = got[0]
            tot["overflows"] += int(got[4]["overflows"])
            tot["rounds"] += int(got[4]["rounds"])
            tot["freed"] += int(got[4]["freed"])
            nodes, shard = got[1].cpu().numpy(), got[2].cpu().numpy()
            tot["won"] += int((nodes > 0).sum())
            freed = set(map(tuple, take.tolist()))
            keep = np.array([tuple(h) not in freed for h in live.tolist()], bool)
            live = live[keep] if len(live) else live
            new = np.stack([shard[nodes > 0], nodes[nodes > 0]], 1).astype(np.int64)
            live = np.concatenate([live, new])
        if S > 1 and tot["overflows"] == 0:
            raise AssertionError("the S=4 churn never overflowed")
        T = S * N
        nbytes = 2 * T * 4 + F * 12 + K * 12 + K * 8 + 28
        row = dict(S=S, depth=depth, steps=steps, K=K, F=F, ms=kern_ms / steps,
                   plain_ms=plain_ms / steps, bound_ms=nbytes / HBM_BPS * 1e3,
                   bound_by="bytes", max_abs_err=0, **tot)
        log(f"[alloc] S={S} depth={depth}: {steps} steps bit-identical "
            f"(overflows {tot['overflows']}, rounds {tot['rounds']}, won {tot['won']}, "
            f"freed {tot['freed']}); kernel {row['ms']:.4f} ms/launch, plain "
            f"{row['plain_ms']:.3f} ms/call, bound {row['bound_ms']:.6f} ms")
        rows.append(row)
    report["alloc"] = rows
    return rows


# ---------------------------------------------------------------------------
# Phases 4-6: the engine
# ---------------------------------------------------------------------------


def make_trace(seed, n=64, vocab=256):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.choice(PROMPT_BUCKETS))
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        out.append((i, prompt, int(rng.integers(8, 65))))
    return out


def run_engine(torch, cfg, params, dev, dtype, S, trace):
    """Serve `trace` to completion.  On the card every decode chunk runs
    under torch.cuda.set_sync_debug_mode("error") (a host sync raises)
    between two CUDA events."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.jit_engine import JitServeEngine

    eng = JitServeEngine(cfg, params, dtype=dtype, device=dev, n_shards=S, **GEOM)
    chunks = []
    if dev.type == "cuda":
        inner = eng.decode_steps

        def timed(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                inner(n)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            b.record()
            chunks.append((n, a, b))

        eng.decode_steps = timed
    for i, p, mn in trace:
        eng.submit(Request(i, p.copy(), mn))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_to_completion(max_steps=10_000, chunk=CHUNK)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_ms = [a.elapsed_time(b) for _, a, b in chunks]
    return eng, wall, chunks, decode_ms


def phase_engine(torch, dev, report, state):
    from repro_torch.configs import get_config
    from repro_torch.kernels import nbbs_alloc, paged_attention as pa
    from repro_torch.models.transformer import init_params

    cfg = get_config("stablelm-3b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[engine] stablelm-3b full width: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} "
        f"vocab {cfg.vocab_size}; bf16 weights from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    trace = make_trace(0)
    state["trace"] = trace
    rows = []
    nbbs_alloc.launches = 0
    pa.launches = 0
    for S in (1, 4):
        a0, b0 = nbbs_alloc.launches, pa.launches
        eng, wall, chunks, decode_ms = run_engine(
            torch, cfg, params, dev, torch.bfloat16, S, trace)
        steps = eng.stats["steps"]
        tokens = sum(len(r.out_tokens) for r in eng.completed.values())
        tot = eng.stat_totals()
        if len(eng.completed) != len(trace):
            raise AssertionError(f"S={S}: {len(eng.completed)} of {len(trace)} completed")
        for i, _, mn in trace:
            if len(eng.completed[i].out_tokens) != mn:
                raise AssertionError(f"S={S}: request {i} gave "
                                     f"{len(eng.completed[i].out_tokens)} of {mn} tokens")
        free = eng.device_free_pages()
        if free != GEOM["num_pages"]:
            raise AssertionError(f"S={S}: {free} free pages at the end")
        dec = sum(decode_ms)
        steady = sum(decode_ms[1:]) / max(sum(n for n, _, _ in chunks[1:]), 1)
        row = dict(
            S=S, decode_steps=steps, tokens=tokens, wall_s=wall,
            decode_ms_per_step=dec / steps, steady_decode_ms_per_step=steady,
            tokens_per_s=tokens / (dec / 1e3), wall_tokens_per_s=tokens / wall,
            alloc_pages=tot["alloc_pages"], freed_pages=tot["freed_pages"],
            probe_overflows=tot["probe_overflows"],
            nbbs_launches=nbbs_alloc.launches - a0,
            attention_launches=pa.launches - b0,
        )
        log(f"[engine] S={S}: {steps} decode steps, {tokens} tokens, alloc "
            f"{row['alloc_pages']} freed {row['freed_pages']} pages; decode "
            f"{row['decode_ms_per_step']:.2f} ms/step (steady "
            f"{steady:.2f}), {row['tokens_per_s']:.1f} tokens/s decode, "
            f"{row['wall_tokens_per_s']:.1f} tokens/s wall ({wall:.2f} s); launches "
            f"nbbs {row['nbbs_launches']} attention {row['attention_launches']}")
        rows.append(row)
        state[f"S{S}"] = (list(eng.retired_order), dict(eng.done_steps), tot)
        del eng
    launches = {"nbbs_pool_step": nbbs_alloc.launches,
                "paged_attention": pa.launches}
    log(f"[engine] main-path launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    report["engine"] = rows
    state["launches"] = launches
    del params
    torch.cuda.empty_cache()
    return rows


def phase_profile(torch, dev, report, state):
    """Where a steady decode step's time goes: a `torch.profiler` window
    of 8 decode steps of the S=1 engine (after one warm chunk), its
    device busy share, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request
    from repro_torch.serve.jit_engine import JitServeEngine

    cfg = get_config("stablelm-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    eng = JitServeEngine(cfg, params, dtype=torch.bfloat16, device=dev, **GEOM)
    for i, p, mn in state["trace"]:
        eng.submit(Request(i, p.copy(), mn))
    eng._admit()
    eng.decode_steps(CHUNK)
    torch.cuda.synchronize()
    steps = 8
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode_steps(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:          # union of device intervals, in us
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    ours = {}
    for key, tag in (("pool_step_kernel", "nbbs_pool_step"),
                     ("paged_decode_kernel", "paged_attention")):
        hits = [e for e in events if key in e.name]
        ms = sum(e.time_range.end - e.time_range.start for e in hits) / 1e3
        ours[tag] = dict(launches_per_step=len(hits) / steps,
                         ms_per_step=ms / steps,
                         ms_per_launch=ms / len(hits) if hits else None)
    busy_step = busy / 1e3 / steps if events else None
    unprofiled = report["engine"][0]["steady_decode_ms_per_step"]
    out = dict(
        steps=steps, wall_ms_per_step=wall_ms / steps,
        device_busy_ms_per_step=busy_step,
        device_idle_share=(1 - busy / 1e3 / wall_ms) if events else None,
        device_idle_share_vs_unprofiled_step=(
            1 - busy_step / unprofiled) if events else None,
        device_events=len(events), kernels=ours,
        top_device_ms_per_step=[(n, t / 1e3 / steps) for n, t in top],
    )
    log(f"[profile] S=1 steady window: {out['wall_ms_per_step']:.2f} ms/step wall "
        f"under the profiler ({unprofiled:.2f} without), device busy {busy_step} "
        f"ms/step, idle share {out['device_idle_share']} (against the "
        f"unprofiled step {out['device_idle_share_vs_unprofiled_step']})")
    for tag, k in ours.items():
        log(f"[profile]   {tag}: {k['launches_per_step']} launches/step, "
            f"{k['ms_per_step']:.4f} ms/step, {k['ms_per_launch']} ms/launch")
    for n, t in out["top_device_ms_per_step"]:
        log(f"[profile]   {t:8.3f} ms/step  {n[:90]}")
    report["profile"] = out
    del eng, params
    torch.cuda.empty_cache()


def phase_cpu_trace(torch, report, state):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config("stablelm-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32)
    rows = []
    for S in (1, 4):
        eng, wall, _, _ = run_engine(torch, cfg, params, torch.device("cpu"),
                                     torch.float32, S, state["trace"])
        order, done, tot = state[f"S{S}"]
        same = dict(
            retired_order=eng.retired_order == order,
            done_steps=eng.done_steps == done,
            stat_totals=eng.stat_totals() == tot,
        )
        log(f"[cpu trace] S={S}: {eng.stats['steps']} steps on the CPU in "
            f"{wall:.1f} s; equal to the card: {same}")
        if not all(same.values()):
            diff = {k: (v, tot.get(k)) for k, v in eng.stat_totals().items()
                    if tot.get(k) != v}
            raise AssertionError(f"S={S}: CPU trace differs from the card: {diff}")
        rows.append(dict(S=S, wall_s=wall, **same))
    report["cpu_trace"] = rows


def phase_fp32(torch, dev, report):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serve.engine import Request
    from repro_torch.serve.jit_engine import JitServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("stablelm-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev, dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
    eng = JitServeEngine(cfg, params, num_pages=64, page_tokens=4, max_batch=2,
                         max_lane_pages=16, max_out=8, dtype=torch.float32,
                         device=dev)
    eng.submit(Request(0, prompt, max_new_tokens=8))
    eng_logits = []
    while 0 not in eng.completed:
        before = eng.stats["steps"]
        eng.step()
        if eng.stats["steps"] > before:
            eng_logits.append(eng.state.logits[0].clone())
    tokens = eng.completed[0].out_tokens
    worst, flips = 0.0, []
    for i, tok in enumerate(tokens):
        seq = torch.tensor(list(prompt) + tokens[:i], dtype=torch.long, device=dev)
        lg, _ = prefill(cfg, params, {"tokens": seq[None]}, len(seq), dtype=torch.float32)
        lg = lg[0]
        diff = float((lg - eng_logits[i]).abs().max())
        worst = max(worst, diff)
        top2 = torch.topk(lg, 2).values
        gap = float(top2[0] - top2[1])
        if gap > 1e-3 and int(lg.argmax()) != tok:
            raise AssertionError(f"step {i}: token {tok} != dense greedy {int(lg.argmax())}")
        if gap <= 1e-3:
            flips.append(i)
        if diff > 1e-3:
            raise AssertionError(f"step {i}: logits differ by {diff:.3e} > 1e-3")
    log(f"[fp32] full width, prompt 6 + {len(tokens)} tokens: max |logit diff| "
        f"{worst:.3e} (tol 1e-3), tokens equal to dense greedy; near-ties at {flips}")
    report["fp32"] = dict(max_abs_logit_diff=worst, tokens=tokens, near_ties=flips)
    del eng, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


def main() -> int:
    # one card: the run, and the device count it reports, see the first
    # visible card only
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the root "
              "of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card}")
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    report = {"card": card, "device": name, "torch": torch.__version__}
    t0 = time.perf_counter()
    logs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {sorted(logs)} in {report['build_s']:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[ptxas {src}] {line.strip()}")

    state: dict = {}
    failures = []
    phases = [
        ("attention", lambda: phase_attention(torch, dev, report)),
        ("alloc", lambda: phase_alloc(torch, dev, report)),
        ("engine", lambda: phase_engine(torch, dev, report, state)),
        ("profile", lambda: phase_profile(torch, dev, report, state)),
        ("cpu_trace", lambda: phase_cpu_trace(torch, report, state)),
        ("fp32", lambda: phase_fp32(torch, dev, report)),
    ]
    for pname, fn in phases:
        if pname == "cpu_trace" and "S4" not in state:
            failures.append((pname, "needs the engine phase"))
            continue
        t = time.perf_counter()
        try:
            fn()
            log(f"[phase] {pname} ok in {time.perf_counter() - t:.1f} s")
        except Exception as exc:  # every phase runs; any failure fails the run
            traceback.print_exc()
            failures.append((pname, repr(exc)))
            log(f"[phase] {pname} FAILED: {exc!r}")
    report["failures"] = failures
    report["card_line"] = card
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    if failures:
        log(f"chip_smoke: {len(failures)} phase(s) failed: {failures}")
        return 1

    att = report["attention"][0]   # bf16 at the main path's shapes
    alloc = report["alloc"][0]     # S=1, depth 12
    kernels = [
        {"name": "nbbs_pool_step", "route": "cuda",
         "source": "src/repro_torch/csrc/nbbs_pool_step.cu",
         "replaces": "src/repro/kernels/nbbs_alloc.py:249",
         "launches": state["launches"]["nbbs_pool_step"],
         "max_abs_err": 0, "ms": alloc["ms"], "plain_ms": alloc["plain_ms"],
         "bound_ms": alloc["bound_ms"], "bound_by": alloc["bound_by"],
         "library_ms": None},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:37",
         "launches": state["launches"]["paged_attention"],
         "max_abs_err": att["max_abs_err"], "ms": att["ms"],
         "plain_ms": att["plain_ms"], "bound_ms": att["bound_ms"],
         "bound_by": att["bound_by"], "library_ms": None},
    ]
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(float(k[key])):
                log(f"chip_smoke: {k['name']} {key} is not finite")
                return 1
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
