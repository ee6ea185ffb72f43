#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --ab paged_attention PARENT_DIR [.:-DPA_STAGES=3 ...]
    python3 chip_smoke.py --ab nbbs_pool_step PARENT_DIR
    python3 chip_smoke.py --ab flash_attention PARENT_DIR
                                     # time builds of a kernel side by side
    python3 chip_smoke.py --trace-loss [SECONDS]
                                     # device records the profiler loses

Phases (any failure fails the run, exit code 1):

  1. device: the card's name and power limit; build the CUDA kernels
     from `src/repro_torch/csrc/` (one nvcc per source, in parallel): the
     NBBS source gives three launchers (kernel A `nbbs_pool_step`,
     kernel 3 `nbbs_wavefront_step`, kernel 4 `nbbs_wavefront_alloc`)
     over one kernel body in two layouts, two memory tiers, with and
     without the fastpath slab; ptxas registers and shared memory of
     each;
  2. kernel B (paged decode attention) against its plain version on the
     card, B=256 lanes, 4096 pages of 4 (more where the rows need them:
     every row has its own pages), 32 pages per lane: the main
     path's shapes (stablelm-3b's 32/32 heads, D=80, lengths 0..128 with
     empty rows) in bf16 and fp32, fp32 at D=128, group 4, softcap 50,
     and in bf16 the engine's occupancy (stablelm-3b, 64 live lanes of
     2-96 tokens, the rest empty), phi3-medium-14b (40/10, D=128) and
     gemma2-27b (32/16, D=128, softcap 50); bf16 within one rounding of
     the output, fp32 within 2e-5; each row's device time (launches
     queued behind a sleep kernel, each on one of four copies of the K/V
     pool, so that it finds its pages out of L2), bound and tiling;
  3. kernel A (pooled NBBS step) against its plain version on the card:
     a seeded churn of 200 mixed alloc/free bursts (K=256, F=8192) at
     S=1, depth 12 and S=4, depth 10, overflow included, timed per
     launch queued behind a sleep kernel after one untimed launch, in both tree
     layouts (Unpacked and BunchPacked); bit-identical, and so is its
     release half alone (`pool_free`, the engine's retirement burst)
     with its per-handle freed flags; then phase fastpath: the same
     churn on pools with the fastpath slab (both layouts, and S=1 depth
     14 in shared memory and depth 16 in the device-memory tier, each
     against the slab-less kernel), pure
     leaf bursts that must equal an uncarved pool address for address,
     and kernel A with and without the slab at the engine's own shapes
     (alloc K=256 F=0, free F=8192 K=0); then phase frontends: the
     churn loops of bench_constant_occupancy's `fastpath_sweep` and
     `magazine_sweep` on the card through `ops.nbbs_pool_wavefront_step`
     (`mags=` for magazines), every counter equal to BENCH_FASTPATH.json
     and BENCH_MAGAZINE.json;
  4. the single-tree path: kernels 4 and 3 against `wavefront_alloc` /
     `wavefront_step` at bench_wavefront's shapes (depth 14, K in {1,
     16, 256}, levels over 7 octaves) and bench_bunch_rmw's (depth 12,
     K=128, 8 octaves), both in the shared-memory tier, and at depth 16,
     K=256 (the device-memory tier), kernel 3 with F=K/2 frees from the
     live set, both layouts,
     bit-identical; then, with the launch counts at 0, the user's
     single-tree path on the card: examples/quickstart.py through its
     twin `repro_torch.examples.quickstart` (§3-§6 on the card) with the
     example's assertions, and the single-op API
     (`nb_alloc`, `nb_alloc_size`, `nb_free`, `nb_free_batch`) on a
     16K-unit tree in both layouts, held against a CPU replay;
  5. the main path: `JitServeEngine` serving stablelm-3b at full width
     (random bf16 weights from a seed) with 4096 pages of 4 tokens, 256
     lanes, 32 pages per lane, decode chunks of 8, no EOS: 64 seeded
     requests at S=1 and at S=4, and at S=4 with `layout="bunch-packed"`
     (its retirement order and steps must equal the unpacked S=4 run's),
     then with the front ends, 16 requests arriving per decode chunk so
     that lanes are reused: `fastpath=True` at S=1 and S=4, and
     `fastpath=True, magazines=4` at S=4 packed (slab and magazine hits
     must be positive, kernel A launches exactly 2 (3 with magazines)
     per decode step and admission), and S=1 with the event ring
     (`ring_capacity=4096`: its schedule and counters equal the
     ring-less S=1 run's, its snapshot validates and renders as a
     Chrome trace, `chiprun_out/engine_ring.trace.json`); every run
     decodes in fused chunks of 8 (`run_to_completion(chunk=8)`: the
     first chunk warms up and captures a CUDA graph, every later one
     replays it), and one more S=1 run goes through the eager loop, the
     reference: the fused S=1 run's schedule, counters and tokens must
     equal it; eager and fused ms per step and tokens/s; every decode
     chunk, the capture included, under
     torch.cuda.set_sync_debug_mode("error"); the kernels' launch counts
     (replays count their graph's launches) are read around this phase
     and must be 2 (3) kernel A per step and admission and 32 kernel B
     per step; then a `torch.profiler` window of two fused chunks at S=1
     (device busy ms and idle share, kernels by device time, kernels A
     and B counted per step from the device events) and a CPU-side
     profile of one eager step (aten calls, host ms by op and by part of
     the step);
  6. the same trace and geometry through the port's engine on the CPU at
     stablelm-3b's reduced config: with EOS off the schedule does not
     depend on tokens, so the retirement order and steps and every
     `stat_totals()` counter must equal phase 5's, the packed run's too,
     and the ring run's drained events must equal the card's;
  7. host_engine: the host-driven serving path, the launch counts at 0
     before each run and read after it: `python -m
     repro_torch.launch.serve --arch stablelm-3b` in-process at full
     width in bf16 with the launcher's defaults (16 requests, 8 new
     tokens, 256 pages of 8, 8 lanes): all served, the pool fully
     coalesced, kernel B 32 launches per step and kernel A none (the
     host loop allocates through the paper's `NBBSRef` trees); then
     `ServeEngine` on phase 5's trace at 4096 pages of 4, 64 running
     sequences, tables of 32 pages, at S=1 and at S=4 with the fastpath
     and magazines 4: every budget served, every shard's tree consistent
     and fully coalesced, `stats`, retirement order and
     `fragmentation()` equal to a CPU replay at the reduced config, ms
     per decode step and tokens/s beside phase 5's; kernel B against its
     plain version and timed on the inputs these runs gave it; then the
     port's `HostOracleEngine` (host Python, no model, no code shared
     with the jit engine) replays every fused run of phase 5: retirement
     order and steps and its `stat_totals()` equal; and one more fused
     run (S=4 packed, fastpath, magazines 4, 16 arrivals per chunk) in
     lockstep with it, chunk by chunk: every running sequence's block
     table page for page and the free pages after each admission, the
     free pages of each shard at the end;
  8. moe: phi3.5-moe-42b-a6.6b at full width (d_model 4096, 32/8 heads,
     D=128, 16 experts of d_ff 6400, top-2, vocab 32064) cut from 32 to
     16 layers (41.6 GB of bf16 weights; 32 would not fit), random
     weights from seed 0, the launch counts at 0 before each run and
     read after it: `JitServeEngine` fused at phase 5's geometry, at S=1
     (every request at once) and at S=4 packed with the fastpath and
     magazines 4 (16 arrivals per chunk), each chunk by chunk in
     lockstep with `HostOracleEngine` (running sets, block tables page
     for page, free pages) and equal at the end to phase 5's same-named
     run (retirement order, steps, every counter); kernel A 2 (3) per
     step and admission, kernel B 16 per step; every chunk under
     torch.cuda.set_sync_debug_mode("error"); then 8 eager S=1 steps
     (tokens equal to the fused run's), a profiler window of two fused
     chunks (device busy, idle share, kernels A and B per step), the
     expert FFN's device time per layer at the decode step's shapes
     against its bounds (the drop-free capacity buffer's 1.29 TFLOP and
     the routed rows'), `ServeEngine` at S=1 (64 lanes, tables of 32:
     kernel B 16 per step, kernel A none, pool coalesced, schedule equal
     to phase 7's), kernel B at 32/8 heads, D=128 against its plain
     version, peak device memory, and decode consistency at full width
     (prefill(17) against prefill(16) + decode_step, B=4: bf16 at 16
     layers within 2^-2 of the logits' norm, fp32 at 8 layers within
     1e-4);
  9. full-width fp32 correctness: one request (prompt 6, 8 new tokens)
     through the jit engine and through `ServeEngine`, each against
     greedy decoding through the port's dense `prefill` over its growing
     sequence (no kernel on that path): the jit engine's logits within
     1e-3 at each step, both engines' tokens equal wherever the top-2
     gap exceeds 1e-3;
  10. train: stablelm-3b trained through `launch/train.py`'s path
     (`train_fns`: `SyntheticLM`, `init_train_state`, `make_train_step`),
     no kernel of the port on it: (a) at full width (32 layers, random
     weights from seed 0, float32 masters, bf16 compute, remat), global
     batch 8 x 1024 in 2 microbatches, 6 AdamW steps (warm-up 2, the
     first step a warm-up): steady ms per step from CUDA events and
     AdamW's share, tokens/s, model TFLOP/s (6 N T over the step, N the
     matmul parameters) and its share of 989, peak memory under the
     card's capacity, losses and grad norms finite, then one profiled
     step (device busy, ms by kernel family); (b) at full width cut to
     2 layers, B=2, S=128, fp32, against the same on CPU tensors in this
     process: the loss (1e-5 relative) and every gradient leaf (1e-4 of
     its max), AdamW on the CPU's gradients (parameters, m and v, 1e-4
     of each leaf's max), one `make_train_step` (loss, grad norm 1e-5
     relative); (c)
     the launcher's `Supervisor` at full width cut to 4 layers, bf16,
     compressed gradients, 2 microbatches, 8 x 256: 30 steps, a
     checkpoint every 10, a failure at 17: one restart, steps 10-16
     replayed, the loss lower at the end, the last checkpoint restored
     bit for bit;
  11. ssm: the hybrid and ssm families, zamba2-1.2b (38 Mamba2 layers,
     the shared attention block at 19 sites) and rwkv6-7b (32 RWKV6
     layers), no kernel of the port on their path (JAX runs the SSD and
     wkv scans in plain jnp): (a) serving at full width, random bf16
     weights from seed 0: `prefill` of 8 prompts of 512 tokens into a
     cache of 576, then 64 greedy `decode_step`s over the dense cache:
     prefill s and its scan's share, steady ms per decode step (CUDA
     events), tokens/s, peak memory, one profiled step (kernel launches,
     device idle share), every logit finite; (b) decode consistency at
     full width and depth, B=4, S=64: prefill(65) against prefill(64) +
     decode_step within 1e-4 of the logits' norm in fp32 (TF32 off;
     rwkv6, chaotic in depth with random weights, held at its first 8
     layers and measured at 32) and 2^-3 in bf16; (c) fp32 at full width
     cut to 2 layers (zamba2: 2 groups of 2) against the same on CPU
     tensors: prefill's logits (1e-4 of their norm) and every cache leaf
     (2e-5), 4 decode steps, then `train_loss` (1e-5 relative) and its
     gradients (1e-4 of each leaf's max, or twice the CPU's own spread
     under 1e-7 parameter noise where that is larger); (d) training through `launch/train.py`'s path, bf16
     over float32 masters, remat, 3 steps: zamba2 at full depth, 4 x 512,
     rwkv6 cut to 4 layers, 4 x 256, each in 2 microbatches: ms per
     step, tokens/s, peak memory, finite losses;
  12. dist: the distribution layer (`models.sharding`, `launch.mesh`,
     the sharded `make_train_step`, `compressed_psum`, `train.pp`) over
     an in-process NCCL group of one rank (one card holds one NCCL
     rank) with the mesh (1, 1) ("data", "model"), no kernel of the port
     on its path: (a) fp32, stablelm-3b at full width cut to 2 layers,
     B=2, S=128: the sharded `train_loss` and its gradients against the
     unsharded ones from the same weights and batch (loss within 1e-6
     relative, each gradient leaf within 1e-6 of its max; bit-equal
     leaves counted); (b) stablelm-3b at full depth with phase train
     (a)'s TrainConfig and batch, 3 steps unsharded and 3 sharded in
     this phase: steady ms per step (CUDA events), tokens/s, peak
     memory, beside phase train (a)'s step; (c) `compressed_psum` of a
     64M-element fp32 gradient over NCCL, equal to
     `decompress(*compress(g))`, timed beside a plain fp32 all_reduce;
     (d) `pipeline_apply` with one stage against the sequential layers
     within 1e-5; (e) sharded serving: stablelm-3b at full width and
     depth, random bf16 weights from seed 0, `prefill` of 8 prompts of
     512 into a cache of 1024 and 32 greedy `decode_step`s, sharded
     (parameters by `param_specs` + `shard_tree`, the cache placed by
     `cache_pspecs`) and unsharded from the same weights: the tokens
     equal, the logits' largest difference at steps 1 and 32, steady ms
     per decode step, prefill s, host s per sharded decode call, peak
     memory; fp32 at full width, sharded against unsharded, prefill of
     2 x 64 and 8 decode steps: phi3.5-moe and gemma2-27b cut to 2
     layers, zamba2-1.2b to one group, rwkv6-7b to 2 layers (logits and
     cache leaves within 1e-5 of their max, the difference reported);
     B=1 on the cache rule's branch for a batch that does not divide
     over dp;
  13. examples: the twins of examples/ and tools/obsdump.py
     (`repro_torch.examples`, `repro_torch.tools`), each through its
     function: quickstart on the card (kernel 4 on §4 and §6, kernel 3
     on §6, with the example's assertions), serve_paged with stablelm-3b
     at full width in bf16 (ServeEngine, then JitServeEngine with kernels
     A and B, the ring on; every request served, the pool coalesced and
     free; tokens/s of each), the obsdump twin on the snapshot it wrote
     (the metric table, the ring's events, a trace that validates),
     train_tiny_lm on the card (160 steps with its restart: first and
     last loss), elastic_restart on 8 gloo ranks of this machine's CPU
     ((4, 2) -> (2, 4), its 8 losses within 1e-5 relative of the
     unsharded port's);
  14. ranks: the sharded paths on 4 gloo ranks of this machine's CPU
     under its torch (`repro_torch.launch.ranks`), fp32 at the reduced
     widths, each case against the unsharded port in this process with
     the CPU files' tolerances: `train_loss` and its gradients for
     stablelm-3b, phi3.5-moe (scatter and einsum dispatch), zamba2-1.2b,
     rwkv6-7b and stablelm-3b on the multi-pod (2, 2, 1) mesh, three
     sharded `make_train_step` steps, the elastic (2, 2) -> (1, 4)
     restore, `compressed_psum` over each axis (bit-equal), `train.pp`
     over 2 stages, sharded `prefill` and 4 greedy `decode_step`s of
     stablelm-3b and zamba2-1.2b (tokens equal); one line per case;
  15. dryrun: the dry run of the production meshes, no kernel of the
     port on its path: (a) `python -m repro_torch.launch.dryrun --device
     cuda` in five processes side by side, one cell each, each a fake
     world of 256 or 512 ranks with fake CUDA tensors: stablelm-3b train_4k,
     prefill_32k and decode_32k on 16x16, phi3.5-moe decode_32k with
     `--variant opt` and rwkv6-7b long_500k on 2x16x16; every cell ok,
     nothing allocated on the card but the 1-element tensor with which
     torch's FakeTensorMode starts the CUDA context once per process
     (each allocation reported with the function that made it); per
     cell the peak bytes per device (torch's `MemTracker` over the fake
     tensors) against 80 GB, the dominant roofline term and its
     compute / memory / collective ms (records in
     `chiprun_out/dryrun_torch/`); the rows of a dim split over ('pod',
     'data') at sampled ranks equal to `sharding.shard_range`'s; (b) the
     counter (`roofline.op_count`) on stablelm-3b's unsharded bf16
     `decode_step` (B=8, cache 1024, at position 512) on the card
     against the same call on fake CPU tensors (flops, bytes, op counts;
     the ops that differ named), `memory_s` and `compute_s` beside the
     step's measured ms;
  16. flash: with its launch count at 0, the differentiable
     `ops.flash_attention` (kernel 5 forward) at full attention width in
     bf16, B=1: stablelm-3b (32/32 heads, D=80, S=4096, causal),
     phi3-medium-14b (40/10, D=128, S=4096, causal), gemma2-27b global
     (32/16, D=128, S=8192, causal, softcap 50) and local (the same with
     its 4096 window), and in fp32 at S=2048 (the 3xTF32 body)
     stablelm-3b, phi3-medium-14b and gemma2-27b local with a 1024
     window, and a gradient at gemma2 local's widths cut to S=2048 and a
     1024 window (the S x S reference backward stays small, the window
     still bites); then each row against its plain version on the card
     (bf16 within one rounding of the output, 2^-7 |want| + 1e-4; fp32
     2e-5 + 2e-5 |want|, the gradient's forward too; gradient 1e-5: the
     backward recomputes the reference, so the gradient checks the
     autograd wiring, not the kernel), its time (fp32: the split of K
     and V and the attention kernel apart, from `torch.profiler`), bound
     (fp32: the bytes' term against the lesser of the CUDA cores' and
     the 3xTF32 split's operations terms, both printed) and `library_ms`
     (one scaled_dot_product_attention call where SDPA computes the same
     function: causal, no window, no softcap; the kernel it ran named
     from the profiler), its TFLOP/s of useful work and its ratios to
     the bound and to SDPA; and each body's ptxas registers and spills
     and its HGMMA / HMMA count from `cuobjdump -sass` (every bf16 and
     3xTF32 body must hold HGMMA: wgmma on the tensor cores).

Before the last line it prints the `nvidia-smi` name/power-limit line
and one JSON line `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`.  Details go to
`chiprun_out/chip_smoke.json`.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s, fp32 and bf16 FLOP/s;
# TF32 on the tensor cores
HBM_BPS = 3.35e12
PEAK = {"float32": 67e12, "bfloat16": 989e12}
TF32_PEAK = 495e12

GEOM = dict(num_pages=4096, page_tokens=4, max_batch=256, max_lane_pages=32,
            max_out=64)
CHUNK = 8
PROMPT_BUCKETS = (2, 4, 8, 16, 32)


def log(*a):
    print(*a, flush=True)


def entry_label(mangled):
    """A kernel's template instance, from its mangled name."""
    m = re.search(r"nbbs_step_kernelILb(\d)ELb(\d)ELb(\d)E", mangled)
    if m:
        return "<{}, {}, {}>".format("packed" if m[1] == "1" else "unpacked",
                                     "shared" if m[2] == "1" else "device",
                                     "slab" if m[3] == "1" else "no slab")
    if "empty_kernel" in mangled:
        return "<empty>"
    m = re.search(r"flash_fwd_bf16_kernelILi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"<bf16, DP={m[1]}, BK={m[2]}, NST={m[3]}>"
    m = re.search(r"flash_fwd_kernelIfLi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"<fp32, RPT={m[1]}, NJ4={m[2]}>"
    m = re.search(r"flash_fwd_tf32_kernelILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"<fp32 3xTF32, DP={m[1]}, NST={m[2]}>"
    if "split_kv_tf32_kernel" in mangled:
        return "<fp32 3xTF32 split of K and V>"
    m = re.search(r"paged_decode_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", mangled)
    if m:
        return f"<{'fp32' if m[1] == 'f' else 'bf16'}, GQ={m[2]}, CH={m[3]}>"
    return ""


def ptxas_entries(text):
    """{label: registers, spill bytes and stack} of each kernel in one
    source's `nvcc -Xptxas -v` log."""
    out, entry = {}, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = entry_label(line)
            out[entry] = dict(registers=None, spill_stores=None, spill_loads=None,
                              stack=None)
        elif entry in out and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[entry].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif entry in out and "Used" in line and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    return out


def sass_counts(lib, opcodes=("HGMMA", "HMMA")):
    """{kernel label: {opcode: count}} in a built library's SASS, from
    `cuobjdump -sass`: which kernels issue tensor-core instructions."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, entry = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            entry = entry_label(line) or line.split("Function :")[1].strip()
            counts[entry] = dict.fromkeys(opcodes, 0)
        elif entry is not None:
            for op in opcodes:
                if re.search(rf"\b{op}\.", line):
                    counts[entry][op] += 1
    return counts


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


def queued_ms(torch, fn, reps=20, warmup=2):
    """Device time of one call with the launch queue backed up behind a
    sleep kernel, so the host's time in the wrappers is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(torch, fn, reps=3):
    """Host-clock time of one call ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# Each attention kernel against its plain version.  Both compute fp32
# values that agree to about 1e-6 and round them once to the output's
# type, so a bf16 output may differ by one bf16 ulp, at most 2^-7 of the
# value.  A fixed 2e-2 would not do: flash outputs at S = 4096-8192 are
# about 0.02, and a kernel that dropped one kv tile would still pass.
OUT_TOL = {"bfloat16": "2^-7 |want| + 1e-4", "float32": "2e-5 + 2e-5 |want|"}


def out_limit(torch, want):
    """Per-element limit on |kernel - plain| for a plain output `want`."""
    w = want.float().abs()
    if want.dtype == torch.bfloat16:
        return w * 2.0 ** -7 + 1e-4
    return w * 2e-5 + 2e-5


# ---------------------------------------------------------------------------
# Phase 2: paged decode attention
# ---------------------------------------------------------------------------


def attention_inputs(torch, dev, dtype, *, B=256, Hq=32, Hkv=32, D=80, page=4,
                     max_pages=32, P=4096, live=None, seed=0):
    """Seeded inputs at the engine's geometry.  With `live=None`, lengths
    0..max_pages * page, every ninth row empty and some with pages but
    zero context; with `live=n`, the engine's occupancy: n random lanes
    of 2-96 tokens, the rest with length 0 and no page.  Every row has
    its own pages, as the engine's allocator gives them (P is raised
    where the rows need more)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if live is None:
        lens = torch.randint(0, max_pages * page + 1, (B,), generator=g)
        lens[::9] = 0                                 # empty rows
    else:
        lens = torch.zeros(B, dtype=torch.int64)
        lens[torch.randperm(B, generator=g)[:live]] = torch.randint(2, 97, (live,),
                                                                    generator=g)
    n = [-(-int(x) // page) for x in lens]
    if live is None:
        for b in range(9, B, 18):
            n[b] = 3                                  # pages, zero context
    P = max(P, sum(n))
    q = torch.randn((B, Hq, D), generator=g).to(dev, dtype)
    k = torch.randn((P, page, Hkv, D), generator=g).to(dev, dtype)
    v = torch.randn((P, page, Hkv, D), generator=g).to(dev, dtype)
    ids = torch.randperm(P, generator=g).to(torch.int32)
    tables = torch.full((B, max_pages), -1, dtype=torch.int32)
    start = 0
    for b in range(B):
        tables[b, :n[b]] = ids[start:start + n[b]]
        start += n[b]
    return q, k, v, tables.to(dev), lens.to(torch.int32).to(dev)


def attention_cases(torch):
    """(name, dtype, widths, softcap, live lanes) per row; row 0 is the
    main path's, the one the `kernels` line reports."""
    from repro_torch.configs import get_config

    def width(name):
        c = get_config(name)
        return {"Hq": c.n_heads, "Hkv": c.n_kv_heads, "D": c.head_dim}, c.attn_softcap or None

    stablelm, _ = width("stablelm-3b")
    phi3, _ = width("phi3-medium-14b")
    gemma, cap = width("gemma2-27b")
    return [
        ("bf16 main path", torch.bfloat16, stablelm, None, None),
        ("fp32 main path", torch.float32, stablelm, None, None),
        ("fp32 D=128 group 4 softcap 50", torch.float32,
         {"Hq": 32, "Hkv": 8, "D": 128}, 50.0, None),
        ("bf16 engine occupancy (64 of 256 lanes)", torch.bfloat16, stablelm, None, 64),
        ("bf16 phi3-medium-14b", torch.bfloat16, phi3, None, None),
        ("bf16 gemma2-27b", torch.bfloat16, gemma, cap, None),
    ]


def attention_bound(torch, q, k, tables, lens):
    """(bound ms, bound_by): each input read once (live K/V once per kv
    head), the output written once, against the card's peaks."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    e = q.element_size()
    ctx_total = int(lens.sum())
    nbytes = (2 * B * Hq * D * e + tables.numel() * 4 + B * 4
              + 2 * ctx_total * Hkv * D * e)
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 4 * ctx_total * Hq * D / PEAK[str(q.dtype).replace("torch.", "")] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def attention_ms(torch, pa, q, k, v, tables, lens, softcap, copies=4):
    """Device time of one kernel B launch, with `queued_ms`, cycling
    through `copies` copies of the K/V pool: each launch finds its pages
    out of the 50 MB L2, as each layer of the engine does (another
    layer's pool was read in between)."""
    pools = itertools.cycle([(k, v)] + [(k.clone(), v.clone()) for _ in range(copies - 1)])
    return queued_ms(torch, lambda: pa.paged_attention(q, *next(pools), tables, lens,
                                                       softcap=softcap))


def phase_attention(torch, dev, report):
    from repro_torch.kernels import paged_attention as pa

    rows = []
    for name, dtype, shape, softcap, live in attention_cases(torch):
        q, k, v, tables, lens = attention_inputs(torch, dev, dtype, live=live, **shape)
        out = pa.paged_attention(q, k, v, tables, lens, softcap=softcap)
        want = pa.paged_attention_plain(q, k, v, tables, lens, softcap=softcap)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs()
        max_err = float(err.max())
        slack = float((err / out_limit(torch, want)).max())   # <= 1 passes
        pos = torch.arange(tables.shape[1] * k.shape[1], device=dev)
        dead = ~((tables >= 0).repeat_interleave(k.shape[1], dim=1)
                 & (pos[None, :] < lens[:, None])).any(dim=1)
        zeros_ok = bool((out[dead] == 0).all())
        ms = attention_ms(torch, pa, q, k, v, tables, lens, softcap)
        plain_ms = cuda_ms(torch, lambda: pa.paged_attention_plain(
            q, k, v, tables, lens, softcap=softcap), reps=5)
        bound_ms, bound_by = attention_bound(torch, q, k, tables, lens)
        row = dict(case=name, dtype=str(dtype).replace("torch.", ""),
                   Hq=q.shape[1], Hkv=k.shape[2], D=q.shape[2], softcap=softcap,
                   live_rows=int((~dead).sum()), max_abs_err=max_err,
                   tol=OUT_TOL[str(dtype).replace("torch.", "")], err_over_limit=slack,
                   ok=slack <= 1.0 and zeros_ok and bool(torch.isfinite(out).all()),
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   over_bound=ms / bound_ms,
                   kv_bytes=2 * int(lens.sum()) * k.shape[2] * q.shape[2] * q.element_size(),
                   tiling=pa.tile_plan(q.shape[1], k.shape[2], q.shape[2],
                                       tables.shape[1], dtype))
        log(f"[attention] {name}: max_abs_err {max_err:.3e}, worst element at "
            f"{slack:.3f} of its limit ({row['tol']}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{row['over_bound']:.2f}x; tiling {row['tiling']}; rows without a live "
            f"position zero: {zeros_ok}")
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"paged attention disagrees with its plain version: {name}")
    report["attention"] = rows
    return rows


def ab_paged_attention(torch, dev, libs, trees):
    """`--ab` rows of kernel B: phase attention's rows, each side's build
    held against the plain version and timed with `attention_ms`."""
    from repro_torch.kernels import _build, paged_attention as pa

    sides = list(libs)
    rows = []
    for name, dtype, shape, softcap, live in attention_cases(torch):
        q, k, v, tables, lens = attention_inputs(torch, dev, dtype, live=live, **shape)
        want = pa.paged_attention_plain(q, k, v, tables, lens, softcap=softcap)
        limit = out_limit(torch, want)
        row = {"case": name, "ms": {side: [] for side in sides}, "err_over_limit": {},
               "tiling": {}}
        for side in sides + sides[::-1]:
            lib = _build.use("paged_attention", libs[side])
            out = pa.paged_attention(q, k, v, tables, lens, softcap=softcap)
            torch.cuda.synchronize()
            row["err_over_limit"][side] = float(((out.float() - want.float()).abs()
                                                 / limit).max())
            if hasattr(lib, "paged_attention_plan"):   # sources before PR 16 lack it
                row["tiling"][side] = pa.tile_plan(q.shape[1], k.shape[2], q.shape[2],
                                                   tables.shape[1], dtype)
            row["ms"][side].append(attention_ms(torch, pa, q, k, v, tables, lens,
                                                softcap))
        row["bound_ms"], row["bound_by"] = attention_bound(torch, q, k, tables, lens)
        row["over_bound"] = {side: min(t) / row["bound_ms"] for side, t in row["ms"].items()}
        row["ok"] = {side: e <= 1.0 for side, e in row["err_over_limit"].items()}
        log(json.dumps(row))
        rows.append(row)
    return rows


AB_STEPS = 30   # bursts per churn row of `--ab nbbs_pool_step`; launches per fixed shape


def side_wrappers(trees, module="nbbs_alloc"):
    """Each side's own `kernels/<module>.py`: its wrapper goes with its
    kernel (nbbs_alloc: the workspace layout and tier rule;
    flash_attention: the C signature and the scratch).  Loaded beside
    this checkout's package, whose `_build` hands each of them the
    library in use."""
    import importlib.util

    mods = {}
    for side, tree in trees.items():
        path = Path(tree) / "src" / "repro_torch" / "kernels" / f"{module}.py"
        spec = importlib.util.spec_from_file_location(f"_ab_{module}{len(mods)}", path)
        mods[side] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[side])
    return mods


def _pool_same(torch, want, got):
    return (all(torch.equal(a, b) for a, b in zip(want[:4], got[:4]))
            and all(int(want[4][k]) == int(got[4][k]) for k in want[4]))


def _free_same(torch, want, got):
    return (torch.equal(want[0], got[0]) and torch.equal(want[3], got[1])
            and [int(want[1]), int(want[2]), int(want[3].sum())]
            == [int(got[2][k]) for k in ("free_merged_writes", "free_logical_rmws", "freed")])


def _tree_same(torch, slots):
    return lambda want, got: (all(torch.equal(a, b) for a, b in zip(want[:3], got[:3]))
                              and [int(want[3][k]) for k in slots] == got[3].tolist())


def ab_nbbs_rows(torch, dev):
    """The rows of `--ab nbbs_pool_step`: (case, bound ms, steps), each
    step (launch(wrapper module), plain result, same(want, got)).
    Kernel A at the engine's alloc and free shapes (S=1 depth 12, 2048
    leaf pages live) with and without the slab; `pool_churn`'s bursts
    at S=1 depth 12 and S=4 depth 10 in both layouts and at S=1 depth 14
    with and without the slab (AB_STEPS bursts, each launch on the plain
    version's tree of that step); kernels 4 and 3 at bench_bunch_rmw's
    depth 12, K=128 and bench_wavefront's depth 14, K=256, both layouts."""
    import numpy as np

    from repro_torch.core import concurrent as conc
    from repro_torch.core.concurrent import BUNCH_PACKED, UNPACKED, TreeConfig
    from repro_torch.core.fastpath import FastPathConfig
    from repro_torch.core.pool import PoolConfig, pool_free_round, pool_wavefront_step

    i32 = dict(dtype=torch.int32, device=dev)
    fp = FastPathConfig(level=None, slab_level=2)
    rows = []
    # kernel A at the engine's shapes
    for pcfg in (PoolConfig(TreeConfig(depth=12), 1),
                 PoolConfig(TreeConfig(depth=12), 1, fastpath=fp)):
        S, depth, W = pcfg.n_shards, pcfg.tree.depth, pcfg.n_state_words
        K, F, live = 256, 8192, 2048
        none = torch.zeros(0, **i32)
        levels = torch.full((K,), depth, **i32)
        act = torch.ones(K, dtype=torch.bool, device=dev)
        trees = pcfg.empty_trees(dev)
        fn, fs = torch.zeros(F, **i32), torch.zeros(F, **i32)
        for j in range(live // K):
            trees, nodes, shard, _, _ = pool_wavefront_step(
                pcfg, trees, none, none, none.bool(), levels, act, 64,
                torch.arange(K, **i32) + j * K)
            fn[j * K:(j + 1) * K], fs[j * K:(j + 1) * K] = nodes, shard
        fa = torch.arange(F, device=dev) < live
        ids = torch.arange(K, **i32) + live
        tag = " slab" if pcfg.fastpath else ""
        want_a = pool_wavefront_step(pcfg, trees, none, none, none.bool(), levels, act, 64, ids)
        want_f = pool_free_round(pcfg, trees, fn, fs, fa)
        alloc_args = (none, none, none, levels, act, ids)
        rows.append((f"A engine alloc S=1 d12 K=256 F=0{tag}",
                     (2 * S * W * 4 + K * 12 + K * 8 + 28) / HBM_BPS * 1e3,
                     [(lambda m, p=pcfg, t=trees, a=alloc_args: m.pool_step(p, t, *a),
                       want_a, lambda w, g: _pool_same(torch, w, g))] * AB_STEPS))
        rows.append((f"A engine free S=1 d12 F=8192 K=0{tag}",
                     (2 * S * W * 4 + F * 12 + F * 4 + 28) / HBM_BPS * 1e3,
                     [(lambda m, p=pcfg, t=trees, a=(fn, fs, fa): m.pool_free(p, t, *a),
                       want_f, lambda w, g: _free_same(torch, w, g))] * AB_STEPS))
    # kernel A's churn
    for layout, S, depth, slab in ((UNPACKED, 1, 12, False), (UNPACKED, 4, 10, False),
                                   (BUNCH_PACKED, 1, 12, False), (BUNCH_PACKED, 4, 10, False),
                                   (UNPACKED, 1, 14, True), (UNPACKED, 1, 14, False)):
        pcfg = PoolConfig(TreeConfig(depth=depth, layout=layout), S,
                          fastpath=fp if slab else None)
        K, F = 256, 8192
        rng = np.random.default_rng(depth)
        trees = pcfg.empty_trees(dev)
        live = np.zeros((0, 2), np.int64)
        steps = []
        for step in range(AB_STEPS):
            take, arrays = churn_inputs(rng, live, step, pcfg, K, F)
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            want = pool_wavefront_step(pcfg, trees, *args[:5], 64, args[5])
            steps.append((lambda m, p=pcfg, t=trees, a=args: m.pool_step(p, t, *a), want,
                          lambda w, g: _pool_same(torch, w, g)))
            trees = want[0]
            live = churn_live(live, take, want[1], want[2])
        nbytes = 2 * S * pcfg.n_state_words * 4 + F * 12 + K * 12 + K * 8 + 28
        rows.append((f"A churn {layout.name} S={S} d{depth} K={K} F={F}"
                     + (" slab" if slab else ""), nbytes / HBM_BPS * 1e3, steps))
    # kernels 4 and 3
    for layout in (UNPACKED, BUNCH_PACKED):
        for depth, K, octaves, seed in ((12, 128, 7, 2), (14, 256, 6, 3)):
            cfg = TreeConfig(depth=depth, layout=layout)
            rng = np.random.default_rng(seed)
            levels = torch.from_numpy(
                rng.integers(depth - octaves, depth + 1, size=K).astype(np.int32)).to(dev)
            act = torch.ones(K, dtype=torch.bool, device=dev)
            empty, W = cfg.empty_tree(dev), cfg.n_state_words
            want4 = conc.wavefront_alloc(cfg, empty, levels, act)
            F = K // 2
            fn, fa = want4[1][:F].contiguous(), want4[2][:F].contiguous()
            want3 = conc.wavefront_step(cfg, want4[0], fn, fa, levels, act)
            slots = ("rounds", "merged_writes", "logical_rmws")
            rows.append((f"4 {layout.name} d{depth} K={K}", (8 * W + 9 * K + 12) / HBM_BPS * 1e3,
                         [(lambda m, c=cfg, e=empty, a=(levels, act): m.wavefront_alloc(c, e, *a),
                           want4, _tree_same(torch, slots))] * AB_STEPS))
            rows.append((f"3 {layout.name} d{depth} K={K} F={F}",
                         (8 * W + 9 * K + 9 * F + 24) / HBM_BPS * 1e3,
                         [(lambda m, c=cfg, t=want4[0], a=(fn, fa, levels, act):
                           m.wavefront_step(c, t, *a), want3,
                           _tree_same(torch, slots + ("free_merged_writes",
                                                      "free_logical_rmws", "freed")))]
                         * AB_STEPS))
    return rows


def launch_ms(torch, fn):
    """Device time of one launch queued behind a sleep kernel (so the
    wrapper's host time is not counted), read with CUDA events."""
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(CHURN_SLEEP)
    ev0.record()
    out = fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1), out


def kernel_launch_ms(torch, fn, name, reps):
    """Mean device time of the kernels named `name` over `reps` calls of
    fn, from a `torch.profiler` trace: the kernel alone, without the
    wrapper's own PyTorch ops (casts of bool masks, the stat row's fill,
    `nodes > 0`)."""
    for _ in range(3):   # a trace now and then comes back without its kernels
        torch.cuda.synchronize()
        with traced(torch) as tr:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in tr.events
                 if name in e.name and on_card(e)]
        if spans:
            return sum(spans) / len(spans) / 1e3
    raise AssertionError(f"the profiler saw no {name} launch in three traces "
                         f"(the last lost {tr.lost} of its {LEAD_IN} lead-in records)")


def ab_nbbs_pool_step(torch, dev, libs, trees):
    """`--ab` rows of kernels A, 3 and 4 (`ab_nbbs_rows`), each side's
    build through its own wrapper, every launch held bit-identical to the
    plain version.  Per turn, `ms` is the mean device time of a wrapper
    call (each queued behind a sleep kernel, read with CUDA events: the
    kernel and the wrapper's small PyTorch ops), `kernel_ms` the mean
    device time of the kernel alone (`torch.profiler`).  One more row
    times an empty launch of the same block shape (this checkout's
    `nbbs_empty_launch`) both ways: the floor under every row."""
    import ctypes

    from repro_torch.kernels import _build

    sides = list(libs)
    mods = side_wrappers(trees)
    rows = []
    floor = ctypes.CDLL(str(libs["change"])).nbbs_empty_launch
    floor.argtypes, floor.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    empty = {"case": "empty 1024-thread launch", "ms": {"change": []},
             "kernel_ms": {"change": []}, "ok": {"change": True}, "bound_ms": 0.0,
             "bound_by": "none"}

    def empty_launch():
        _build.check(floor(stream), "nbbs_empty_launch")

    for case, bound_ms, steps in ab_nbbs_rows(torch, dev):
        row = {"case": case, "ms": {side: [] for side in sides},
               "kernel_ms": {side: [] for side in sides}, "ok": {},
               "bound_ms": bound_ms, "bound_by": "bytes"}
        for side in sides + sides[::-1]:
            _build.use("nbbs_pool_step", libs[side])
            mod = mods[side]
            steps[0][0](mod)   # a first launch: the library's first load
            total, ok = 0.0, True
            for launch, want, same in steps:
                ms, got = launch_ms(torch, lambda: launch(mod))
                total += ms
                ok = ok and same(want, got)
            row["ms"][side].append(total / len(steps))
            it = itertools.cycle(steps)
            row["kernel_ms"][side].append(kernel_launch_ms(
                torch, lambda: next(it)[0](mod), "nbbs_step_kernel", len(steps)))
            row["ok"][side] = row["ok"].get(side, True) and ok
        row["parent_over_change"] = {side: min(t) / min(row["kernel_ms"]["change"])
                                     for side, t in row["kernel_ms"].items()}
        log(json.dumps(row))
        rows.append(row)
        if not empty["ms"]["change"] or len(rows) % 6 == 0:
            empty["ms"]["change"].append(sum(
                launch_ms(torch, empty_launch)[0] for _ in range(AB_STEPS)) / AB_STEPS)
            empty["kernel_ms"]["change"].append(
                kernel_launch_ms(torch, empty_launch, "empty_kernel", AB_STEPS))
    log(json.dumps(empty))
    return rows + [empty]


def ab_flash_attention(torch, dev, libs, trees):
    """`--ab` rows of kernel 5: phase flash's rows (the fp32 ones, and
    the bf16 ones as a control), each side's build through its own
    `kernels/flash_attention.py`, held against the plain version and
    timed with CUDA events (`cuda_ms`), in turns forward then backward;
    the change's split and attention kernels apart from the profiler."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    sides = list(libs)
    mods = side_wrappers(trees, "flash_attention")
    rows = []
    for seed, (name, cfg, S, var, dtype, has_lib) in enumerate(flash_rows(torch)):
        q, k, v = flash_inputs(torch, dev, cfg, S, dtype, seed)
        want = fa.flash_attention_plain(q, k, v, **var)
        limit = out_limit(torch, want)
        row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
               "ms": {side: [] for side in sides}, "err_over_limit": {}, "ok": {},
               **{k_: v_ for k_, v_ in flash_bound(q, k, v, var).items()
                  if k_ in ("bound_ms", "bound_by", "ops_terms_ms", "ops_term")}}
        for side in sides + sides[::-1]:
            _build.use("flash_attention", libs[side])
            fwd = mods[side].flash_attention_fwd
            out = fwd(q, k, v, **var)
            torch.cuda.synchronize()
            slack = float(((out.float() - want.float()).abs() / limit).max())
            row["err_over_limit"][side] = max(slack, row["err_over_limit"].get(side, 0.0))
            row["ok"][side] = row["err_over_limit"][side] <= 1.0
            row["ms"][side].append(cuda_ms(torch, lambda: fwd(q, k, v, **var), reps=5,
                                           warmup=1))
            if side == "change" and "parts_ms" not in row:
                row["parts_ms"] = flash_parts_ms(torch, lambda: fwd(q, k, v, **var))
            del out
        if has_lib:
            kw = {"enable_gqa": True} if cfg.n_heads != cfg.n_kv_heads else {}
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row["library_ms"] = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True, **kw),
                                        reps=5, warmup=1)
        row["over_change"] = {side: min(t) / min(row["ms"]["change"])
                              for side, t in row["ms"].items()}
        log(json.dumps(row))
        rows.append(row)
        del q, k, v, want, limit
        torch.cuda.empty_cache()
    return rows


AB_KERNELS = {"paged_attention": ab_paged_attention, "nbbs_pool_step": ab_nbbs_pool_step,
              "flash_attention": ab_flash_attention}


def trace_loss(torch, dev, argv):
    """python3 chip_smoke.py --trace-loss [SECONDS]

    The device records `torch.profiler` loses at the start of a trace as
    the process traces more: phase profile's S=1 engine (stablelm-3b at
    full width, `make_trace(0)`), one fused chunk to capture its graph,
    then for SECONDS (400 by default) windows of two graph replays,
    alternately without and with `traced`'s lead-in.  Per window: kernel
    A's and kernel B's device events against 2 and n_layers per step, all
    device events, and the lead-in records lost.  Writes
    `chiprun_out/trace_loss.json`; exits 1 when a window with the lead-in
    missed a kernel A or B event."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request
    from repro_torch.serve.jit_engine import JitServeEngine

    seconds = float(argv[1]) if len(argv) > 1 else 400.0
    _build.build_all()
    cfg = get_config("stablelm-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    eng = JitServeEngine(cfg, params, dtype=torch.bfloat16, device=dev, **GEOM)
    for i, p, mn in make_trace(0):
        eng.submit(Request(i, p.copy(), mn))
    eng._admit()
    eng.decode_steps(CHUNK, fused=True)   # warm-up and capture
    torch.cuda.synchronize()
    steps = 2 * CHUNK
    want = {"nbbs_step_kernel": 2 * steps, "paged_decode_kernel": cfg.n_layers * steps}
    rows, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        lead = len(rows) % 2 == 1
        with traced(torch, lead_in=lead) as tr:
            for _ in range(2):
                eng.decode_steps(CHUNK, fused=True)
            torch.cuda.synchronize()
        events = [e for e in tr.events if on_card(e)]
        counts = {k: sum(k in e.name for e in events) for k in want}
        rows.append(dict(window=len(rows), s=time.perf_counter() - t0, lead_in=lead,
                         counts=counts, complete=counts == want, device_events=len(events),
                         lead_in_lost=tr.lost if lead else None))
        log(json.dumps(rows[-1]))
    summary = {}
    for lead in (False, True):
        mine = [r for r in rows if r["lead_in"] == lead]
        summary["with lead-in" if lead else "without"] = dict(
            windows=len(mine), incomplete=sum(not r["complete"] for r in mine),
            first_incomplete=next((r["window"] for r in mine if not r["complete"]), None),
            device_events=[r["device_events"] for r in mine],
            lead_in_lost=[r["lead_in_lost"] for r in mine] if lead else None)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "trace_loss.json").write_text(json.dumps(dict(want=want, rows=rows,
                                                         summary=summary), indent=1))
    log(json.dumps(summary))
    return 1 if summary["with lead-in"]["incomplete"] else 0


def ab(torch, dev, card, argv):
    """python3 chip_smoke.py --ab KERNEL TREE[:FLAG...] ...

    Times builds of `src/repro_torch/csrc/KERNEL.cu` in one process: this
    checkout's ("change") and each TREE's (another checkout or a `git
    archive` of one; "." is this checkout), each built with the port's
    nvcc command plus the TREE's flags (`-DNAME=VALUE`), launched in turns
    forward then backward on KERNEL's rows.  Each turn holds the output
    against the plain version; the change must pass.  Prints each build's
    ptxas registers and spills and one JSON line per row, and writes
    `chiprun_out/ab_KERNEL.json`.  KERNEL: paged_attention (phase
    attention's rows), nbbs_pool_step (`ab_nbbs_rows`: kernels A, 3 and
    4, each side through its own `kernels/nbbs_alloc.py`) or
    flash_attention (phase flash's rows, each side through its own
    `kernels/flash_attention.py`)."""
    from repro_torch.kernels import _build

    if len(argv) < 3 or argv[0] != "--ab" or argv[1] not in AB_KERNELS:
        print(ab.__doc__, file=sys.stderr)
        return 2
    kernel = argv[1]
    out_dir = ROOT / "build" / "torch_kernels_ab"
    jobs = {"change": (_build.CSRC / f"{kernel}.cu", out_dir / "change.so", ())}
    trees = {"change": ROOT}
    for spec in argv[2:]:
        tree, *flags = spec.split(":")
        trees[spec] = Path(tree).resolve()
        jobs[spec] = (trees[spec] / "src" / "repro_torch" / "csrc" / f"{kernel}.cu",
                      out_dir / f"side{len(jobs)}.so", flags)
    ptxas = {side: ptxas_entries(text) for side, text in _build.build(jobs).items()}
    log(json.dumps({"ptxas": ptxas}))
    rows = AB_KERNELS[kernel](torch, dev, {side: job[1] for side, job in jobs.items()}, trees)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"ab_{kernel}.json").write_text(json.dumps(
        {"card": card, "sides": {side: [str(job[0]), list(job[2])] for side, job in jobs.items()},
         "ptxas": ptxas, "rows": rows}, indent=1))
    bad = [r["case"] for r in rows if not r["ok"]["change"]]
    if bad:
        log(f"chip_smoke --ab: the change disagrees with the plain version on {bad}")
        return 1
    return 0


# ---------------------------------------------------------------------------
# Phase 3: pooled NBBS step
# ---------------------------------------------------------------------------


CHURN_SLEEP = 2_000_000   # cycles, about 1 ms: longer than a wrapper's host time


def churn_inputs(rng, live, step, pcfg, K, F):
    """One mixed burst of `pool_churn`: a share of the live (shard, node)
    handles freed, plus junk, stale, duplicate and out-of-range handles;
    K lanes (70% at the leaf octave, the rest up to 4 octaves above) with
    ids whose hash wraps.  Returns (the live handles freed, (free nodes,
    free shards, free active, levels, active, lane ids))."""
    import numpy as np

    S, N, depth = pcfg.n_shards, pcfg.n_words, pcfg.tree.depth
    big_ids = np.array([2**31 - 1, 2**31 - 2, 2**30 + 7, -1, 2, 3], np.int32)
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
    return take, (fn, fs, fa, levels, act, ids)


def churn_live(live, take, nodes, shard):
    """The live handles after a burst freed `take` and served `nodes`."""
    import numpy as np

    freed = set(map(tuple, take.tolist()))
    keep = np.array([tuple(h) not in freed for h in live.tolist()], bool)
    live = live[keep] if len(live) else live
    nodes, shard = nodes.cpu().numpy(), shard.cpu().numpy()
    new = np.stack([shard[nodes > 0], nodes[nodes > 0]], 1).astype(np.int64)
    return np.concatenate([live, new])


def pool_churn(torch, dev, pcfg, steps, seed, K=256, F=8192):
    """Kernel A against its plain version over a seeded churn of mixed
    bursts: live handles freed in waves plus junk, stale, duplicate and
    out-of-range handles, then K lanes (70% at the leaf octave, the rest
    up to 4 octaves above) with ids whose hash wraps.  Every step's
    trees, nodes, shards, ok mask and stat slots must be identical, and
    the release half alone (`pool_free`) with its freed flags too.
    Returns the row of times and totals."""
    import numpy as np

    from repro_torch.core.pool import pool_free_round, pool_wavefront_step
    from repro_torch.kernels import nbbs_alloc

    cfg, S, depth = pcfg.tree, pcfg.n_shards, pcfg.tree.depth
    what = f"pool step {cfg.layout.name} S={S} depth {depth}" + (
        " fastpath" if pcfg.fastpath else "")
    rng = np.random.default_rng(seed)
    trees = pcfg.empty_trees(dev)
    live = np.zeros((0, 2), np.int64)        # (shard, node)
    kern_ms = plain_ms = 0.0
    tot = {"overflows": 0, "rounds": 0, "freed": 0, "won": 0, "fastpath_hits": 0,
           "fastpath_spills": 0}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    first_ms = None
    for step in range(steps):
        take, arrays = churn_inputs(rng, live, step, pcfg, K, F)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pool_wavefront_step(pcfg, trees, *args[:5], 64, args[5])
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        if first_ms is None:
            # one untimed launch (the first loads the kernel), read with
            # the wrapper's host time included
            ev0.record()
            nbbs_alloc.pool_step(pcfg, trees, *args)
            ev1.record()
            torch.cuda.synchronize()
            first_ms = ev0.elapsed_time(ev1)
        torch.cuda._sleep(CHURN_SLEEP)   # the wrapper's host time hides behind it
        ev0.record()
        got = nbbs_alloc.pool_step(pcfg, trees, *args)
        ev1.record()
        torch.cuda.synchronize()
        kern_ms += ev0.elapsed_time(ev1)
        for a, b, part in zip(want[:4], got[:4], ("trees", "nodes", "shard", "ok")):
            if not torch.equal(a, b):
                raise AssertionError(f"{what} step {step}: {part} differ")
        for k_ in want[4]:
            if int(want[4][k_]) != int(got[4][k_]):
                raise AssertionError(
                    f"{what} step {step}: stat {k_} {int(want[4][k_])} != {int(got[4][k_])}")
        # the release half alone, with its per-handle freed flags
        want_f = pool_free_round(pcfg, trees, *args[:3])
        got_f = nbbs_alloc.pool_free(pcfg, trees, *args[:3])
        if not (torch.equal(want_f[0], got_f[0]) and torch.equal(want_f[3], got_f[1])):
            raise AssertionError(f"pool free {what} step {step}: trees or freed differ")
        trees = got[0]
        for k_ in tot:
            if k_ != "won":
                tot[k_] += int(got[4][k_])
        tot["won"] += int((got[1] > 0).sum())
        live = churn_live(live, take, got[1], got[2])
    if S > 1 and tot["overflows"] == 0:
        raise AssertionError(f"the {what} churn never overflowed")
    if pcfg.fastpath is not None and tot["fastpath_hits"] == 0:
        raise AssertionError(f"the {what} churn never hit the slab")
    nbytes = 2 * S * pcfg.n_state_words * 4 + F * 12 + K * 12 + K * 8 + 28
    return dict(layout=cfg.layout.name, S=S, depth=depth, steps=steps, K=K, F=F,
                fastpath=pcfg.fastpath is not None,
                tier=nbbs_alloc.tier(cfg, S, K, pcfg.fp_state_words),
                ms=kern_ms / steps, first_launch_ms=first_ms, plain_ms=plain_ms / steps,
                bound_ms=nbytes / HBM_BPS * 1e3, bound_by="bytes", max_abs_err=0, **tot)


def log_churn(tag, row):
    log(f"[{tag}] {row['layout']} S={row['S']} depth={row['depth']}"
        f"{' fastpath' if row['fastpath'] else ''} ({row['tier']} memory): {row['steps']} "
        f"steps bit-identical (overflows {row['overflows']}, rounds {row['rounds']}, won "
        f"{row['won']}, freed {row['freed']}, slab hits {row['fastpath_hits']}, spills "
        f"{row['fastpath_spills']}); kernel {row['ms']:.4f} ms/launch (first, untimed "
        f"launch with host time {row['first_launch_ms']:.4f} ms), plain "
        f"{row['plain_ms']:.3f} ms/call, bound {row['bound_ms']:.6f} ms")


CHURN_POOLS = ((0, 1, 12), (0, 4, 10), (1, 1, 12), (1, 4, 10))  # (packed, S, depth)


def phase_alloc(torch, dev, report):
    from repro_torch.core.concurrent import BUNCH_PACKED, UNPACKED, TreeConfig
    from repro_torch.core.pool import PoolConfig

    rows = []
    for packed, S, depth in CHURN_POOLS:
        layout = BUNCH_PACKED if packed else UNPACKED
        row = pool_churn(torch, dev, PoolConfig(TreeConfig(depth=depth, layout=layout), S),
                         200, depth)
        log_churn("alloc", row)
        rows.append(row)
    report["alloc"] = rows
    return rows


def leaf_bursts(torch, dev, fpc, plain, steps, seed, K=256):
    """Pure leaf-octave bursts through kernel A on a fastpath pool and
    on the same pool uncarved: the slab's find-first-zero order is the
    plain pool's rank order over the leftmost leaves, so nodes, shards
    and ok masks must be equal address for address."""
    import numpy as np

    from repro_torch.kernels import nbbs_alloc

    depth, S = fpc.tree.depth, fpc.n_shards
    rng = np.random.default_rng(seed)
    ta, tb = fpc.empty_trees(dev), plain.empty_trees(dev)
    live = np.zeros((0, 2), np.int64)
    hits = spills = 0
    levels = torch.full((K,), depth, dtype=torch.int32, device=dev)
    for step in range(steps):
        take = live[rng.random(len(live)) < (0.5 if step % 3 == 2 else 0.0)]
        F = 2 * K
        fn, fs, fa = np.zeros(F, np.int32), np.zeros(F, np.int32), np.zeros(F, bool)
        n = min(len(take), F)
        fs[:n], fn[:n], fa[:n] = take[:n, 0], take[:n, 1], True
        act = rng.random(K) < 0.9
        ids = rng.integers(0, 100_000, size=K).astype(np.int32)
        args = [torch.from_numpy(a).to(dev) for a in (fn, fs, fa)]
        a2 = [torch.from_numpy(a).to(dev) for a in (act, ids)]
        ga = nbbs_alloc.pool_step(fpc, ta, *args, levels, *a2)
        gb = nbbs_alloc.pool_step(plain, tb, *args, levels, *a2)
        for x, y, part in zip(ga[1:4], gb[1:4], ("nodes", "shard", "ok")):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"leaf bursts {fpc.tree.layout.name} S={S} step {step}: {part} differ "
                    "from the uncarved pool")
        if int(ga[4]["freed"]) != int(gb[4]["freed"]):
            raise AssertionError(f"leaf bursts S={S} step {step}: freed differs")
        hits += int(ga[4]["fastpath_hits"])
        spills += int(ga[4]["fastpath_spills"])
        ta, tb = ga[0], gb[0]
        freed = set(map(tuple, take[:n].tolist()))
        keep = np.array([tuple(h) not in freed for h in live.tolist()], bool)
        live = live[keep] if len(live) else live
        nodes, shard = ga[1].cpu().numpy(), ga[2].cpu().numpy()
        live = np.concatenate([live, np.stack([shard[nodes > 0], nodes[nodes > 0]], 1)])
    if hits == 0:
        raise AssertionError("leaf bursts never hit the slab")
    return dict(layout=fpc.tree.layout.name, S=S, depth=depth, steps=steps, K=K,
                fastpath_hits=hits, fastpath_spills=spills)


def engine_shape_rows(torch, dev, pcfg):
    """Kernel A and its plain version at the engine's own shapes on a
    pool holding 2048 leaf pages: one boundary alloc (K=256 leaf lanes,
    F=0) and one retirement burst (F=8192 handles of a 256 x 32 block
    table, the 2048 live ones active, K=0)."""
    from repro_torch.core.pool import pool_free_round, pool_wavefront_step
    from repro_torch.kernels import nbbs_alloc

    S, depth, W = pcfg.n_shards, pcfg.tree.depth, pcfg.n_state_words
    K, F, live = 256, 8192, 2048
    i32 = dict(dtype=torch.int32, device=dev)
    none = torch.zeros(0, **i32)
    levels = torch.full((K,), depth, **i32)
    act = torch.ones(K, dtype=torch.bool, device=dev)
    trees = pcfg.empty_trees(dev)
    fn, fs = torch.zeros(F, **i32), torch.zeros(F, **i32)
    for j in range(live // K):
        trees, nodes, shard, ok, _ = nbbs_alloc.pool_step(
            pcfg, trees, none, none, none, levels, act, torch.arange(K, **i32) + j * K)
        if not bool(ok.all()):
            raise AssertionError("engine-shape fill failed")
        fn[j * K:(j + 1) * K], fs[j * K:(j + 1) * K] = nodes, shard
    fa = torch.arange(F, device=dev) < live
    ids = torch.arange(K, **i32) + live
    rows = []
    for what, kern, plain, nbytes in (
        ("alloc K=256 F=0",
         lambda: nbbs_alloc.pool_step(pcfg, trees, none, none, none, levels, act, ids),
         lambda: pool_wavefront_step(pcfg, trees, none, none, none.bool(), levels, act, 64,
                                     ids),
         2 * S * W * 4 + K * 12 + K * 8 + 28),
        ("free F=8192 K=0",
         lambda: nbbs_alloc.pool_free(pcfg, trees, fn, fs, fa),
         lambda: pool_free_round(pcfg, trees, fn, fs, fa),
         2 * S * W * 4 + F * 12 + F * 4 + 28),
    ):
        want, got = plain(), kern()
        for a, b in zip(want[:1], got[:1]):
            if not torch.equal(a, b):
                raise AssertionError(f"engine shapes {what}: trees differ")
        rows.append(dict(shape=what, layout=pcfg.tree.layout.name, S=S, depth=depth,
                         fastpath=pcfg.fastpath is not None,
                         tier=nbbs_alloc.tier(pcfg.tree, S, K, pcfg.fp_state_words),
                         ms=queued_ms(torch, kern), plain_ms=host_ms(torch, plain),
                         bound_ms=nbytes / HBM_BPS * 1e3, bound_by="bytes"))
    return rows


def phase_fastpath(torch, dev, report):
    """Kernel A with the fastpath slab against its plain version: the
    alloc phase's churn (same seeds) on carved pools in both layouts and
    at depths 14 and 16 (the device-memory tier), pure leaf bursts against
    an uncarved pool, and both kernels at the engine's own shapes."""
    from repro_torch.core.concurrent import BUNCH_PACKED, UNPACKED, TreeConfig
    from repro_torch.core.fastpath import FastPathConfig
    from repro_torch.core.pool import PoolConfig

    fp = FastPathConfig(level=None, slab_level=2)
    no_slab = {(r["layout"], r["S"], r["depth"]): r["ms"] for r in report.get("alloc", [])}
    rows, leaf, shapes = [], [], []
    for packed, S, depth in CHURN_POOLS + ((0, 1, 14), (0, 1, 16)):
        layout = BUNCH_PACKED if packed else UNPACKED
        tree = TreeConfig(depth=depth, layout=layout)
        steps = 200 if depth < 14 else 30 if depth == 14 else 10
        row = pool_churn(torch, dev, PoolConfig(tree, S, fastpath=fp), steps, depth)
        if (layout.name, S, depth) not in no_slab:   # not in phase alloc: time both here
            no_slab[(layout.name, S, depth)] = pool_churn(
                torch, dev, PoolConfig(tree, S), steps, depth)["ms"]
        row["ms_no_slab"] = no_slab[(layout.name, S, depth)]
        log_churn("fastpath", row)
        log(f"[fastpath]   against the same churn without the slab: "
            f"{row['ms_no_slab']:.4f} ms/launch")
        rows.append(row)
        if depth < 14:
            lb = leaf_bursts(torch, dev, PoolConfig(tree, S, fastpath=fp), PoolConfig(tree, S),
                             30, depth + 1)
            log(f"[fastpath] pure leaf bursts {layout.name} S={S} depth={depth}: "
                f"{lb['steps']} x K={lb['K']} address-identical to the uncarved pool "
                f"(slab hits {lb['fastpath_hits']}, spills {lb['fastpath_spills']})")
            leaf.append(lb)
    for S, depth in ((1, 12), (4, 10)):
        tree = TreeConfig(depth=depth)
        for pcfg in (PoolConfig(tree, S), PoolConfig(tree, S, fastpath=fp)):
            for r in engine_shape_rows(torch, dev, pcfg):
                log(f"[fastpath] engine shapes S={S} depth={depth}"
                    f"{' fastpath' if r['fastpath'] else ''} {r['shape']} ({r['tier']}): "
                    f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
                    f"{r['bound_ms']:.6f} ms")
                shapes.append(r)
    report["fastpath"] = dict(rows=rows, leaf_bursts=leaf, engine_shapes=shapes)


def phase_frontends(torch, dev, report):
    """The churn loops of `benchmarks/bench_constant_occupancy.py`
    (`fastpath_sweep` and `magazine_sweep`), copied here, on the card
    through `ops.nbbs_pool_wavefront_step` (`mags=` where the sweep has
    magazines).  Every counter must equal the committed
    BENCH_FASTPATH.json and BENCH_MAGAZINE.json records."""
    from repro_torch.core.concurrent import TreeConfig
    from repro_torch.core.fastpath import FastPathConfig
    from repro_torch.core.magazine import MagazineConfig
    from repro_torch.core.pool import PoolConfig, pool_init_magazines
    from repro_torch.kernels import ops

    def records(name):
        return json.loads((ROOT / name).read_text())["records"]

    i32 = dict(dtype=torch.int32, device=dev)
    out = {"fastpath_sweep": [], "magazine_sweep": []}
    for rec in records("BENCH_FASTPATH.json"):
        d, want = rec["dims"], rec["metrics"]
        S, depth, W, churn = d["n_shards"], d["depth"], d["width"], d["churn_steps"]
        fp = FastPathConfig(level=None, slab_level=2) if d["fastpath"] else None
        pcfg = PoolConfig(TreeConfig(depth=depth), S, fastpath=fp)
        levels = torch.full((W,), depth, **i32)
        zeros = torch.zeros(W, **i32)
        trees, nodes, shard, ok, _ = ops.nbbs_pool_wavefront_step(
            pcfg, pcfg.empty_trees(dev), zeros, zeros, zeros.bool(), levels)
        keys = ("merged_writes", "logical_rmws", "free_merged_writes", "free_logical_rmws",
                "fastpath_hits", "fastpath_spills")
        tot = dict.fromkeys(keys, 0)
        t0 = time.perf_counter()
        for _ in range(churn):
            trees, nodes, shard, ok, st = ops.nbbs_pool_wavefront_step(
                pcfg, trees, nodes, shard, ok, levels)
            for k in keys:
                tot[k] += int(st[k])
        wall = time.perf_counter() - t0
        ops_n = churn * W
        tot["merged_per_op"] = (tot["merged_writes"] + tot["free_merged_writes"]) / ops_n
        tot["logical_per_alloc"] = tot["logical_rmws"] / ops_n
        diff = {k: (v, want[k]) for k, v in tot.items() if v != want[k]}
        if diff or not bool(ok.all()):
            raise AssertionError(f"fastpath_sweep {d}: card differs from the record: {diff}")
        log(f"[frontends] fastpath_sweep S={S} fastpath={d['fastpath']} W={W}: equal to "
            f"BENCH_FASTPATH.json ({tot['logical_per_alloc']} logical RMWs/alloc, "
            f"{tot['merged_per_op']} merged writes/op, hits {tot['fastpath_hits']}); "
            f"{wall * 1e3 / churn:.3f} ms/step")
        out["fastpath_sweep"].append(dict(dims=d, **tot, ms_per_step=wall * 1e3 / churn))
    for rec in records("BENCH_MAGAZINE.json"):
        d, want = rec["dims"], rec["metrics"]
        cap, S, depth, W, churn = (d["mag_cap"], d["n_shards"], d["depth"], d["width"],
                                   d["churn_steps"])
        L = W // d["lanes_per_mag"]
        pcfg = PoolConfig(TreeConfig(depth=depth), S,
                          magazines=MagazineConfig(mag_cap=cap) if cap else None)
        levels = torch.full((W,), depth, **i32)
        zeros = torch.zeros(W, **i32)
        mag_lane = torch.arange(W, **i32) % L
        keys = ("logical_rmws", "free_logical_rmws", "magazine_hits", "magazine_spills")
        tot = dict.fromkeys(keys, 0)
        t0 = time.perf_counter()
        if cap:
            trees, mags, nodes, shard, ok, _ = ops.nbbs_pool_wavefront_step(
                pcfg, pcfg.empty_trees(dev), zeros, zeros, zeros.bool(), levels,
                mags=pool_init_magazines(pcfg, L, dev))
            for _ in range(churn):
                trees, mags, nodes, shard, ok, st = ops.nbbs_pool_wavefront_step(
                    pcfg, trees, nodes, shard, ok, levels, mags=mags,
                    free_mag_lane=mag_lane, alloc_mag_lane=mag_lane)
                for k in keys:
                    tot[k] += int(st[k])
        else:
            trees, nodes, shard, ok, _ = ops.nbbs_pool_wavefront_step(
                pcfg, pcfg.empty_trees(dev), zeros, zeros, zeros.bool(), levels)
            for _ in range(churn):
                trees, nodes, shard, ok, st = ops.nbbs_pool_wavefront_step(
                    pcfg, trees, nodes, shard, ok, levels)
                tot["logical_rmws"] += int(st["logical_rmws"])
                tot["free_logical_rmws"] += int(st["free_logical_rmws"])
        wall = time.perf_counter() - t0
        tot["rmws_per_op"] = (tot["logical_rmws"] + tot["free_logical_rmws"]) / (2 * churn * W)
        diff = {k: (v, want[k]) for k, v in tot.items() if v != want[k]}
        if diff or not bool(ok.all()):
            raise AssertionError(f"magazine_sweep {d}: card differs from the record: {diff}")
        log(f"[frontends] magazine_sweep mag_cap={cap}: equal to BENCH_MAGAZINE.json "
            f"({tot['rmws_per_op']} RMWs/op, hits {tot['magazine_hits']}, spills "
            f"{tot['magazine_spills']}); {wall * 1e3 / churn:.3f} ms/step")
        out["magazine_sweep"].append(dict(dims=d, **tot, ms_per_step=wall * 1e3 / churn))
    report["frontends"] = out


# ---------------------------------------------------------------------------
# Phase 4: the single-tree path (kernels 3 and 4)
# ---------------------------------------------------------------------------


def _same(torch, want, got, what):
    for a, b, part in zip(want[:3], got[:3], ("tree", "nodes", "ok")):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {part} differ")


def single_tree_rows(torch, dev, layout):
    """Kernels 4 and 3 against their plain versions at the benchmarks'
    shapes: one alloc burst on an empty tree, then a step that frees
    half of it (F=K/2 handles of the live set) and allocates again."""
    import numpy as np

    from repro_torch.core import concurrent as conc
    from repro_torch.core.concurrent import TreeConfig
    from repro_torch.kernels import nbbs_alloc

    shapes = [(14, K, 6, 3) for K in (1, 16, 256)] + [(12, 128, 7, 2), (16, 256, 6, 4)]
    rows = []
    for depth, K, octaves, seed in shapes:
        cfg = TreeConfig(depth=depth, layout=layout)
        rng = np.random.default_rng(seed)
        levels = torch.from_numpy(
            rng.integers(depth - octaves, depth + 1, size=K).astype(np.int32)).to(dev)
        act = torch.ones(K, dtype=torch.bool, device=dev)
        empty = cfg.empty_tree(dev)
        want = conc.wavefront_alloc(cfg, empty, levels, act)
        got = nbbs_alloc.wavefront_alloc(cfg, empty, levels, act)
        what = f"kernel 4 {layout.name} depth {depth} K={K}"
        _same(torch, want, got, what)
        slots = ("rounds", "merged_writes", "logical_rmws")
        if [int(want[3][k]) for k in slots] != got[3].tolist():
            raise AssertionError(f"{what}: stats differ")
        tree, nodes, ok = got[:3]
        F = K // 2
        fn, fa = nodes[:F].contiguous(), ok[:F].contiguous()
        want3 = conc.wavefront_step(cfg, tree, fn, fa, levels, act)
        got3 = nbbs_alloc.wavefront_step(cfg, tree, fn, fa, levels, act)
        what3 = f"kernel 3 {layout.name} depth {depth} K={K} F={F}"
        _same(torch, want3, got3, what3)
        slots3 = slots + ("free_merged_writes", "free_logical_rmws", "freed")
        if [int(want3[3][k]) for k in slots3] != got3[3].tolist():
            raise AssertionError(f"{what3}: stats differ")
        W = cfg.n_state_words
        for name, ms, plain, stats, nbytes in (
            ("nbbs_wavefront_alloc",
             queued_ms(torch, lambda: nbbs_alloc.wavefront_alloc(cfg, empty, levels, act)),
             host_ms(torch, lambda: conc.wavefront_alloc(cfg, empty, levels, act)),
             got[3].tolist(), 8 * W + 9 * K + 12),
            ("nbbs_wavefront_step",
             queued_ms(torch, lambda: nbbs_alloc.wavefront_step(cfg, tree, fn, fa, levels, act)),
             host_ms(torch, lambda: conc.wavefront_step(cfg, tree, fn, fa, levels, act)),
             got3[3].tolist(), 8 * W + 9 * K + 9 * F + 24),
        ):
            row = dict(kernel=name, layout=layout.name, depth=depth, K=K,
                       F=F if name == "nbbs_wavefront_step" else 0,
                       tier=nbbs_alloc.tier(cfg, 1, K), ms=ms, plain_ms=plain,
                       bound_ms=nbytes / HBM_BPS * 1e3, bound_by="bytes",
                       max_abs_err=0, stats=stats)
            log(f"[single_tree] {name} {layout.name} depth {depth} K={K} F={row['F']} "
                f"({row['tier']} memory): bit-identical, stats {stats}; kernel "
                f"{ms:.4f} ms/launch, plain {plain:.3f} ms/call, bound "
                f"{row['bound_ms']:.6f} ms")
            rows.append(row)
    return rows


def single_op_on_card(torch, dev, layout, calls=160):
    """The single-op API on a 16K-unit tree: seeded nb_alloc /
    nb_alloc_size / nb_free / nb_free_batch calls (junk and double frees
    included), with the state held against a CPU replay at the end."""
    import numpy as np

    from repro_torch.core import nbbs
    from repro_torch.core.concurrent import TreeConfig

    depth, total = 14, 1 << 20
    cfg = TreeConfig(depth=depth, layout=layout)
    rng = np.random.default_rng(7)
    states = {d: nbbs.init_state(cfg, d) for d in (dev, torch.device("cpu"))}
    live, n_ok = [], 0
    for i in range(calls):
        r = rng.random()
        if r < 0.45:
            lev = int(rng.integers(depth - 8, depth + 1))
            res = {d: nbbs.nb_alloc(cfg, st, lev) for d, st in states.items()}
        elif r < 0.7:
            size = int(rng.integers(64, 1 << 16))
            res = {d: nbbs.nb_alloc_size(cfg, st, total, size) for d, st in states.items()}
        elif r < 0.85 and live:
            off = live.pop(int(rng.integers(len(live))))
            states = {d: nbbs.nb_free(cfg, st, off) for d, st in states.items()}
            continue
        else:
            burst = live[: len(live) // 2] + [-1, 1 << depth] + live[:1]
            live = live[len(live) // 2:]
            offs = np.array(burst, np.int32)
            act = np.ones(len(burst), bool)
            res = {d: nbbs.nb_free_batch(cfg, st, torch.from_numpy(offs).to(d),
                                         torch.from_numpy(act).to(d))
                   for d, st in states.items()}
            if not torch.equal(res[dev][1].cpu(), res[torch.device("cpu")][1]):
                raise AssertionError(f"single-op {layout.name} call {i}: freed differs")
            states = {d: r_[0] for d, r_ in res.items()}
            continue
        (st_d, off_d, ok_d), (st_c, off_c, ok_c) = res[dev], res[torch.device("cpu")]
        if int(off_d) != int(off_c) or bool(ok_d) != bool(ok_c):
            raise AssertionError(f"single-op {layout.name} call {i}: offset differs")
        states = {dev: st_d, torch.device("cpu"): st_c}
        if bool(ok_d):
            live.append(int(off_d))
            n_ok += 1
    for a, b in zip(states[dev], states[torch.device("cpu")]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"single-op {layout.name}: state differs from CPU replay")
    return dict(layout=layout.name, calls=calls, allocated=n_ok, live=len(live))


def phase_single_tree(torch, dev, report, state):
    from repro_torch.core.concurrent import BUNCH_PACKED, UNPACKED
    from repro_torch.examples import quickstart
    from repro_torch.kernels import nbbs_alloc

    rows = single_tree_rows(torch, dev, UNPACKED) + single_tree_rows(torch, dev, BUNCH_PACKED)
    # the user's single-tree path, with every launch count at 0
    nbbs_alloc.wavefront_alloc_launches = 0
    nbbs_alloc.wavefront_step_launches = 0
    quick = quickstart.run(dev, out=lambda *a: None)   # examples/quickstart.py's twin
    api = [single_op_on_card(torch, dev, layout) for layout in (UNPACKED, BUNCH_PACKED)]
    launches = {"nbbs_wavefront_alloc": nbbs_alloc.wavefront_alloc_launches,
                "nbbs_wavefront_step": nbbs_alloc.wavefront_step_launches}
    log(f"[single_tree] quickstart §3-§6 on the card: {quick}")
    log(f"[single_tree] single-op API on a 16K-unit tree, equal to the CPU replay: {api}")
    log(f"[single_tree] single-tree path launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the single-tree path")
    state["launches"] = {**state.get("launches", {}), **launches}
    report["single_tree"] = dict(rows=rows, quickstart=quick, single_op=api,
                                 launches=launches,
                                 tier_launches=dict(nbbs_alloc.tier_launches))


# ---------------------------------------------------------------------------
# Phases 5, 6 and 8: the jit engine
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


# (S, layout, front ends, requests arriving per decode chunk; None: all
# at once).  With all 64 requests at once each takes its own lane of 256
# and no lane is used twice; the front-end runs let 16 arrive per chunk,
# so later requests take the lanes of retired ones and their magazines.
# The last run is the first with the event ring on.  Every run decodes
# in fused chunks (a CUDA graph replay each, after the first chunk);
# EAGER_RUN is the first run again through the eager loop, the
# reference that the fused S=1 run must reproduce.
RING_RUN = (1, "unpacked", {"ring_capacity": 4096}, None)
ENGINE_RUNS = (
    (1, "unpacked", {}, None), (4, "unpacked", {}, None), (4, "bunch-packed", {}, None),
    (1, "unpacked", {"fastpath": True}, 16), (4, "unpacked", {"fastpath": True}, 16),
    (4, "bunch-packed", {"fastpath": True, "magazines": 4}, 16), RING_RUN,
)
EAGER_RUN = ENGINE_RUNS[0]


def run_name(S, layout, kw, per_chunk=None, fused=True):
    return f"S{S}-{layout}" + "".join(f"-{k}" for k in sorted(kw)) + (
        f"-arrivals{per_chunk}" if per_chunk else "") + ("" if fused else "-eager")


def run_engine(torch, cfg, params, dev, dtype, S, trace, layout="unpacked", per_chunk=None,
               fused=True, **kw):
    """Serve `trace` to completion, `per_chunk` requests arriving before
    each decode chunk (all at once if None), through
    `run_to_completion(chunk=CHUNK)`: fused chunks, or with `fused=False`
    the eager loop.  On the card every decode chunk, the first fused
    one's warm-up and capture included, runs under
    torch.cuda.set_sync_debug_mode("error") (a host sync raises) between
    two CUDA events."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.jit_engine import JitServeEngine

    eng = JitServeEngine(cfg, params, dtype=dtype, device=dev, n_shards=S,
                         layout=layout, **GEOM, **kw)
    chunks = []
    inner, run_fused = eng.decode_steps, fused

    def timed(n, fused=False):
        if dev.type != "cuda":
            return inner(n, fused=fused and run_fused)
        no_sync_chunk(torch, inner, n, fused and run_fused, chunks)

    eng.decode_steps = timed
    pending = list(trace)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        for i, p, mn in pending[:per_chunk or len(pending)]:
            eng.submit(Request(i, p.copy(), mn))
        del pending[:per_chunk or len(pending)]
        eng.run_to_completion(max_steps=CHUNK if pending else 10_000, chunk=CHUNK)
        if not pending:
            break
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
    nbbs_alloc.slab_launches = 0
    pa.launches = 0
    for S, layout, kw, per_chunk, fused in [(*EAGER_RUN, False)] + [
            (*r, True) for r in ENGINE_RUNS]:
        name = run_name(S, layout, kw, per_chunk, fused)
        a0, b0 = nbbs_alloc.launches, pa.launches
        eng, wall, chunks, decode_ms = run_engine(
            torch, cfg, params, dev, torch.bfloat16, S, trace, layout, per_chunk, fused,
            **kw)
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
        # kernel A: one boundary alloc and one retirement burst per step,
        # one alloc and one rollback per admission; the magazine path
        # adds its spill-back and retry launch to every alloc
        per = 3 if kw.get("magazines") else 2
        admits = eng.stats["admitted"] + eng.stats["queued_full"]
        want_launches = per * (steps + admits)
        if nbbs_alloc.launches - a0 != want_launches:
            raise AssertionError(f"{name}: {nbbs_alloc.launches - a0} kernel A launches, "
                                 f"expected {want_launches}")
        if pa.launches - b0 != cfg.n_layers * steps:
            raise AssertionError(f"{name}: {pa.launches - b0} kernel B launches, expected "
                                 f"{cfg.n_layers} per step")
        if len(eng._graphs) != (fused and dev.type == "cuda"):   # one chunk length
            raise AssertionError(f"{name}: {len(eng._graphs)} graphs captured")
        if kw.get("fastpath") and tot["fastpath_hits"] <= 0:
            raise AssertionError(f"{name}: the slab served no page")
        if kw.get("magazines") and tot["magazine_hits"] <= 0:
            raise AssertionError(f"{name}: the magazines served no page")
        row = dict(
            run=name, S=S, layout=layout, fused=fused, decode_steps=steps, tokens=tokens,
            wall_s=wall, first_chunk_ms=decode_ms[0],
            decode_ms_per_step=dec / steps, steady_decode_ms_per_step=steady,
            tokens_per_s=tokens / (dec / 1e3), wall_tokens_per_s=tokens / wall,
            alloc_pages=tot["alloc_pages"], freed_pages=tot["freed_pages"],
            probe_overflows=tot["probe_overflows"],
            merged_writes=tot["merged_writes"],
            free_merged_writes=tot["free_merged_writes"],
            nbbs_launches=nbbs_alloc.launches - a0,
            attention_launches=pa.launches - b0,
            **{k: tot[k] for k in ("fastpath_hits", "fastpath_spills", "magazine_hits",
                                   "magazine_spills", "admit_fastpath_hits",
                                   "admit_magazine_spills")},
        )
        log(f"[engine] {name}: {steps} decode steps, {tokens} tokens, alloc "
            f"{row['alloc_pages']} freed {row['freed_pages']} pages, merged writes "
            f"{row['merged_writes']} alloc / {row['free_merged_writes']} free; decode "
            f"{row['decode_ms_per_step']:.2f} ms/step (steady "
            f"{steady:.2f}), {row['tokens_per_s']:.1f} tokens/s decode, "
            f"{row['wall_tokens_per_s']:.1f} tokens/s wall ({wall:.2f} s); launches "
            f"nbbs {row['nbbs_launches']} (= {per} x (steps + admissions)) attention "
            f"{row['attention_launches']}; slab hits {tot['fastpath_hits']} spills "
            f"{tot['fastpath_spills']}, magazine hits {tot['magazine_hits']} spills "
            f"{tot['magazine_spills']}")
        rows.append(row)
        state[name] = (list(eng.retired_order), dict(eng.done_steps), tot)
        state["tokens", name] = {i: r.out_tokens for i, r in eng.completed.items()}
        if kw.get("ring_capacity"):
            state["ring_events"] = check_ring_run(eng, state, row)
        del eng
        gc.collect()   # the engine's KV pool and graph
    # nodes are identical on valid traces, so the schedule is too
    if state["S4-bunch-packed"][:2] != state["S4-unpacked"][:2]:
        raise AssertionError("packed S=4 retirement order or steps differ from unpacked")
    eager, fused = run_name(*EAGER_RUN, fused=False), run_name(*EAGER_RUN)
    if state[fused] != state[eager] or state["tokens", fused] != state["tokens", eager]:
        raise AssertionError("the fused S=1 run's schedule, counters or tokens differ "
                             "from the eager run's")
    e, f = rows[0], rows[1]
    report["eager_vs_fused"] = dict(
        eager_ms_per_step=e["steady_decode_ms_per_step"],
        fused_ms_per_step=f["steady_decode_ms_per_step"],
        eager_tokens_per_s=e["tokens_per_s"], fused_tokens_per_s=f["tokens_per_s"],
        step_speedup=e["steady_decode_ms_per_step"] / f["steady_decode_ms_per_step"])
    log(f"[engine] S=1 eager vs fused: steady {e['steady_decode_ms_per_step']:.3f} vs "
        f"{f['steady_decode_ms_per_step']:.3f} ms/step, {e['tokens_per_s']:.1f} vs "
        f"{f['tokens_per_s']:.1f} tokens/s decode; schedule, every counter and every "
        f"token equal")
    launches = {"nbbs_pool_step": nbbs_alloc.launches,
                "nbbs_pool_step_slab": nbbs_alloc.slab_launches,
                "paged_attention": pa.launches}
    log(f"[engine] main-path launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    report["engine"] = rows
    state["launches"] = {**state.get("launches", {}), **launches}
    del params
    torch.cuda.empty_cache()
    return rows


def check_ring_run(eng, state, row):
    """The ring run against the ring-less S=1 run: the same schedule and
    counters (but `ring_dropped`: a zero-capacity ring drops every
    event), no event dropped, a snapshot that validates and renders.
    Returns the drained events."""
    from repro_torch.obs.trace_export import save_trace, validate_snapshot

    order, done, tot = state[run_name(1, "unpacked", {})]
    ring_order, ring_done, ring_tot = state[run_name(*RING_RUN)]
    if (ring_order, ring_done) != (order, done):
        raise AssertionError("the ring run's schedule differs from the S=1 run's")
    diff = {k: (v, ring_tot[k]) for k, v in tot.items()
            if k != "ring_dropped" and ring_tot[k] != v}
    if diff or ring_tot["ring_dropped"] != 0 or tot["ring_dropped"] != tot["ring_events"]:
        raise AssertionError(f"the ring run's counters differ from the S=1 run's: {diff}")
    snap = eng.snapshot()
    validate_snapshot(snap)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    save_trace(snap, str(out / "engine_ring.trace.json"))
    events = snap["events"]
    if len(events) != ring_tot["ring_events"] or [e["step"] for e in events] != list(
            range(ring_tot["steps"])):
        raise AssertionError(f"{len(events)} events drained for "
                             f"{ring_tot['ring_events']} pushed")
    row["ring_events"] = len(events)
    row["spans"] = len(snap["spans"])
    log(f"[engine] {row['run']}: {len(events)} ring events drained, {len(snap['spans'])} "
        f"host spans; schedule and counters equal to the ring-less S=1 run; the "
        f"snapshot validates and renders (chiprun_out/engine_ring.trace.json)")
    return events


# spin kernels that open every device trace (`traced`)
LEAD_IN = 4096


def on_card(e):
    return str(getattr(e, "device_type", "")).endswith("CUDA")


class traced:
    """A `torch.profiler` window (`activities`, CPU and CUDA by default)
    that on a card opens with LEAD_IN spin kernels (`torch.cuda._sleep(0)`)
    and a sync.  A process that has traced much before loses the first
    device records of a later trace, more of them the more it traced
    (`--trace-loss` measures it: a fused window's first kernels, a kernel
    A launch among them, or a short trace's every kernel); the lead-in
    takes that loss.  After the
    window, `events` holds the trace's events without the lead-in's
    device records and `lost` the count of those the trace lost (LEAD_IN
    when it lost them all: the traced work may then have lost records
    too, which the caller's counts show)."""

    def __init__(self, torch, activities=None, lead_in=True):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.lead = lead_in and torch.cuda.is_available()
        self.prof = profile(activities=activities
                            or [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.events, self.lost = [], 0

    def __enter__(self):
        self.prof.__enter__()
        if self.lead:
            for _ in range(LEAD_IN):
                self.torch.cuda._sleep(0)
            self.torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = list(self.prof.events())
        lead = []
        if self.lead:   # the lead-in precedes every other device record
            for e in sorted((e for e in events if on_card(e)),
                            key=lambda e: e.time_range.start):
                if "spin_kernel" not in e.name:
                    break
                lead.append(e)
            self.lost = LEAD_IN - len(lead)
        skip = set(map(id, lead))
        self.events = [e for e in events if id(e) not in skip]
        return False


def device_busy(events):
    """Union of the device intervals of `events`, in us."""
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


# the functions `engine_step` calls, timed on the host as spans of the
# eager step's CPU profile (`record_function`), by the name the engine
# module imports them under
STEP_PARTS = ("nb_pool_alloc_pages", "nb_pool_alloc_pages_mag", "paged_decode_step",
              "nb_pool_free_pages", "nb_pool_free_pages_mag", "pool_free_units",
              "pool_mag_free_per_shard", "pool_largest_run", "home_shard")


def eager_step_profile(torch, eng):
    """Host time of one eager decode step by op and by part of the step:
    a CPU-side `torch.profiler` window of `decode_steps(1)`, each of
    STEP_PARTS wrapped in a `record_function` span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.serve import jit_engine as je

    def spanned(name, fn):
        def run(*a, **kw):
            with record_function(f"part:{name}"):
                return fn(*a, **kw)
        return run

    saved = {n: getattr(je, n) for n in STEP_PARTS}
    for n, fn in saved.items():
        setattr(je, n, spanned(n, fn))
    try:
        unprofiled_ms = host_ms(torch, lambda: eng.decode_steps(1))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("part:step"):
                eng.decode_steps(1)
            profiled_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(je, n, fn)
    parts: dict = {}
    for e in prof.events():
        if e.name.startswith("part:") and str(e.device_type).endswith("CPU"):
            parts[e.name[5:]] = parts.get(e.name[5:], 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    avg = prof.key_averages()
    ops = sorted((e for e in avg if e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)
    launches = sum(e.count for e in avg if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC"))
    step_ms = parts.get("step", profiled_ms)
    out = dict(
        unprofiled_ms=unprofiled_ms, profiled_ms=profiled_ms, step_span_ms=step_ms,
        aten_calls=sum(e.count for e in ops),
        aten_self_cpu_ms=sum(e.self_cpu_time_total for e in ops) / 1e3,
        kernel_launch_calls=launches,
        parts_ms={k: v for k, v in parts.items() if k != "step"},
        rest_ms=step_ms - sum(v for k, v in parts.items() if k != "step"),
        top_ops=[(e.key, e.count, e.self_cpu_time_total / 1e3) for e in ops[:15]],
    )
    log(f"[profile] one eager step: {unprofiled_ms:.2f} ms without the profiler; on "
        f"the host under it: {profiled_ms:.2f} ms ({step_ms:.2f} in the "
        f"step span), {out['aten_calls']} aten calls taking {out['aten_self_cpu_ms']:.2f} "
        f"ms of self CPU time, {launches} kernel launch calls")
    for k, v in sorted(out["parts_ms"].items(), key=lambda kv: -kv[1]):
        log(f"[profile]   part {k}: {v:.3f} ms")
    log(f"[profile]   rest of the step (state updates, metrics, ring): "
        f"{out['rest_ms']:.3f} ms")
    for key, count, ms in out["top_ops"]:
        log(f"[profile]   op {key}: {count} calls, {ms:.3f} ms self CPU")
    return out


def fused_window(torch, eng, trace, n_layers, fused_step, tag):
    """Admit `trace` into `eng`, run one fused chunk (warm-up and
    capture), then a `torch.profiler` window of two graph replays: the
    device busy ms per step and idle share, kernels by device time, and
    kernels A and B per step (2 and `n_layers`, counted from the device
    events); `fused_step` is the unprofiled ms per fused step."""
    from repro_torch.serve.engine import Request

    for i, p, mn in trace:
        eng.submit(Request(i, p.copy(), mn))
    eng._admit()
    eng.decode_steps(CHUNK, fused=True)   # warm-up and capture
    torch.cuda.synchronize()
    chunks = 2
    steps = chunks * CHUNK
    want = {"nbbs_step_kernel": 2, "paged_decode_kernel": n_layers}
    lost = []
    for _ in range(3):   # a trace now and then comes back without its kernels
        with traced(torch) as tr:
            t0 = time.perf_counter()
            for _ in range(chunks):
                eng.decode_steps(CHUNK, fused=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        lost.append(tr.lost)
        events = [e for e in tr.events if on_card(e)]
        counts = {k: sum(k in e.name for e in events) for k in want}
        if counts == {k: n * steps for k, n in want.items()}:
            break
    else:
        raise AssertionError(f"device events of kernels A and B in {steps} fused steps: "
                             f"{counts}, expected {want} per step (lead-in records lost "
                             f"by each trace: {lost} of {LEAD_IN})")
    busy = device_busy(events)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    ours = {}
    for key, name in (("nbbs_step_kernel", "nbbs_pool_step"),
                      ("paged_decode_kernel", "paged_attention")):
        hits = [e for e in events if key in e.name]
        ms = sum(e.time_range.end - e.time_range.start for e in hits) / 1e3
        ours[name] = dict(launches_per_step=len(hits) / steps, ms_per_step=ms / steps,
                          ms_per_launch=ms / len(hits))
    busy_step = busy / 1e3 / steps
    out = dict(
        steps=steps, chunks=chunks, wall_ms_per_step=wall_ms / steps,
        device_busy_ms_per_step=busy_step,
        device_idle_share=1 - busy / 1e3 / wall_ms,
        device_idle_share_vs_unprofiled_step=1 - busy_step / fused_step,
        device_events=len(events), kernels_per_step=len(events) / steps, kernels=ours,
        lead_in_lost=lost,
        top_device_ms_per_step=[(n, t / 1e3 / steps) for n, t in top],
    )
    log(f"[{tag}] S=1 fused window ({chunks} graph replays of {CHUNK} steps): "
        f"{out['wall_ms_per_step']:.3f} ms/step wall under the profiler "
        f"({fused_step:.3f} without), device busy {busy_step:.3f} ms/step, idle share "
        f"{out['device_idle_share']:.4f} (against the unprofiled step "
        f"{out['device_idle_share_vs_unprofiled_step']:.4f}), "
        f"{out['kernels_per_step']:.1f} kernels/step; lead-in records lost by the "
        f"traces: {lost} of {LEAD_IN}")
    for name, k in ours.items():
        log(f"[{tag}]   {name}: {k['launches_per_step']} launches/step, "
            f"{k['ms_per_step']:.4f} ms/step, {k['ms_per_launch']} ms/launch")
    for n, t in out["top_device_ms_per_step"]:
        log(f"[{tag}]   {t:8.3f} ms/step  {n[:90]}")
    return out


def phase_profile(torch, dev, report, state):
    """Where a decode step's time goes: a `torch.profiler` window of two
    fused chunks of the S=1 engine (graph replays, after the warm-up and
    capture chunk): the device busy ms per step and idle share, kernels
    by device time and per step (kernel A 2, kernel B 32, counted from
    the device events); then the host side of one eager step
    (`eager_step_profile`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.jit_engine import JitServeEngine

    cfg = get_config("stablelm-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    eng = JitServeEngine(cfg, params, dtype=torch.bfloat16, device=dev, **GEOM)
    fused_step = report["eager_vs_fused"]["fused_ms_per_step"]
    out = fused_window(torch, eng, state["trace"], cfg.n_layers, fused_step, "profile")
    out["eager_step"] = eager_step_profile(torch, eng)
    report["profile"] = out
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_cpu_trace(torch, report, state):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config("stablelm-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32)
    rows = []
    for S, layout, kw, per_chunk in ENGINE_RUNS:
        name = run_name(S, layout, kw, per_chunk)
        eng, wall, _, _ = run_engine(torch, cfg, params, torch.device("cpu"),
                                     torch.float32, S, state["trace"], layout, per_chunk, **kw)
        order, done, tot = state[name]
        same = dict(
            retired_order=eng.retired_order == order,
            done_steps=eng.done_steps == done,
            stat_totals=eng.stat_totals() == tot,
        )
        if kw.get("ring_capacity"):
            same["ring_events"] = eng.snapshot()["events"] == state["ring_events"]
        log(f"[cpu trace] {name}: {eng.stats['steps']} steps on the CPU in "
            f"{wall:.1f} s; equal to the card: {same}")
        if not all(same.values()):
            diff = {k: (v, tot.get(k)) for k, v in eng.stat_totals().items()
                    if tot.get(k) != v}
            raise AssertionError(f"{name}: CPU trace differs from the card: {diff}")
        rows.append(dict(run=name, wall_s=wall, **same))
    report["cpu_trace"] = rows


# ---------------------------------------------------------------------------
# Phase 7 (host_engine): the host-loop engine and the oracle of the jit engine
# ---------------------------------------------------------------------------

# ServeEngine at the serving geometry: 4096 pages of 4, 64 running
# sequences, block tables cut to the 32 pages a lane holds at most
HOST_GEOM = dict(num_pages=4096, page_tokens=4, max_batch=64, max_table_pages=32)
HOST_RUNS = ((1, {}), (4, {"fastpath": True, "magazines": 4}))
LOCKSTEP_RUN = (4, "bunch-packed", {"fastpath": True, "magazines": 4}, 16)


class KernelBInputs:
    """Stands in for `ops.paged_attention` while a host-loop run serves:
    counts the calls and keeps the inputs of the last call with the most
    rows (references only: a layer's pool views, the step's tables and
    lengths)."""

    def __init__(self, ops):
        self.ops, self.fn, self.best, self.calls = ops, ops.paged_attention, None, 0

    def __enter__(self):
        self.ops.paged_attention = self
        return self

    def __exit__(self, *exc):
        self.ops.paged_attention = self.fn

    def __call__(self, q, k, v, tables, lens, softcap=None):
        self.calls += 1
        # no sync here: the last call with the most rows is kept
        if self.best is None or q.shape[0] >= self.best[0]:
            self.best = (q.shape[0], (q, k, v, tables, lens, softcap))
        return self.fn(q, k, v, tables, lens, softcap=softcap)


def host_attention_row(torch, pa, name, inputs, launches, tag="host_engine"):
    """Kernel B on inputs the host loop (or phase `tag`) gave it, against
    its plain version, timed as phase attention times its rows."""
    q, k, v, tables, lens, softcap = inputs
    out = pa.paged_attention(q, k, v, tables, lens, softcap=softcap)
    want = pa.paged_attention_plain(q, k, v, tables, lens, softcap=softcap)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs()
    slack = float((err / out_limit(torch, want)).max())
    if not (slack <= 1.0 and bool(torch.isfinite(out).all())):
        raise AssertionError(f"kernel B disagrees with its plain version at {name}: "
                             f"worst element at {slack:.3f} of its limit")
    bound_ms, bound_by = attention_bound(torch, q, k, tables, lens)
    ms = attention_ms(torch, pa, q, k, v, tables, lens, softcap)
    row = dict(case=name, dtype=str(q.dtype).replace("torch.", ""), B=q.shape[0],
               Hq=q.shape[1], Hkv=k.shape[2], D=q.shape[2], page=k.shape[1],
               pages=k.shape[0], table_width=tables.shape[1],
               live_rows=int((lens > 0).sum()), context_tokens=int(lens.sum()),
               max_abs_err=float(err.max()), err_over_limit=slack, ms=ms,
               plain_ms=cuda_ms(torch, lambda: pa.paged_attention_plain(
                   q, k, v, tables, lens, softcap=softcap), reps=5),
               bound_ms=bound_ms, bound_by=bound_by, over_bound=ms / bound_ms,
               launches=launches)
    log(f"[{tag}] kernel B at {name} ({row['dtype']}): B={row['B']} page {row['page']} table "
        f"{row['table_width']} ({row['live_rows']} live rows, {row['context_tokens']} "
        f"tokens): worst element at {slack:.3f} of its limit; kernel {ms:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{row['over_bound']:.2f}x; {launches} launches on the path")
    return row


def run_host_engine(torch, cfg, params, dev, dtype, S, trace, **kw):
    """`ServeEngine` over `trace` (every request at once) to completion.
    Returns (engine, wall s, prefill s, decode ms of each step); each
    prefill and each step ends in its logits' copy to the host, a
    sync."""
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, dtype=dtype, device=dev, n_shards=S, **HOST_GEOM, **kw)
    prefill, step, spent, step_ms = eng._prefill_into_pages, eng.step, [0.0], []

    def timed_prefill(reqs):
        t = time.perf_counter()
        prefill(reqs)
        spent[0] += time.perf_counter() - t

    def timed_step():
        t, p = time.perf_counter(), spent[0]
        out = step()
        step_ms.append((time.perf_counter() - t - (spent[0] - p)) * 1e3)
        return out

    eng._prefill_into_pages, eng.step = timed_prefill, timed_step
    for i, p, mn in trace:
        eng.submit(Request(i, p.copy(), mn))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return eng, time.perf_counter() - t0, spent[0], step_ms


def check_host_engine(eng, trace, kw, name):
    """Every request served its budget, every shard's tree consistent and
    the pool fully coalesced: what a fresh manager of the same options
    reports (magazine stashes spilled back first)."""
    from repro_torch.memory.kv_cache import PagedKVManager

    for i, _, mn in trace:
        if len(eng.completed[i].out_tokens) != mn:
            raise AssertionError(f"{name}: request {i} gave "
                                 f"{len(eng.completed[i].out_tokens)} of {mn} tokens")
    stashed = eng.kv.mag_stashed()
    eng.kv._mag_spill_all()
    for b in eng.kv.buddies:
        b.check_invariants()
    keys = ("free_pages", "used_pages", "largest_run", "per_shard_free",
            "per_shard_largest_run")
    fresh = PagedKVManager(HOST_GEOM["num_pages"], HOST_GEOM["page_tokens"],
                           n_shards=eng.kv.n_shards, mag_lanes=HOST_GEOM["max_batch"],
                           **kw).fragmentation()
    frag = eng.kv.fragmentation()
    if any(frag[k] != fresh[k] for k in keys) or frag["free_pages"] != HOST_GEOM["num_pages"]:
        raise AssertionError(f"{name}: the pool did not coalesce: "
                             f"{ {k: frag[k] for k in keys} }")
    return stashed


def oracle_replay(S, trace, per_chunk, kw):
    """The port's `HostOracleEngine` over phase engine's arrival pattern
    and decode chunks, at its geometry (no model)."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.oracle import HostOracleEngine

    orc = HostOracleEngine(n_shards=S, **GEOM, **{k: v for k, v in kw.items()
                                                  if k in ("fastpath", "magazines")})
    pending = list(trace)
    while True:
        for i, p, mn in pending[:per_chunk or len(pending)]:
            orc.submit(Request(i, p.copy(), mn))
        del pending[:per_chunk or len(pending)]
        orc.run_to_completion(max_steps=CHUNK if pending else 10_000, chunk=CHUNK)
        if not pending:
            return orc


def no_sync_chunk(torch, decode_steps, n, fused, chunks):
    """`decode_steps(n, fused=fused)` between two CUDA events (kept in
    `chunks` as (n, start, end)), under
    torch.cuda.set_sync_debug_mode("error"): a host sync raises."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_steps(n, fused=fused)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    b.record()
    chunks.append((n, a, b))


def lockstep(torch, cfg, params, dev, trace, run):
    """One fused jit-engine run (`run` = (S, layout, front ends, arrivals
    per chunk)) beside the oracle, chunk by chunk: after every admission
    the running set, every running sequence's block table and the free
    pages equal; at the end the retirements, the counters and the free
    pages of each shard.  Every decode chunk runs through
    `no_sync_chunk`.  Returns (engine, row, chunks, wall s without the
    oracle and the checks)."""
    from repro_torch.core.magazine import MagazineState
    from repro_torch.core.pool import pool_free_units, pool_mag_free_per_shard
    from repro_torch.serve.engine import Request
    from repro_torch.serve.jit_engine import JitServeEngine, global_tables
    from repro_torch.serve.oracle import HostOracleEngine

    S, layout, kw, per_chunk = run
    eng = JitServeEngine(cfg, params, dtype=torch.bfloat16, device=dev, n_shards=S,
                         layout=layout, **GEOM, **kw)
    orc = HostOracleEngine(n_shards=S, **GEOM, **kw)
    pending, chunks, tables_checked, check_s = list(trace), [], 0, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        arrivals = pending[:per_chunk or len(pending)]
        del pending[:per_chunk or len(pending)]
        for i, p, mn in arrivals:
            eng.submit(Request(i, p.copy(), mn))
        eng._drain(), eng._admit()
        tc = time.perf_counter()
        for i, p, mn in arrivals:
            orc.submit(Request(i, p.copy(), mn))
        orc._drain(), orc._admit()
        if sorted(eng.running) != sorted(orc.running):
            raise AssertionError(f"lockstep chunk {len(chunks)}: running sets differ")
        done = not eng.running and not eng.waiting and not pending
        if not done:
            tables = global_tables(eng.ecfg, eng.state.page_shard, eng.state.page_off).cpu()
            for sid, lane in eng._lane_of.items():
                if tables[lane].tolist() != orc.block_table(sid).tolist():
                    raise AssertionError(f"lockstep chunk {len(chunks)}: sequence {sid}'s "
                                         "table differs from the oracle's")
                tables_checked += 1
            if eng.device_free_pages() != orc.free_pages():
                raise AssertionError(f"lockstep chunk {len(chunks)}: free pages "
                                     f"{eng.device_free_pages()} != {orc.free_pages()}")
            orc.decode_steps(CHUNK)
        check_s += time.perf_counter() - tc
        if done:
            break
        no_sync_chunk(torch, eng.decode_steps, CHUNK, True, chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - check_s
    pcfg = eng.ecfg.pool_config()
    per_shard = (pool_free_units(pcfg, eng.state.trees) + pool_mag_free_per_shard(
        pcfg, MagazineState(eng.state.mag_pages, eng.state.mag_depth))).tolist()
    tot, otot = eng.stat_totals(), orc.stat_totals()
    same = dict(retired_order=eng.retired_order == orc.retired_order,
                done_steps=eng.done_steps == orc.done_steps,
                stat_totals=all(tot[k] == v for k, v in otot.items()),
                free_per_shard=per_shard == orc.pool.per_shard_free())
    if not all(same.values()) or len(eng.completed) != len(trace):
        raise AssertionError(f"lockstep run differs from the oracle: {same}")
    orc.pool.check_invariants()
    row = dict(run=run_name(*run), chunks=len(chunks), tables_checked=tables_checked,
               per_shard_free=per_shard, magazine_hits=otot["magazine_hits"],
               fastpath_hits=otot["fastpath_hits"], **same)
    return eng, row, chunks, wall


def phase_host_engine(torch, dev, report, state):
    """The host-loop serving path on the card: the launcher, `ServeEngine`
    at the serving geometry (against its CPU replay), kernel B at the
    shapes it gets there; then the port's oracle against every fused
    jit-engine run of phase engine, and one run in lockstep."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.kernels import nbbs_alloc, ops, paged_attention as pa
    from repro_torch.launch import serve as launch
    from repro_torch.models.transformer import init_params

    cfg = get_config("stablelm-3b")
    out = {}
    # -- 1. the launcher, in-process, as a user runs it --------------------
    nbbs_alloc.launches, pa.launches = 0, 0
    buf = io.StringIO()
    with KernelBInputs(ops) as rec, contextlib.redirect_stdout(buf):
        launch.main(["--arch", "stablelm-3b"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"[host_engine] python -m repro_torch.launch.serve --arch stablelm-3b: {line}")
    steps, kv = line["engine_stats"]["steps"], line["kv"]
    n_req, max_new, pages = 16, 8, 256   # the launcher's defaults
    launches = {"nbbs_pool_step": nbbs_alloc.launches, "paged_attention": pa.launches}
    checks = dict(
        completed=line["completed"] == n_req,
        generated_tokens=line["generated_tokens"] == n_req * max_new,
        coalesced=kv["free_pages"] == kv["largest_run"] == pages,
        kernel_b=launches["paged_attention"] == cfg.n_layers * steps == rec.calls,
        no_kernel_a=launches["nbbs_pool_step"] == 0,
    )
    if not all(checks.values()):
        raise AssertionError(f"launcher: {checks}, launches {launches}")
    out["launcher"] = dict(line, launches=launches, checks=checks)
    att_rows = [host_attention_row(torch, pa, "the launcher's shape", rec.best[1],
                                   launches["paged_attention"])]
    del rec
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2. ServeEngine at the serving geometry ----------------------------
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=torch.bfloat16)
    small = cfg.reduced()
    small_params = init_params(small, torch.Generator().manual_seed(0), device="cpu")
    trace = state["trace"]
    rows = []
    for S, kw in HOST_RUNS:
        name = f"S{S}" + "".join(f"-{k}" for k in sorted(kw))
        nbbs_alloc.launches, pa.launches = 0, 0
        with KernelBInputs(ops) as rec:
            eng, wall, prefill_s, step_ms = run_host_engine(torch, cfg, params, dev,
                                                            torch.bfloat16, S, trace, **kw)
        launches = {"nbbs_pool_step": nbbs_alloc.launches, "paged_attention": pa.launches}
        steps = eng.stats["steps"]
        tokens = sum(len(r.out_tokens) for r in eng.completed.values())
        if launches != {"nbbs_pool_step": 0, "paged_attention": cfg.n_layers * steps}:
            raise AssertionError(f"host engine {name}: launches {launches} in {steps} steps")
        order, frag = list(eng.completed), eng.kv.fragmentation()
        stashed = check_host_engine(eng, trace, kw, name)
        cpu, cpu_wall, _, _ = run_host_engine(torch, small, small_params,
                                              torch.device("cpu"), torch.float32, S, trace,
                                              **kw)
        same = dict(stats=cpu.stats == eng.stats, retirement_order=list(cpu.completed) == order,
                    fragmentation=cpu.kv.fragmentation() == frag)
        if not all(same.values()):
            raise AssertionError(f"host engine {name}: CPU replay differs: {same}")
        row = dict(run=name, S=S, **kw, steps=steps, tokens=tokens, wall_s=wall,
                   prefill_s=prefill_s, admitted=eng.stats["admitted"],
                   ms_per_step=(wall - prefill_s) * 1e3 / steps,
                   median_ms_per_step=sorted(step_ms)[len(step_ms) // 2],
                   first_step_ms=step_ms[0], step_ms=step_ms,
                   wall_ms_per_step=wall * 1e3 / steps,
                   tokens_per_s=tokens / wall, decode_tokens_per_s=tokens / (wall - prefill_s),
                   launches=launches, magazine_stashed_at_end=stashed,
                   **{k: frag[k] for k in ("fastpath_hits", "magazine_hits")},
                   cpu_replay_s=cpu_wall, cpu_replay_equal=same)
        log(f"[host_engine] ServeEngine {name}: {steps} steps, {tokens} tokens in "
            f"{wall:.2f} s (prefill {prefill_s:.2f} s): {row['ms_per_step']:.3f} ms per "
            f"decode step (median {row['median_ms_per_step']:.3f}, first "
            f"{row['first_step_ms']:.3f}), {row['tokens_per_s']:.1f} tokens/s ({row['decode_tokens_per_s']:.1f} "
            f"without prefill); launches {launches}; fully coalesced; CPU replay "
            f"({cpu_wall:.1f} s) equal: {same}")
        rows.append(row)
        if S == 1:
            att_rows.append(host_attention_row(
                torch, pa, "ServeEngine at the serving geometry", rec.best[1],
                launches["paged_attention"]))
        del eng, rec
        gc.collect()
    ev = report.get("eager_vs_fused", {})
    out["serve_engine"] = rows
    out["beside_jit_engine"] = dict(
        host_loop_ms_per_step=rows[0]["ms_per_step"],
        jit_eager_ms_per_step=ev.get("eager_ms_per_step"),
        jit_fused_ms_per_step=ev.get("fused_ms_per_step"),
        host_loop_tokens_per_s=rows[0]["decode_tokens_per_s"],
        jit_eager_tokens_per_s=ev.get("eager_tokens_per_s"),
        jit_fused_tokens_per_s=ev.get("fused_tokens_per_s"))
    log(f"[host_engine] S=1 ms per decode step: host loop {rows[0]['ms_per_step']:.3f}, jit "
        f"eager {ev.get('eager_ms_per_step')}, jit fused {ev.get('fused_ms_per_step')}")
    out["attention"] = att_rows

    # -- 3. the oracle against phase engine's fused runs --------------------
    t0 = time.perf_counter()
    oracle_rows = []
    for S, layout, kw, per_chunk in ENGINE_RUNS:
        name = run_name(S, layout, kw, per_chunk)
        order, done, tot = state[name]
        orc = oracle_replay(S, trace, per_chunk, kw)
        otot = orc.stat_totals()
        same = dict(retired_order=orc.retired_order == order, done_steps=orc.done_steps == done,
                    stat_totals=all(tot[k] == v for k, v in otot.items()))
        if not all(same.values()):
            diff = {k: (v, tot[k]) for k, v in otot.items() if tot[k] != v}
            raise AssertionError(f"{name}: the jit engine differs from the oracle: {same} {diff}")
        oracle_rows.append(dict(run=name, **same))
    replay_s = time.perf_counter() - t0
    log(f"[host_engine] oracle: {len(oracle_rows)} fused jit-engine runs equal to "
        f"HostOracleEngine (retirement order, steps, stat_totals) in {replay_s:.2f} s")
    lock = lockstep(torch, cfg, params, dev, trace, LOCKSTEP_RUN)[1]
    log(f"[host_engine] oracle lockstep {lock['run']}: {lock['chunks']} chunks, "
        f"{lock['tables_checked']} block tables equal page for page, free pages per shard "
        f"{lock['per_shard_free']}; slab hits {lock['fastpath_hits']}, magazine hits "
        f"{lock['magazine_hits']}")
    out["oracle"] = dict(runs=oracle_rows, replay_s=replay_s, lockstep=lock)
    report["host_engine"] = out
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase moe: phi3.5-moe at full width on both serving paths
# ---------------------------------------------------------------------------

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
# 16 of its 32 layers: 41.6 GB of bf16 weights (all 32 would be 83.2 GB,
# over the card's 80 GB; full depth needs the model sharded)
MOE_LAYERS = 16
# phase engine's S=1 run (every request at once) and its S=4 packed run
# with the fastpath and magazines 4, 16 requests arriving per chunk
MOE_RUNS = (ENGINE_RUNS[0], LOCKSTEP_RUN)
# prefill(S+1) against prefill(S) + decode_step, B=4, S=16, twice.  In
# fp32 at full width cut to 8 layers (42 GB of weights) both paths
# compute one function up to fp32 rounding: the limit is 1e-4 of the
# logits' norm, the atol of JAX's test_serve_consistency at fp32.  In
# bf16 at the phase's 16 layers the two paths round differently, and in
# the deeper layers that flips the routing of some tokens: the same bf16
# prefill run one row at a time instead of batched differs from itself
# by 0.16 of the norm (fp32: 2.4e-6; this phase on an H100).  The bf16
# limit, 2^-2 of the norm, is above that noise and far below sqrt(2),
# the distance of two unrelated logit vectors of one norm
MOE_CONSISTENCY = dict(B=4, S=16, bf16_rel_tol=2.0 ** -2, fp32_layers=8, fp32_rel_tol=1e-4)


def expert_ffn_row(torch, dev, cfg, lp, T):
    """One layer's expert work at the paged decode step's shapes (T
    lanes, drop-free capacity T x top_k slots per expert), timed with
    CUDA events (each call reads the layer's 2.5 GB of expert weights,
    far beyond L2): the three batched GEMMs alone, the expert FFN
    (`moe._swiglu_experts`: the GEMMs and the SwiGLU between them) and
    the whole `apply_moe`; beside two bounds of the GEMMs: the capacity
    buffer's work, and the routed rows' work alone."""
    from repro_torch.models import moe as moe_lib

    E, k, d, ff = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    bf16 = torch.bfloat16
    C = max(int(float(E) * T * k / E), 1)
    g = torch.Generator(device=dev).manual_seed(3)
    buf = torch.randn((E, C, d), generator=g, device=dev).to(bf16)
    act = torch.randn((E, C, ff), generator=g, device=dev).to(bf16)
    x = torch.randn((T, 1, d), generator=g, device=dev).to(bf16)
    gemm_ms = cuda_ms(torch, lambda: (torch.matmul(buf, lp["w_gate"]),
                                      torch.matmul(buf, lp["w_in"]),
                                      torch.matmul(act, lp["w_out"])), reps=10)
    ffn_ms = cuda_ms(torch, lambda: moe_lib._swiglu_experts(lp, buf, bf16), reps=10)
    moe_ms = cuda_ms(torch, lambda: moe_lib.apply_moe(
        lp, x, top_k=k, capacity_factor=float(E), dtype=bf16), reps=10)
    w_bytes = 3 * E * d * ff * 2
    io_bytes = (3 * E * C * d + 3 * E * C * ff) * 2   # buf, act in; g, h, out
    cap_ops = 2 * 3 * E * C * d * ff
    routed_ops = 2 * 3 * T * k * d * ff
    t_ops, t_bytes = cap_ops / PEAK["bfloat16"], (w_bytes + io_bytes) / HBM_BPS
    cap_bound = max(t_ops, t_bytes) * 1e3
    routed_bound = max(routed_ops / PEAK["bfloat16"], w_bytes / HBM_BPS) * 1e3
    n = cfg.n_layers
    row = dict(T=T, top_k=k, experts=E, capacity=C, gemm_ms_per_layer=gemm_ms,
               ffn_ms_per_layer=ffn_ms, apply_moe_ms_per_layer=moe_ms,
               capacity_tflop=cap_ops / 1e12, capacity_bound_ms=cap_bound,
               capacity_bound_by="operations" if t_ops >= t_bytes else "bytes",
               routed_tflop=routed_ops / 1e12, routed_bound_ms=routed_bound,
               weight_gb_per_layer=w_bytes / 1e9, gemm_ms_per_step=gemm_ms * n,
               ffn_ms_per_step=ffn_ms * n, apply_moe_ms_per_step=moe_ms * n,
               gemm_over_capacity_bound=gemm_ms / cap_bound,
               gemm_tflops=cap_ops / gemm_ms / 1e9)
    log(f"[moe] expert work per layer at T={T}, capacity {C} slots x {E} experts: "
        f"3 GEMMs {gemm_ms:.4f} ms ({row['capacity_tflop']:.3f} TFLOP over the buffer, "
        f"{row['gemm_tflops']:.1f} TFLOP/s; bound {cap_bound:.4f} ms by "
        f"{row['capacity_bound_by']}, {row['gemm_over_capacity_bound']:.2f}x; the routed "
        f"rows alone: {row['routed_tflop']:.4f} TFLOP, bound {routed_bound:.4f} ms); "
        f"with the SwiGLU {ffn_ms:.4f} ms; whole apply_moe {moe_ms:.4f} ms; per step "
        f"({n} layers): GEMMs {row['gemm_ms_per_step']:.3f} ms, FFN "
        f"{row['ffn_ms_per_step']:.3f}, apply_moe {row['apply_moe_ms_per_step']:.3f}")
    return row


def moe_consistency(torch, dev, cfg, params, dtype, tol):
    """The last logits of prefill(S+1) against prefill(S) + decode_step
    (relative to their norm, within `tol`), beside the same prefill run
    one row at a time (what rounding alone moves at this dtype) and the
    layers where the last token's experts differ between the two paths
    (`moe._route` is watched while they run)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import decode_step, prefill

    B, S = MOE_CONSISTENCY["B"], MOE_CONSISTENCY["S"]
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                         generator=torch.Generator().manual_seed(7)).to(dev)
    route, picks = moe_lib._route, []

    def watched(router, x, top_k):
        out = route(router, x, top_k)
        picks.append(out[1].reshape(-1, top_k).sort(-1).values)
        return out

    moe_lib._route = watched
    try:
        full, _ = prefill(cfg, params, {"tokens": toks}, S + 4, dtype=dtype)
        full_picks = [p.reshape(B, S + 1, -1)[:, S] for p in picks]
        _, cache = prefill(cfg, params, {"tokens": toks[:, :S]}, S + 4, dtype=dtype)
        del picks[:]
        dec, cache = decode_step(cfg, params, cache, toks[:, S], dtype=dtype)
        flips = [int((a != b).any(-1).sum()) for a, b in zip(full_picks, picks)]
    finally:
        moe_lib._route = route
    rows = torch.cat([prefill(cfg, params, {"tokens": toks[b:b + 1]}, S + 4,
                              dtype=dtype)[0] for b in range(B)])
    rel = float((dec - full).norm() / full.norm())
    row = dict(dtype=str(dtype).replace("torch.", ""), n_layers=cfg.n_layers, B=B, S=S,
               rel_err=rel, rel_tol=tol, max_abs_err=float((dec - full).abs().max()),
               logit_scale=float(full.abs().max()),
               argmax_equal=int((dec.argmax(-1) == full.argmax(-1)).sum()),
               prefill_by_rows_rel=float((rows - full).norm() / full.norm()),
               routing_flips_by_layer=flips)
    row["ok"] = bool(rel <= tol and torch.isfinite(dec).all() and cache["pos"] == S + 1)
    log(f"[moe] prefill({S + 1}) against prefill({S}) + decode_step, {cfg.n_layers} layers, "
        f"B={B}, {row['dtype']}: relative error {rel:.3e} (limit {tol:.3e}), max |diff| "
        f"{row['max_abs_err']:.3e} of logits up to {row['logit_scale']:.2f}, argmax equal "
        f"in {row['argmax_equal']} of {B} rows; the prefill one row at a time differs from "
        f"the batched one by {row['prefill_by_rows_rel']:.3e}; rows whose last token's "
        f"experts differ between the paths, by layer: {flips}")
    return row


def phase_moe(torch, dev, report, state):
    """phi3.5-moe-42b-a6.6b at full width, 16 of 32 layers, random bf16
    weights: `JitServeEngine` fused at S=1 and at S=4 packed with the
    front ends, each in lockstep with `HostOracleEngine` and equal to
    phase engine's same-named run; 8 eager steps at S=1; a profiler window
    of two fused chunks; the expert FFN's device time against its bounds;
    `ServeEngine` at S=1; kernel B at the model's heads; decode
    consistency (prefill(S+1) against prefill(S) + decode_step) in bf16
    at 16 layers and in fp32 at 8."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import nbbs_alloc, paged_attention as pa
    from repro_torch.models.transformer import init_params, layer_params
    from repro_torch.serve.engine import Request
    from repro_torch.serve.jit_engine import JitServeEngine

    bf16 = torch.bfloat16
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=bf16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def nbytes(node):
        if isinstance(node, dict):
            return sum(nbytes(v) for v in node.values())
        return node.numel() * node.element_size()

    out = dict(arch=MOE_ARCH, n_layers=cfg.n_layers, of_layers=get_config(MOE_ARCH).n_layers,
               d_model=cfg.d_model, heads=(cfg.n_heads, cfg.n_kv_heads), head_dim=cfg.head_dim,
               d_ff=cfg.d_ff, experts=cfg.n_experts, top_k=cfg.top_k, vocab=cfg.vocab_size,
               weight_gb=nbytes(params) / 1e9, init_s=init_s)
    report["moe"] = out   # filled in as the phase goes
    log(f"[moe] {MOE_ARCH} full width, {cfg.n_layers} of {out['of_layers']} layers: d_model "
        f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim} d_ff "
        f"{cfg.d_ff} experts {cfg.n_experts} top-{cfg.top_k} vocab {cfg.vocab_size}; "
        f"{out['weight_gb']:.2f} GB of weights (bf16, router and tables fp32) from seed 0 "
        f"in {init_s:.1f} s")
    trace = state["trace"]

    # -- 1. the jit engine, fused, in lockstep with the oracle -------------
    rows, fused_tokens = [], None
    for run in MOE_RUNS:
        name = run_name(*run)
        nbbs_alloc.launches, pa.launches = 0, 0
        eng, lock, chunks, wall = lockstep(torch, cfg, params, dev, trace, run)
        launches = {"nbbs_pool_step": nbbs_alloc.launches, "paged_attention": pa.launches}
        steps, tot = eng.stats["steps"], eng.stat_totals()
        tokens = sum(len(r.out_tokens) for r in eng.completed.values())
        for i, _, mn in trace:
            if len(eng.completed[i].out_tokens) != mn:
                raise AssertionError(f"moe {name}: request {i} gave "
                                     f"{len(eng.completed[i].out_tokens)} of {mn} tokens")
        order, done, dense_tot = state[name]
        same = dict(retired_order=eng.retired_order == order,
                    done_steps=dict(eng.done_steps) == done, stat_totals=tot == dense_tot)
        if not all(same.values()):
            diff = {k: (v, tot.get(k)) for k, v in dense_tot.items() if tot.get(k) != v}
            raise AssertionError(f"moe {name}: schedule differs from phase engine's: "
                                 f"{same} {diff}")
        per = 3 if run[2].get("magazines") else 2
        admits = eng.stats["admitted"] + eng.stats["queued_full"]
        want = {"nbbs_pool_step": per * (steps + admits),
                "paged_attention": cfg.n_layers * steps}
        if launches != want:
            raise AssertionError(f"moe {name}: launches {launches}, expected {want}")
        if len(eng._graphs) != (dev.type == "cuda"):   # one chunk length
            raise AssertionError(f"moe {name}: {len(eng._graphs)} graphs captured")
        if run[2].get("fastpath") and tot["fastpath_hits"] <= 0:
            raise AssertionError(f"moe {name}: the slab served no page")
        if run[2].get("magazines") and tot["magazine_hits"] <= 0:
            raise AssertionError(f"moe {name}: the magazines served no page")
        decode_ms = [a.elapsed_time(b) for _, a, b in chunks]
        dec = sum(decode_ms)
        steady = sum(decode_ms[1:]) / max(sum(n for n, _, _ in chunks[1:]), 1)
        row = dict(run=name, decode_steps=steps, tokens=tokens, wall_s=wall,
                   first_chunk_ms=decode_ms[0], decode_ms_per_step=dec / steps,
                   steady_decode_ms_per_step=steady, tokens_per_s=tokens / (dec / 1e3),
                   wall_tokens_per_s=tokens / wall, alloc_pages=tot["alloc_pages"],
                   freed_pages=tot["freed_pages"], launches=launches,
                   equal_to_engine_phase=same, oracle=lock,
                   dense_steady_ms_per_step=next(
                       (r["steady_decode_ms_per_step"] for r in report.get("engine", [])
                        if r["run"] == name), None))
        log(f"[moe] {name}: {steps} decode steps, {tokens} tokens, alloc "
            f"{row['alloc_pages']} freed {row['freed_pages']} pages; decode "
            f"{row['decode_ms_per_step']:.2f} ms/step (steady {steady:.2f}; stablelm-3b "
            f"{row['dense_steady_ms_per_step']}), {row['tokens_per_s']:.1f} tokens/s decode, "
            f"{row['wall_tokens_per_s']:.1f} tokens/s wall ({wall:.2f} s without the "
            f"oracle); launches {launches} (= {per} x (steps + admissions), "
            f"{cfg.n_layers} x steps); schedule, counters and tokens per request equal to "
            f"phase engine's run; {lock['tables_checked']} block tables equal to the "
            f"oracle's over {lock['chunks']} chunks")
        if run == ENGINE_RUNS[0]:
            fused_tokens = {i: r.out_tokens for i, r in eng.completed.items()}
            fused_b_launches = launches["paged_attention"]
        rows.append(row)
        del eng
        gc.collect()
    out["jit_engine"] = rows

    # -- 2. S=1 eager, its first CHUNK steps -------------------------------
    nbbs_alloc.launches, pa.launches = 0, 0
    eng = JitServeEngine(cfg, params, dtype=bf16, device=dev, **GEOM)
    for i, p, mn in trace:
        eng.submit(Request(i, p.copy(), mn))
    eng._drain(), eng._admit()
    chunks = []
    no_sync_chunk(torch, eng.decode_steps, CHUNK, False, chunks)
    torch.cuda.synchronize()
    eager_ms = chunks[0][1].elapsed_time(chunks[0][2]) / CHUNK
    admits = eng.stats["admitted"] + eng.stats["queued_full"]
    want = {"nbbs_pool_step": 2 * (CHUNK + admits), "paged_attention": cfg.n_layers * CHUNK}
    got = {"nbbs_pool_step": nbbs_alloc.launches, "paged_attention": pa.launches}
    if got != want:
        raise AssertionError(f"moe eager: launches {got}, expected {want}")
    out_toks = eng.state.out_toks.cpu()
    for sid, lane in eng._lane_of.items():
        if out_toks[lane, :CHUNK].tolist() != fused_tokens[sid][:CHUNK]:
            raise AssertionError(f"moe eager: request {sid}'s first {CHUNK} tokens differ "
                                 "from the fused run's")
    fused_steady = rows[0]["steady_decode_ms_per_step"]
    out["eager"] = dict(steps=CHUNK, lanes=len(eng._lane_of), ms_per_step=eager_ms,
                        fused_steady_ms_per_step=fused_steady,
                        step_speedup=eager_ms / fused_steady, launches=got)
    log(f"[moe] S=1 eager, first {CHUNK} steps of {len(eng._lane_of)} lanes: "
        f"{eager_ms:.3f} ms/step against {fused_steady:.3f} fused (steady), "
        f"{eager_ms / fused_steady:.2f}x; tokens equal to the fused run's; launches {got}")
    del eng
    gc.collect()

    # -- 3. where a fused step's time goes ---------------------------------
    eng = JitServeEngine(cfg, params, dtype=bf16, device=dev, **GEOM)
    out["profile"] = fused_window(torch, eng, trace, cfg.n_layers, fused_steady, "moe")
    del eng
    gc.collect()
    out["expert_ffn"] = expert_ffn_row(torch, dev, cfg, layer_params(params, 0)["moe"],
                                       GEOM["max_batch"])

    # -- 4. the host loop --------------------------------------------------
    nbbs_alloc.launches, pa.launches = 0, 0
    host, wall, prefill_s, step_ms = run_host_engine(torch, cfg, params, dev, bf16, 1, trace)
    launches = {"nbbs_pool_step": nbbs_alloc.launches, "paged_attention": pa.launches}
    steps = host.stats["steps"]
    tokens = sum(len(r.out_tokens) for r in host.completed.values())
    if launches != {"nbbs_pool_step": 0, "paged_attention": cfg.n_layers * steps}:
        raise AssertionError(f"moe ServeEngine: launches {launches} in {steps} steps")
    check_host_engine(host, trace, {}, "moe ServeEngine S1")
    if "host_engine" not in report:
        raise AssertionError("the ServeEngine run needs phase host_engine's S1 run")
    dense = report["host_engine"]["serve_engine"][0]   # S1, the same trace and geometry
    same = dict(steps=steps == dense["steps"], admitted=host.stats["admitted"] == dense["admitted"],
                tokens=tokens == dense["tokens"])
    if not all(same.values()):
        raise AssertionError(f"moe ServeEngine: schedule differs from phase host_engine's: {same}")
    out["serve_engine"] = dict(
        run="S1", steps=steps, tokens=tokens, wall_s=wall, prefill_s=prefill_s,
        ms_per_step=(wall - prefill_s) * 1e3 / steps,
        median_ms_per_step=sorted(step_ms)[len(step_ms) // 2],
        tokens_per_s=tokens / wall, decode_tokens_per_s=tokens / (wall - prefill_s),
        launches=launches, equal_to_host_engine_phase=same,
        dense_ms_per_step=dense["ms_per_step"])
    log(f"[moe] ServeEngine S1: {steps} steps, {tokens} tokens in {wall:.2f} s (prefill "
        f"{prefill_s:.2f} s): {out['serve_engine']['ms_per_step']:.3f} ms per decode step "
        f"(median {out['serve_engine']['median_ms_per_step']:.3f}; stablelm-3b "
        f"{dense['ms_per_step']:.3f}), {out['serve_engine']['tokens_per_s']:.1f} tokens/s; "
        f"launches {launches}; fully coalesced; schedule equal to phase host_engine's")
    del host
    gc.collect()

    # -- 5. kernel B at the model's heads ----------------------------------
    inputs = attention_inputs(torch, dev, bf16, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads,
                              D=cfg.head_dim)
    out["attention"] = host_attention_row(
        torch, pa, f"{MOE_ARCH} ({cfg.n_heads}/{cfg.n_kv_heads} heads, D={cfg.head_dim})",
        (*inputs, None), fused_b_launches, tag="moe")
    del inputs
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"[moe] peak device memory {out['peak_memory_gb']:.2f} GB")

    # -- 6. decode consistency at full width --------------------------------
    out["consistency"] = [moe_consistency(torch, dev, cfg, params, bf16,
                                          MOE_CONSISTENCY["bf16_rel_tol"])]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=MOE_CONSISTENCY["fp32_layers"])
    params = init_params(cfg32, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=torch.float32)
    out["consistency"].append(moe_consistency(torch, dev, cfg32, params, torch.float32,
                                              MOE_CONSISTENCY["fp32_rel_tol"]))
    bad = [c for c in out["consistency"] if not c["ok"]]
    if bad:
        raise AssertionError(f"moe decode consistency: {bad}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_fp32(torch, dev, report):
    """One request (prompt 6, 8 new tokens) through the jit engine and
    through the host-loop `ServeEngine` at full width in fp32, each held
    against greedy decoding through the dense `prefill` over its own
    growing sequence."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.jit_engine import JitServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("stablelm-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev, dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
    dense: dict = {}

    def greedy(tokens, what):
        """Near-ties (top-2 gap <= 1e-3) of the dense logits before each
        token; raises where a token is not the dense argmax past one."""
        ties = []
        for i, tok in enumerate(tokens):
            key = tuple(tokens[:i])
            if key not in dense:
                seq = torch.tensor(list(prompt) + tokens[:i], dtype=torch.long, device=dev)
                dense[key] = prefill(cfg, params, {"tokens": seq[None]}, len(seq),
                                     dtype=torch.float32)[0][0]
            lg = dense[key]
            top2 = torch.topk(lg, 2).values
            gap = float(top2[0] - top2[1])
            if gap > 1e-3 and int(lg.argmax()) != tok:
                raise AssertionError(f"{what} step {i}: token {tok} != dense greedy "
                                     f"{int(lg.argmax())}")
            if gap <= 1e-3:
                ties.append(i)
        return ties

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
    flips = greedy(tokens, "jit engine")
    worst = 0.0
    for i in range(len(tokens)):
        diff = float((dense[tuple(tokens[:i])] - eng_logits[i]).abs().max())
        worst = max(worst, diff)
        if diff > 1e-3:
            raise AssertionError(f"step {i}: logits differ by {diff:.3e} > 1e-3")
    log(f"[fp32] full width, prompt 6 + {len(tokens)} tokens: max |logit diff| "
        f"{worst:.3e} (tol 1e-3), tokens equal to dense greedy; near-ties at {flips}")
    del eng
    host = ServeEngine(cfg, params, num_pages=64, page_tokens=4, max_batch=2,
                       max_table_pages=16, dtype=torch.float32, device=dev)
    host.submit(Request(0, prompt.copy(), max_new_tokens=8))
    host.run_to_completion()
    host_tokens = host.completed[0].out_tokens
    if len(host_tokens) != 8:
        raise AssertionError(f"ServeEngine gave {len(host_tokens)} of 8 tokens")
    host_flips = greedy(host_tokens, "ServeEngine")
    log(f"[fp32] ServeEngine, the same request: tokens equal to dense greedy; near-ties "
        f"at {host_flips}; equal to the jit engine's: {host_tokens == tokens}")
    report["fp32"] = dict(max_abs_logit_diff=worst, tokens=tokens, near_ties=flips,
                          serve_engine_tokens=host_tokens, serve_engine_near_ties=host_flips)
    del host, params, dense
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 10: training (launch/train.py's path) at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH = "stablelm-3b"
# (a) the full-width run: global batch x seq, microbatches, steps (the
# first a warm-up), AdamW's schedule
TRAIN_RUN = dict(batch=8, seq=1024, microbatches=2, steps=6, peak_lr=3e-4,
                 warmup_steps=2)
# (b) one fp32 step on the card against the same step on the CPU
TRAIN_CHECK = dict(layers=2, batch=2, seq=128, peak_lr=3e-4, loss_rel_tol=1e-5,
                   leaf_tol=1e-4)
# (c) the supervisor with a failure and a restart.  The launcher's AdamW
# schedule (peak 3e-3, warm-up 20) is for the reduced widths: at d_model
# 2560 in bf16 it raised the loss from 11.36 to 12.52 in 30 steps.  With
# warm-up 2, peak 3e-4 moves the loss less than its batch-to-batch noise
# (+-0.03) in 30 steps; peak 1e-3 lowers it by 0.15
TRAIN_RESTART = dict(layers=4, batch=8, seq=256, microbatches=2, steps=30, ckpt_every=10,
                     fail_at=17, peak_lr=1e-3, warmup_steps=2)
# the kernel families of a training step's device time, by kernel name
TRAIN_KERNEL_KINDS = (("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
                      ("reduce", ("reduce",)),
                      ("elementwise", ("elementwise", "vectorized", "unrolled")),
                      ("index", ("index", "scatter", "gather")),
                      ("copy", ("copy", "cat", "memcpy", "memset")))


def matmul_params(cfg):
    """Parameters of the matmuls a token passes through: every layer's
    attention and MLP projections and the LM head (the embedding is a
    gather)."""
    hd = cfg.n_heads * cfg.head_dim
    attn = cfg.d_model * (2 * hd + 2 * cfg.n_kv_heads * cfg.head_dim)
    return cfg.n_layers * (attn + 3 * cfg.d_model * cfg.d_ff) + cfg.vocab_size * cfg.d_model


def kernel_kinds(events):
    """Device ms of `events` by kernel family (TRAIN_KERNEL_KINDS, then
    "other")."""
    out: dict = {}
    for e in events:
        name = e.name.lower()
        kind = next((k for k, keys in TRAIN_KERNEL_KINDS if any(s in name for s in keys)),
                    "other")
        out[kind] = out.get(kind, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


def train_full(torch, dev, cfg):
    """(a): `launch/train.py`'s path at full width in bf16 over float32
    masters: steady ms per step (CUDA events), the optimizer's share,
    tokens/s, model TFLOP/s (6 N T over the step), peak memory, losses
    and grad norms, then one profiled step (device time by kernel family)."""
    from torch.profiler import ProfilerActivity

    from repro_torch.launch.train import train_fns
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig
    from repro_torch.tree_util import leaves

    r = TRAIN_RUN
    tcfg = TrainConfig(microbatches=r["microbatches"], remat=True, dtype=torch.bfloat16,
                       optimizer=adamw.AdamWConfig(peak_lr=r["peak_lr"],
                                                   warmup_steps=r["warmup_steps"],
                                                   total_steps=r["steps"]))
    make_state, step_fn = train_fns(cfg, tcfg, batch=r["batch"], seq=r["seq"], seed=0,
                                    device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = make_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in leaves(state.params))
    state_gb = torch.cuda.memory_allocated(dev) / 1e9
    update, opt_events = adamw.update, []

    def timed_update(*a, **kw):   # the optimizer's device time inside each step
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = update(*a, **kw)
        ev[1].record()
        opt_events.append(ev)
        return res

    steps = []
    adamw.update = timed_update
    try:
        for i in range(r["steps"]):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, m = step_fn(state, i)
            ev[1].record()
            steps.append((ev, m))
        torch.cuda.synchronize()
    finally:
        adamw.update = update
    step_ms = [ev[0].elapsed_time(ev[1]) for ev, _ in steps]
    opt_ms = [a.elapsed_time(b) for a, b in opt_events]
    losses = [float(m["loss"]) for _, m in steps]
    gnorms = [float(m["grad_norm"]) for _, m in steps]
    peak = torch.cuda.max_memory_allocated(dev)
    capacity = torch.cuda.get_device_properties(dev).total_memory
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"train: losses {losses}, grad norms {gnorms}")
    if peak >= capacity:
        raise AssertionError(f"train: peak memory {peak} >= the card's {capacity}")
    steady = step_ms[1:]
    ms = sum(steady) / len(steady)
    tokens = r["batch"] * r["seq"]
    n_mm = matmul_params(cfg)
    tflops = 6 * n_mm * tokens / (ms / 1e3) / 1e12
    out = dict(arch=TRAIN_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, params=n_params, matmul_params=n_mm,
               batch=r["batch"], seq=r["seq"], microbatches=r["microbatches"],
               tokens_per_step=tokens, init_s=init_s, state_gb=state_gb,
               step_ms=step_ms, optimizer_ms=opt_ms, ms_per_step=ms,
               optimizer_ms_per_step=sum(opt_ms[1:]) / len(opt_ms[1:]),
               tokens_per_s=tokens / (ms / 1e3), model_tflops=tflops,
               model_flops_share_of_989=tflops / 989, peak_memory_gb=peak / 1e9,
               capacity_gb=capacity / 1e9, losses=losses, grad_norms=gnorms)
    log(f"[train] {TRAIN_ARCH} full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}; {n_params} parameters, {n_mm} in matmuls) from seed 0 "
        f"in {init_s:.1f} s, bf16 over float32 masters, remat; batch {r['batch']} x "
        f"{r['seq']} in {r['microbatches']} microbatches")
    log(f"[train]   steps (ms, CUDA events; the first warms up): "
        f"{[round(t, 3) for t in step_ms]}; the optimizer {[round(t, 3) for t in opt_ms]}")
    log(f"[train]   steady {ms:.3f} ms per step (AdamW {out['optimizer_ms_per_step']:.3f}), "
        f"{out['tokens_per_s']:.1f} tokens/s, model {tflops:.1f} TFLOP/s (6 N T, "
        f"{100 * tflops / 989:.2f}% of 989); train state {state_gb:.2f} GB, peak "
        f"{out['peak_memory_gb']:.2f} GB of {out['capacity_gb']:.2f}")
    log(f"[train]   loss {losses[0]:.4f} -> {losses[-1]:.4f}; grad norm "
        f"{[round(g, 4) for g in gnorms]}")

    # device events only: the CPU's 100k-odd op events take long to gather
    acts = [ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU]
    with traced(torch, acts) as tr:
        t0 = time.perf_counter()
        state, m = step_fn(state, r["steps"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in tr.events if on_card(e)]
    busy = device_busy(events) / 1e3
    kinds = kernel_kinds(events)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    out["profile"] = dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                          kernels=len(events), ms_by_kind=kinds,
                          top_ms=[(n, t / 1e3) for n, t in sorted(
                              by_name.items(), key=lambda kv: -kv[1])[:10]])
    log(f"[train]   profiled step: {wall_ms:.1f} ms wall, device busy {busy:.1f} ms (idle "
        f"{out['profile']['idle_share']:.4f}), {len(events)} kernels; ms by family "
        f"{ {k: round(v, 1) for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])} }")
    for n, t in out["profile"]["top_ms"]:
        log(f"[train]     {t:9.3f} ms  {n[:90]}")
    return out


def train_card_vs_cpu(torch, dev, cfg):
    """(b): fp32 training on the card against the CPU from the same
    parameters, at full width cut to TRAIN_CHECK["layers"] layers: the
    loss and every gradient leaf; AdamW on the card applied to the CPU's
    gradients against the CPU's AdamW (parameters, m and v); and one
    `make_train_step` on each device (loss, grad norm).  The step's
    parameters are compared through those two parts: Adam's first step
    is g / (|g| + eps) per element, so where a gradient is within its
    tolerance of eps it may move by anything up to 2 lr (their count is
    reported)."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.models.transformer import train_loss
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step
    from repro_torch.tree_util import flatten, leaves, tree_map

    c = TRAIN_CHECK
    cfg = dataclasses.replace(cfg, n_layers=c["layers"])
    tcfg = TrainConfig(dtype=torch.float32, optimizer=adamw.AdamWConfig(
        peak_lr=c["peak_lr"], warmup_steps=1, total_steps=10))
    card = init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(2), dev)
    host = tree_map(lambda x: x.detach().cpu().clone(), card)
    batch = SyntheticLM(cfg.vocab_size, c["seq"], c["batch"], seed=3).batch_at(0)

    def value_and_grad(state, device):
        flat = leaves(state.params)
        for p in flat:
            p.requires_grad_(True)
        loss = train_loss(cfg, state.params, to_device(batch, device), dtype=torch.float32)
        loss.backward()
        grads = [p.grad.detach().cpu() for p in flat]
        for p in flat:
            p.grad = None
        return float(loss.detach()), grads

    def leaf_err(got, want):
        got, want = got.detach().cpu(), want.detach()
        return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)

    t0 = time.perf_counter()
    loss, grads = value_and_grad(card, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_loss, want_grads = value_and_grad(host, "cpu")
    host_s = time.perf_counter() - t0
    grad_err = max(leaf_err(g, w) for g, w in zip(grads, want_grads))

    # AdamW on both devices over the CPU's gradients
    treedef = flatten(host.params)[1]
    clone = lambda t: tree_map(lambda x: x.detach().clone(), t)  # noqa: E731
    got = adamw.update(tcfg.optimizer,
                       treedef.unflatten([g.to(dev, copy=True) for g in want_grads]),
                       clone(card.opt), clone(card.params))
    want = adamw.update(tcfg.optimizer, treedef.unflatten([g.clone() for g in want_grads]),
                        clone(host.opt), clone(host.params))
    update_err = max(leaf_err(a, b) for a, b in zip(leaves(got[:2]), leaves(want[:2])))

    step = make_train_step(cfg, tcfg)
    card, m = step(card, batch)
    host, want_m = step(host, batch)
    step_loss_err = abs(float(m["loss"]) - float(want_m["loss"])) / abs(float(want_m["loss"]))
    gnorm_err = abs(float(m["grad_norm"]) - float(want_m["grad_norm"])) / float(
        want_m["grad_norm"])
    moved = sum(int(((p.detach().cpu() - w.detach()).abs()
                     > c["leaf_tol"] * float(w.detach().abs().max())).sum())
                for p, w in zip(leaves(card.params), leaves(host.params)))
    out = dict(n_layers=cfg.n_layers, batch=c["batch"], seq=c["seq"], loss=loss,
               cpu_loss=want_loss, loss_rel_err=abs(loss - want_loss) / abs(want_loss),
               grad_leaf_err=grad_err, update_leaf_err=update_err,
               step_loss_rel_err=step_loss_err, step_grad_norm_rel_err=gnorm_err,
               step_elements_beyond_leaf_tol=moved,
               params=sum(x.numel() for x in leaves(host.params)),
               grad_norm=float(m["grad_norm"]), cpu_grad_norm=float(want_m["grad_norm"]),
               lr=float(want_m["lr"]), card_s=card_s, cpu_s=host_s)
    log(f"[train] card vs CPU, fp32, {cfg.n_layers} layers at full width, batch {c['batch']} "
        f"x {c['seq']}: loss {loss:.6f} / {want_loss:.6f} (rel {out['loss_rel_err']:.2e}, "
        f"tol {c['loss_rel_tol']:g}), worst gradient leaf {grad_err:.2e} of the leaf's max "
        f"(tol {c['leaf_tol']:g}); AdamW on the same gradients: worst leaf {update_err:.2e}; "
        f"one make_train_step: loss rel {step_loss_err:.2e}, grad norm "
        f"{out['grad_norm']:.6f} / {out['cpu_grad_norm']:.6f} (rel {gnorm_err:.2e}), "
        f"{moved} of {out['params']} parameters beyond {c['leaf_tol']:g} of their leaf's max "
        f"(Adam's first step where |g| is near eps)")
    if max(out["loss_rel_err"], step_loss_err, gnorm_err) > c["loss_rel_tol"] or max(
            grad_err, update_err) > c["leaf_tol"]:
        raise AssertionError(f"train card vs cpu: {out}")
    return out


def train_restart(torch, dev, cfg):
    """(c): the launcher's `Supervisor` at full width cut to
    TRAIN_RESTART["layers"] layers, bf16, compressed gradients,
    microbatches: a failure at `fail_at`, a restart from the last
    checkpoint, the steps since replayed, and the last checkpoint
    restored bit for bit."""
    import dataclasses
    import tempfile

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.launch.train import train_fns
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.supervisor import FailureInjector, StragglerDetector, Supervisor
    from repro_torch.train.trainer import TrainConfig
    from repro_torch.tree_util import leaves

    c = TRAIN_RESTART
    cfg = dataclasses.replace(cfg, n_layers=c["layers"])
    tcfg = TrainConfig(microbatches=c["microbatches"], remat=True, dtype=torch.bfloat16,
                       compress_grads=True, optimizer=AdamWConfig(
                           peak_lr=c["peak_lr"], warmup_steps=c["warmup_steps"],
                           total_steps=c["steps"]))
    make_state, step_fn = train_fns(cfg, tcfg, batch=c["batch"], seq=c["seq"], seed=0,
                                    device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        ckpt = CheckpointManager(d)
        io_s = {"save": 0.0, "wait": 0.0, "restore": 0.0}   # restore includes a wait

        def timed(name, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    io_s[name] += time.perf_counter() - t
            return run

        for name in io_s:
            setattr(ckpt, name, timed(name, getattr(ckpt, name)))
        sup = Supervisor(make_state, step_fn, ckpt, ckpt_every=c["ckpt_every"],
                         failure_injector=FailureInjector((c["fail_at"],)),
                         straggler=StragglerDetector())
        t0 = time.perf_counter()
        state = sup.run(c["steps"])
        wall = time.perf_counter() - t0
        seen = [h["step"] for h in sup.history]
        last = ckpt.latest_step()
        ckpt_gb = sum(os.path.getsize(os.path.join(d, f"step_{last:08d}", f))
                      for f in os.listdir(os.path.join(d, f"step_{last:08d}"))) / 1e9
        t0 = time.perf_counter()
        back = ckpt.restore(last, like=state)
        restore_s = time.perf_counter() - t0
        equal = all(torch.equal(a.detach(), b) for a, b in
                    zip(leaves(state), leaves(back)))
        steps_on_disk = ckpt.all_steps()
    ckpt_from = c["fail_at"] // c["ckpt_every"] * c["ckpt_every"]
    losses = [h["loss"] for h in sup.history]
    out = dict(n_layers=cfg.n_layers, batch=c["batch"], seq=c["seq"], steps=c["steps"],
               restarts=sup.restarts, history_steps=len(seen), replayed=list(range(
                   ckpt_from, c["fail_at"])), first_loss=losses[0], last_loss=losses[-1],
               checkpoints=steps_on_disk, checkpoint_gb=ckpt_gb, wall_s=wall,
               losses=losses, restore_s=restore_s, checkpoint_io_s=io_s,
               restored_bit_for_bit=equal,
               stragglers=len(sup.straggler.events))
    log(f"[train] Supervisor, {cfg.n_layers} layers at full width, bf16, compressed "
        f"gradients, {c['microbatches']} microbatches, batch {c['batch']} x {c['seq']}: "
        f"{c['steps']} steps with a failure at {c['fail_at']} in {wall:.1f} s, "
        f"{sup.restarts} restart, {len(seen)} steps run; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; checkpoints {steps_on_disk} ({ckpt_gb:.2f} GB each; host s "
        f"{ {k: round(v, 1) for k, v in io_s.items()} }), the last restored in "
        f"{restore_s:.1f} s, equal bit for bit: {equal}")
    twice = all(seen.count(s) == 2 for s in out["replayed"])
    if not (sup.restarts == 1 and twice and losses[-1] < losses[0] and last == c["steps"]
            and equal and seen[-1] == c["steps"] - 1):
        raise AssertionError(f"train restart: {out}")
    return out


def phase_train(torch, dev, report):
    """stablelm-3b trained through `launch/train.py`'s path: (a) at full
    width, (b) one fp32 step on the card against the CPU, (c) the
    supervisor's failure and restart."""
    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    out = report["train"] = {}
    out["full"] = train_full(torch, dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = train_card_vs_cpu(torch, dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    out["restart"] = train_restart(torch, dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 11: the hybrid and ssm families (zamba2-1.2b, rwkv6-7b)
# ---------------------------------------------------------------------------

SSM_ARCHS = ("zamba2-1.2b", "rwkv6-7b")
# (a) serving at full width and depth, bf16: `batch` prompts of `prompt`
# tokens, prefill into a cache of `max_len`, then `steps` greedy decode
# steps (the first `warm` untimed, the last one profiled)
SSM_SERVE = dict(batch=8, prompt=512, max_len=576, steps=64, warm=4)
# (b) decode consistency at full width and depth: prefill(S+1)'s last
# logits against prefill(S) + decode_step, relative to their norm.  fp32
# (TF32 off) within 1e-4, phase moe's limit.  The bf16 limit was set
# before the first card run from the CPU gap at the reduced configs (this
# function in a CPU rehearsal of the phase, B=4, S=64): zamba2 1.047e-2
# over its 4 Mamba2 layers (prefill's conv sums in float32, decode's in
# bf16, as in JAX), rwkv6 0; over 38 layers the gap may grow about 3x
# (roundings adding like a random walk over 10x the layers), so 2^-3.
# rwkv6 with random weights is chaotic in depth: in fp32 on the card
# prefill(65) and prefill(64) + decode_step (other GEMM shapes, other
# summation orders) differ by 3.8e-5 at 8 layers and 1.4e-2 at 32, a
# growth of about 1.28x per layer.  So its fp32 check holds the first
# `fp32_layers` layers to 1e-4, as phase moe holds 8, and reports the
# full depth
SSM_CONSISTENCY = dict(B=4, S=64, fp32_rel_tol=1e-4, bf16_rel_tol=2.0 ** -3,
                       fp32_layers={"rwkv6-7b": 8})
# (c) fp32 on the card against the CPU at full width cut to `layers`
# (zamba2: 2 groups of 2 Mamba2 layers): prefill's logits and cache, then
# `decode_steps` steps (logits within 1e-4 of their norm, every cache leaf
# within 2e-5 of its norm); train_loss within 1e-5 relative, as phase
# train (b) holds it, and each gradient leaf within 1e-4 of its max or,
# where the gradients are worse conditioned than that, within twice the
# CPU's own spread: how far its gradients move when the parameters move
# by 1e-7 of themselves.  At 2 layers of full width rwkv6's move by up
# to 1.43e-4 of a leaf's max under that noise on an H100's host, so 1e-4
# is below what two summation orders can promise
SSM_CHECK = dict(layers={"zamba2-1.2b": 4, "rwkv6-7b": 2}, B=2, S=32, decode_steps=4,
                 train_seq=64, logit_rel_tol=1e-4, leaf_rel_tol=2e-5, loss_rel_tol=1e-5,
                 grad_leaf_tol=1e-4, noise_floor_factor=2)
# (d) training through launch/train.py's path, bf16 over float32 masters,
# remat: zamba2 at full depth, rwkv6 cut to 4 of its 32 layers
SSM_TRAIN = {"zamba2-1.2b": dict(layers=None, batch=4, seq=512, microbatches=2, steps=3),
             "rwkv6-7b": dict(layers=4, batch=4, seq=256, microbatches=2, steps=3)}


class EventTimer:
    """Device time of the calls of wrapped functions (CUDA events around
    each call, summed after a synchronize): the time the card spends from
    the call's first op to its last, its own idle gaps included."""

    def __init__(self, torch):
        self.torch, self.pairs = torch, {}

    def wrap(self, name, fn):
        Event = self.torch.cuda.Event
        pairs = self.pairs.setdefault(name, [])

        def run(*a, **kw):
            ev = (Event(enable_timing=True), Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            pairs.append(ev)
            return out
        return run

    def take(self, name):
        """Summed ms and call count of `name` since the last take."""
        self.torch.cuda.synchronize()
        pairs = self.pairs.get(name, [])
        ms = sum(a.elapsed_time(b) for a, b in pairs)
        n = len(pairs)
        del pairs[:]
        return ms, n


def ssm_tokens(torch, cfg, B, S, seed):
    return torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(seed))


def ssm_serve(torch, dev, name):
    """(a): `prefill` of B prompts, then greedy `decode_step`s over the
    dense cache, bf16 at full width: prefill s (and its scan's share),
    steady ms per decode step (CUDA events), decode tokens/s, peak
    memory, and one profiled step (launches, device idle share).
    Returns (the row, the parameters)."""
    from torch.profiler import ProfilerActivity

    from repro_torch.configs import get_config
    from repro_torch.models import rwkv as rwkv_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.transformer import decode_step, init_params, prefill
    from repro_torch.tree_util import leaves, tree_map

    r = SSM_SERVE
    cfg = get_config(name)
    bf16 = torch.bfloat16
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=bf16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(x.numel() * x.element_size() for x in leaves(params)) / 1e9
    toks = ssm_tokens(torch, cfg, r["batch"], r["prompt"], 11).to(dev)
    # the sequential scan: the SSD chunk loop's body, or the wkv recurrence
    mod, fn = (ssm_lib, "_chunk_step") if cfg.family == "hybrid" else (rwkv_lib, "_wkv_scan")
    timer, plain = EventTimer(torch), getattr(mod, fn)
    setattr(mod, fn, timer.wrap("scan", plain))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(cfg, params, {"tokens": toks}, r["max_len"], dtype=bf16)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_scan_ms, prefill_scan_calls = timer.take("scan")
        finite = torch.isfinite(lg).all()
        tok = lg.argmax(-1)
        out_tokens, step_events = [tok], []
        for _ in range(r["steps"] - 1):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            lg, cache = decode_step(cfg, params, cache, tok, dtype=bf16)
            ev[1].record()
            step_events.append(ev)
            finite = finite & torch.isfinite(lg).all()
            tok = lg.argmax(-1)
            out_tokens.append(tok)
        scan_ms, scan_calls = timer.take("scan")
    finally:
        setattr(mod, fn, plain)
    step_ms = [a.elapsed_time(b) for a, b in step_events]
    steady = step_ms[r["warm"]:]
    ms = sum(steady) / len(steady)
    # the wkv scan's share of the decode steps (all of them); zamba2's
    # decode has no scan, one recurrence step per layer
    decode_scan_share = scan_ms / sum(step_ms) if cfg.family == "ssm" else None
    # the last step, profiled on a copy of the cache: a trace now and then
    # comes back without its device events, and a retry needs the same state
    copy = lambda t: tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, t)  # noqa: E731
    snap = copy(cache)
    kind = "CUDA" if dev.type == "cuda" else "CPU"
    acts = [ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU]
    for _ in range(3):
        run_cache = copy(snap)
        torch.cuda.synchronize()
        with traced(torch, acts) as tr:
            t0 = time.perf_counter()
            lg, run_cache = decode_step(cfg, params, run_cache, tok, dtype=bf16)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in tr.events
                  if str(getattr(e, "device_type", "")).endswith(kind)]
        if events:
            break
    else:
        raise AssertionError(f"{name}: three profiled decode steps gave no device events")
    finite = finite & torch.isfinite(lg).all()
    out_tokens.append(lg.argmax(-1))
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    busy = device_busy(events) / 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = torch.stack(out_tokens, 1).cpu()
    if not bool(finite) or run_cache["pos"] != r["max_len"]:
        raise AssertionError(f"{name}: non-finite logits or pos {run_cache['pos']}")
    out = dict(arch=name, n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
               batch=r["batch"], prompt=r["prompt"], max_len=r["max_len"],
               decode_steps=r["steps"], init_s=init_s, weight_gb=weight_gb,
               prefill_s=prefill_s, prefill_scan_ms=prefill_scan_ms,
               prefill_scan_calls=prefill_scan_calls,
               prefill_scan_share=prefill_scan_ms / (prefill_s * 1e3),
               decode_step_ms=step_ms, ms_per_decode_step=ms,
               decode_tokens_per_s=r["batch"] / (ms / 1e3),
               decode_scan_ms=scan_ms, decode_scan_calls=scan_calls,
               decode_scan_share=decode_scan_share, peak_memory_gb=peak / 1e9,
               profiled_step=dict(wall_ms=wall_ms, device_busy_ms=busy,
                                  idle_share=1 - busy / wall_ms, launches=len(kernels),
                                  device_events=len(events)),
               tokens=tokens.tolist())
    scan_name = "SSD chunk scan" if cfg.family == "hybrid" else "wkv scan"
    log(f"[ssm] {name} full width ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; {weight_gb:.2f} GB of weights, bf16 projections) from seed 0 in "
        f"{init_s:.1f} s; B={r['batch']} prompts of {r['prompt']}, cache {r['max_len']}")
    log(f"[ssm]   prefill {prefill_s:.3f} s, the {scan_name} {prefill_scan_ms:.1f} ms of it "
        f"({100 * out['prefill_scan_share']:.1f}%, {prefill_scan_calls} calls); decode "
        f"{ms:.3f} ms per step (steady, CUDA events; the first steps "
        f"{[round(t, 2) for t in step_ms[:6]]}), {out['decode_tokens_per_s']:.1f} tokens/s"
        + (f", the wkv scan {100 * decode_scan_share:.1f}% of the steps"
           if decode_scan_share is not None else "")
        + f"; peak {out['peak_memory_gb']:.2f} GB")
    log(f"[ssm]   profiled step: {wall_ms:.2f} ms wall, device busy {busy:.2f} ms (idle "
        f"{out['profiled_step']['idle_share']:.4f}), {len(kernels)} kernel launches")
    return out, params


def ssm_consistency(torch, dev, cfg, params, dtype, tol):
    """(b): prefill(S+1)'s last logits against prefill(S) + decode_step,
    relative to their norm; "ok" if within `tol` (None: measured, not
    held)."""
    from repro_torch.models.transformer import decode_step, prefill

    B, S = SSM_CONSISTENCY["B"], SSM_CONSISTENCY["S"]
    toks = ssm_tokens(torch, cfg, B, S + 1, 7).to(dev)
    full, _ = prefill(cfg, params, {"tokens": toks}, S + 4, dtype=dtype)
    _, cache = prefill(cfg, params, {"tokens": toks[:, :S]}, S + 4, dtype=dtype)
    dec, cache = decode_step(cfg, params, cache, toks[:, S], dtype=dtype)
    rel = float((dec - full).norm() / full.norm())
    row = dict(dtype=str(dtype).replace("torch.", ""), n_layers=cfg.n_layers, B=B, S=S,
               rel_err=rel, rel_tol=tol, max_abs_err=float((dec - full).abs().max()),
               logit_scale=float(full.abs().max()),
               argmax_equal=int((dec.argmax(-1) == full.argmax(-1)).sum()))
    row["ok"] = bool((tol is None or rel <= tol) and torch.isfinite(dec).all()
                     and cache["pos"] == S + 1)
    log(f"[ssm]   prefill({S + 1}) against prefill({S}) + decode_step, {cfg.name}, "
        f"{cfg.n_layers} layers, B={B}, {row['dtype']}: relative error {rel:.3e} (limit "
        f"{'none, measured' if tol is None else f'{tol:.3e}'}), max |diff| "
        f"{row['max_abs_err']:.3e} of logits up to {row['logit_scale']:.2f}, argmax equal "
        f"in {row['argmax_equal']} of {B} rows")
    return row


def ssm_card_vs_cpu(torch, dev, name):
    """(c): fp32 at full width cut to SSM_CHECK's layers, the card against
    the same on CPU tensors in this process: `prefill` (logits, every
    cache leaf), `decode_step`s on the CPU's greedy tokens, then
    `train_loss` and its gradients."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.models.transformer import (
        decode_step,
        init_params,
        prefill,
        train_loss,
    )
    from repro_torch.tree_util import flatten, leaves, tree_map

    c = SSM_CHECK
    cfg = dataclasses.replace(get_config(name), n_layers=c["layers"][name])
    f32 = torch.float32
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3), device=dev,
                         dtype=f32)
    host = tree_map(lambda x: x.cpu(), params)
    toks = ssm_tokens(torch, cfg, c["B"], c["S"], 12)

    def rel(got, want):
        got, want = got.detach().cpu(), want.detach()
        return float((got - want).norm()) / max(float(want.norm()), 1e-30)

    def cache_leaves(cache):
        flat, treedef = flatten({k: v for k, v in cache.items() if k != "pos"})
        return flat, str(treedef)

    max_len = c["S"] + c["decode_steps"]
    t0 = time.perf_counter()
    lg, cache = prefill(cfg, params, {"tokens": toks.to(dev)}, max_len, dtype=f32)
    want, hcache = prefill(cfg, host, {"tokens": toks}, max_len, dtype=f32)
    logit_err = [rel(lg, want)]
    prefill_leaf_err = max(rel(a, b) for a, b in zip(cache_leaves(cache)[0],
                                                     cache_leaves(hcache)[0]))
    for _ in range(c["decode_steps"]):
        tok = want.argmax(-1)
        lg, cache = decode_step(cfg, params, cache, tok.to(dev), dtype=f32)
        want, hcache = decode_step(cfg, host, hcache, tok, dtype=f32)
        logit_err.append(rel(lg, want))
    (mine, tree_a), (theirs, tree_b) = cache_leaves(cache), cache_leaves(hcache)
    decode_leaf_err = max(rel(a, b) for a, b in zip(mine, theirs))
    serve_s = time.perf_counter() - t0

    batch = SyntheticLM(cfg.vocab_size, c["train_seq"], c["B"], seed=3).batch_at(0)

    def value_and_grad(p, device):
        flat = leaves(p)
        for x in flat:
            x.requires_grad_(True)
        loss = train_loss(cfg, p, to_device(batch, device), dtype=f32)
        loss.backward()
        grads = [x.grad.detach().cpu() for x in flat]
        for x in flat:
            x.grad = None
            x.requires_grad_(False)
        return float(loss.detach()), grads

    def leaf_errs(got):
        return [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for g, w in zip(got, want_grads)]

    t0 = time.perf_counter()
    loss, grads = value_and_grad(params, dev)
    want_loss, want_grads = value_and_grad(host, "cpu")
    # the gradients' own conditioning: the CPU's, from parameters moved by
    # 1e-7 of themselves (about an ulp)
    gen = torch.Generator().manual_seed(5)
    nudged = tree_map(lambda x: x * (1 + 1e-7 * torch.randn(x.shape, generator=gen)), host)
    floor = max(leaf_errs(value_and_grad(nudged, "cpu")[1]))
    del nudged
    train_s = time.perf_counter() - t0
    errs = leaf_errs(grads)
    grad_err = max(errs)
    grad_tol = max(c["grad_leaf_tol"], c["noise_floor_factor"] * floor)
    loss_err = abs(loss - want_loss) / abs(want_loss)
    out = dict(arch=name, n_layers=cfg.n_layers, B=c["B"], S=c["S"],
               logit_rel_err=logit_err, prefill_leaf_rel_err=prefill_leaf_err,
               decode_leaf_rel_err=decode_leaf_err, cache_leaves=len(mine),
               loss=loss, cpu_loss=want_loss, loss_rel_err=loss_err,
               grad_leaf_err=grad_err, grad_noise_floor=floor, grad_leaf_tol=grad_tol,
               train_seq=c["train_seq"], serve_s=serve_s, train_s=train_s)
    log(f"[ssm]   {name} card vs CPU, fp32, {cfg.n_layers} layers at full width: logits "
        f"(prefill, then {c['decode_steps']} decode steps) {[f'{e:.2e}' for e in logit_err]}"
        f" of their norm (limit {c['logit_rel_tol']:g}); worst of {len(mine)} cache leaves "
        f"{prefill_leaf_err:.2e} after prefill, {decode_leaf_err:.2e} after decode (limit "
        f"{c['leaf_rel_tol']:g}); train_loss {loss:.6f} / {want_loss:.6f} (rel "
        f"{loss_err:.2e}, limit {c['loss_rel_tol']:g}), worst gradient leaf {grad_err:.2e} "
        f"of its max (limit {grad_tol:.2e}: the CPU's own gradients move by {floor:.2e} "
        f"under 1e-7 parameter noise); {serve_s:.1f} s + {train_s:.1f} s")
    out["worst_grad_leaves"] = sorted(zip(errs, leaf_paths(host)), reverse=True)[:4]
    out["ok"] = not (tree_a != tree_b or max(logit_err) > c["logit_rel_tol"]
                     or max(prefill_leaf_err, decode_leaf_err) > c["leaf_rel_tol"]
                     or loss_err > c["loss_rel_tol"] or grad_err > grad_tol)
    log(f"[ssm]     worst gradient leaves: {out['worst_grad_leaves']}")
    return out


def leaf_paths(tree, prefix=""):
    """'/'-joined key paths of a dict tree's leaves, in `tree_util` order
    (keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def ssm_train(torch, dev, name):
    """(d): `launch/train.py`'s path (`train_fns`), bf16 over float32
    masters, remat: ms per step (CUDA events; the first warms up),
    tokens/s, peak memory, finite losses."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_fns
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig
    from repro_torch.tree_util import leaves

    r = SSM_TRAIN[name]
    cfg = get_config(name)
    if r["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=r["layers"])
    tcfg = TrainConfig(microbatches=r["microbatches"], remat=True, dtype=torch.bfloat16,
                       optimizer=AdamWConfig(peak_lr=3e-4, warmup_steps=1,
                                             total_steps=r["steps"]))
    make_state, step_fn = train_fns(cfg, tcfg, batch=r["batch"], seq=r["seq"], seed=0,
                                    device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = make_state()
    n_params = sum(x.numel() for x in leaves(state.params))
    steps = []
    for i in range(r["steps"]):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, m = step_fn(state, i)
        ev[1].record()
        steps.append((ev, m))
    torch.cuda.synchronize()
    step_ms = [ev[0].elapsed_time(ev[1]) for ev, _ in steps]
    losses = [float(m["loss"]) for _, m in steps]
    gnorms = [float(m["grad_norm"]) for _, m in steps]
    ms = sum(step_ms[1:]) / len(step_ms[1:])
    tokens = r["batch"] * r["seq"]
    peak = torch.cuda.max_memory_allocated(dev)
    out = dict(arch=name, n_layers=cfg.n_layers, params=n_params, batch=r["batch"],
               seq=r["seq"], microbatches=r["microbatches"], step_ms=step_ms,
               ms_per_step=ms, tokens_per_s=tokens / (ms / 1e3), peak_memory_gb=peak / 1e9,
               losses=losses, grad_norms=gnorms)
    log(f"[ssm]   {name} training, {cfg.n_layers} layers at full width ({n_params} "
        f"parameters), bf16 over float32 masters, remat, {r['batch']} x {r['seq']} in "
        f"{r['microbatches']} microbatches: steps {[round(t, 1) for t in step_ms]} ms, "
        f"steady {ms:.1f} ms, {out['tokens_per_s']:.1f} tokens/s, peak "
        f"{out['peak_memory_gb']:.2f} GB; losses {[round(v, 4) for v in losses]}")
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"{name} training: losses {losses}, grad norms {gnorms}")
    return out


def phase_ssm(torch, dev, report):
    """zamba2-1.2b and rwkv6-7b on the card, no kernel of the port on
    their path: (a) serving at full width, (b) decode consistency in bf16
    and fp32, (c) fp32 card against CPU at 2 layers, (d) training."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.tree_util import tree_map

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = report["ssm"] = {"card": report.get("card")}
    c = SSM_CONSISTENCY
    for name in SSM_ARCHS:
        row = out[name] = {}
        row["serve"], params = ssm_serve(torch, dev, name)
        cfg = get_config(name)
        row["consistency_bf16"] = ssm_consistency(torch, dev, cfg, params, torch.bfloat16,
                                                  c["bf16_rel_tol"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                             dtype=torch.float32)
        cut = c["fp32_layers"].get(name)
        row["consistency_fp32"] = [ssm_consistency(torch, dev, cfg, params, torch.float32,
                                                   None if cut else c["fp32_rel_tol"])]
        if cut:   # the first `cut` layers of the same parameters
            stack = "groups" if cfg.family == "hybrid" else "layers"
            short = dict(params, **{stack: tree_map(lambda a: a[:cut], params[stack])})
            row["consistency_fp32"].append(ssm_consistency(
                torch, dev, dataclasses.replace(cfg, n_layers=cut), short, torch.float32,
                c["fp32_rel_tol"]))
            del short
        del params
        gc.collect()
        torch.cuda.empty_cache()
        row["card_vs_cpu"] = ssm_card_vs_cpu(torch, dev, name)
        gc.collect()
        torch.cuda.empty_cache()
        row["train"] = ssm_train(torch, dev, name)
        gc.collect()
        torch.cuda.empty_cache()
    failed = [(name, k) for name in SSM_ARCHS for k in ("consistency_bf16", "card_vs_cpu")
              if not out[name][k]["ok"]] + [
        (name, f"consistency_fp32 at {r['n_layers']} layers") for name in SSM_ARCHS
        for r in out[name]["consistency_fp32"] if not r["ok"]]
    if failed:
        raise AssertionError(f"phase ssm: {failed}")


# ---------------------------------------------------------------------------
# Phase 12: distributed training over NCCL, a world of one rank
# ---------------------------------------------------------------------------

# One card holds one NCCL rank, so the process group has one rank and the
# mesh is (1, 1) ("data", "model"): DTensor runs the same local ops as the
# unsharded path, and what differs is its dispatch on the host.
# (a) fp32 at full width cut to `layers`: the sharded train_loss and its
# gradients against the unsharded ones from the same weights and batch
DIST_CHECK = dict(layers=2, batch=2, seq=128, loss_rel_tol=1e-6, leaf_tol=1e-6)
# (b) full depth with phase train (a)'s TrainConfig and batch: `steps`
# sharded steps and as many unsharded ones, the first of each a warm-up
DIST_STEPS = 3
# (c) compressed_psum of one fp32 gradient of `numel` elements, timed over
# `reps` calls after one untimed
DIST_PSUM = dict(numel=64 << 20, reps=5)
# (d) pipeline_apply with one stage against the sequential layers
DIST_PP = dict(layers=8, n_micro=4, mb=256, tol=1e-5)
# (e) sharded serving against unsharded from the same weights: stablelm-3b
# at full width and depth in bf16, `batch` prompts of `prompt` into a
# cache of `max_len`, `steps` greedy decode steps (the first `warm` not in
# the steady ms); the greedy tokens must be equal (a (1, 1) mesh runs the
# same local ops)
DIST_SERVE = dict(batch=8, prompt=512, max_len=1024, steps=32, warm=2)
# then each family's placements in fp32 at full width cut to `layers`
# (zamba2: one group): prefill of `batch` x `prompt`, `steps` decode
# steps on seeded tokens; logits and final cache leaves within `tol` of
# their max (the CPU tests' bound; bit equality expected and reported);
# and B=1 with the cache placed by the rule's branch for a batch that
# does not divide over dp (every batch divides over a dp group of one)
DIST_SERVE_FP32 = dict(layers={"phi3.5-moe-42b-a6.6b": 2, "zamba2-1.2b": None,
                               "rwkv6-7b": 2, "gemma2-27b": 2},
                       batch=2, prompt=64, steps=8, tol=1e-5)
DIST_SERVE_B1 = dict(prompt=64, steps=4)


def dist_check(torch, dev, cfg, mesh, axes):
    """(a): fp32 loss and gradients, sharded against unsharded."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLM, place_on_mesh, to_device
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.sharding import param_specs, shard_tree
    from repro_torch.models.transformer import init_params, train_loss
    from repro_torch.tree_util import leaves

    c = DIST_CHECK
    cfg = dataclasses.replace(cfg, n_layers=c["layers"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(4), device=dev,
                         dtype=torch.float32)
    batch = SyntheticLM(cfg.vocab_size, c["seq"], c["batch"], seed=5).batch_at(0)
    sharded = shard_tree(params, param_specs(axes, params), mesh)

    def value_and_grad(p, run):
        flat = leaves(p)
        for x in flat:
            x.requires_grad_(True)
        t0 = time.perf_counter()
        loss = run(p)
        loss.backward()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        grads = [x.grad.redistribute(x.device_mesh, x.placements).full_tensor()
                 if hasattr(x.grad, "full_tensor") else x.grad for x in flat]
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        return float(loss.detach()), [g.detach() for g in grads], s

    want_loss, want, plain_s = value_and_grad(params, lambda p: train_loss(
        cfg, p, to_device(batch, dev), dtype=torch.float32))
    with use_mesh(mesh):
        loss, got, sharded_s = value_and_grad(sharded, lambda p: train_loss(
            cfg, p, place_on_mesh(batch, mesh, axes.dp), axes=axes, dtype=torch.float32))
    errs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]
    out = dict(n_layers=cfg.n_layers, batch=c["batch"], seq=c["seq"], loss=loss,
               plain_loss=want_loss, loss_rel_err=abs(loss - want_loss) / abs(want_loss),
               loss_bit_equal=loss == want_loss, grad_leaf_err=max(errs),
               grad_leaves_bit_equal=sum(bool(torch.equal(g, w)) for g, w in zip(got, want)),
               grad_leaves=len(want), plain_s=plain_s, sharded_s=sharded_s)
    log(f"[dist] (a) fp32, {cfg.n_layers} layers at full width, batch {c['batch']} x "
        f"{c['seq']}, mesh (1, 1): sharded loss {loss:.8f} / unsharded {want_loss:.8f} "
        f"(rel {out['loss_rel_err']:.2e}, limit {c['loss_rel_tol']:g}), worst gradient leaf "
        f"{out['grad_leaf_err']:.2e} of its max (limit {c['leaf_tol']:g}); bit-equal "
        f"{out['grad_leaves_bit_equal']} of {len(want)} gradient leaves, loss "
        f"{out['loss_bit_equal']}; forward + backward {sharded_s:.2f} s sharded, "
        f"{plain_s:.2f} s unsharded (the first calls)")
    if out["loss_rel_err"] > c["loss_rel_tol"] or out["grad_leaf_err"] > c["leaf_tol"]:
        raise AssertionError(f"dist (a): {out}")
    return out


def dist_steps(torch, dev, cfg, mesh, axes, report):
    """(b): phase train (a)'s step at full depth, unsharded and sharded on
    the (1, 1) mesh, in this run: ms per step (CUDA events), tokens/s,
    peak memory, losses."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.train import train_fns
    from repro_torch.models.sharding import param_specs, shard_tree
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, TrainState, make_train_step

    r = TRAIN_RUN
    tcfg = TrainConfig(microbatches=r["microbatches"], remat=True, dtype=torch.bfloat16,
                       optimizer=adamw.AdamWConfig(peak_lr=r["peak_lr"],
                                                   warmup_steps=r["warmup_steps"],
                                                   total_steps=r["steps"]))
    tokens = r["batch"] * r["seq"]

    def run(state, step_fn):
        torch.cuda.reset_peak_memory_stats(dev)
        rows = []
        for i in range(DIST_STEPS):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            ev[0].record()
            state, m = step_fn(state, i)
            ev[1].record()
            rows.append((ev, m, time.perf_counter() - t0))
        torch.cuda.synchronize()
        step_ms = [ev[0].elapsed_time(ev[1]) for ev, _, _ in rows]
        ms = sum(step_ms[1:]) / len(step_ms[1:])
        losses = [float(m["loss"]) for _, m, _ in rows]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"dist (b): losses {losses}")
        return dict(step_ms=step_ms, host_s=[h for _, _, h in rows], ms_per_step=ms,
                    tokens_per_s=tokens / (ms / 1e3), losses=losses,
                    peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)

    make_state, step_fn = train_fns(cfg, tcfg, batch=r["batch"], seq=r["seq"], seed=0,
                                    device=dev)
    plain = run(make_state(), step_fn)
    gc.collect()
    torch.cuda.empty_cache()

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=torch.float32)
    params = shard_tree(params, param_specs(axes, params), mesh)
    gc.collect()
    torch.cuda.empty_cache()
    state = TrainState(params, adamw.init(params), {})
    del params
    data = SyntheticLM(cfg.vocab_size, r["seq"], r["batch"], seed=0)
    sharded_step = make_train_step(cfg, tcfg, axes)
    with use_mesh(mesh):
        sharded = run(state, lambda st, i: sharded_step(st, data.batch_at(i)))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    train_ms = report.get("train", {}).get("full", {}).get("ms_per_step")
    out = dict(n_layers=cfg.n_layers, batch=r["batch"], seq=r["seq"],
               microbatches=r["microbatches"], steps=DIST_STEPS, sharded=sharded,
               unsharded=plain, phase_train_ms_per_step=train_ms,
               dispatch_ms_per_step=sharded["ms_per_step"] - plain["ms_per_step"],
               loss_rel_diff=[abs(a - b) / abs(b) for a, b in
                              zip(sharded["losses"], plain["losses"])])
    log(f"[dist] (b) {cfg.name} full depth ({cfg.n_layers} layers), bf16 over float32 "
        f"masters, remat, {r['batch']} x {r['seq']} in {r['microbatches']} microbatches, "
        f"{DIST_STEPS} steps each, the first a warm-up: sharded on (1, 1) "
        f"{[round(t, 3) for t in sharded['step_ms']]} ms, steady "
        f"{sharded['ms_per_step']:.3f} ms ({sharded['tokens_per_s']:.1f} tokens/s, peak "
        f"{sharded['peak_memory_gb']:.2f} GB); unsharded in this phase "
        f"{[round(t, 3) for t in plain['step_ms']]} ms, steady {plain['ms_per_step']:.3f} ms "
        f"({plain['tokens_per_s']:.1f} tokens/s, peak {plain['peak_memory_gb']:.2f} GB); "
        f"phase train (a)'s steady step {train_ms} ms")
    log(f"[dist]     host seconds per call: sharded {[round(h, 3) for h in sharded['host_s']]}"
        f", unsharded {[round(h, 3) for h in plain['host_s']]}; losses sharded "
        f"{[round(v, 5) for v in sharded['losses']]}, unsharded "
        f"{[round(v, 5) for v in plain['losses']]}")
    return out


def dist_psum(torch, dev, mesh):
    """(c): compressed_psum over the NCCL group of mesh axis "data"."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import use_mesh
    from repro_torch.optim.compression import compress, compressed_psum, decompress

    c = DIST_PSUM
    g = torch.randn(c["numel"], generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev)

    def timed(fn):
        fn()
        evs = []
        for _ in range(c["reps"]):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            fn()
            ev[1].record()
            evs.append(ev)
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in evs]

    with use_mesh(mesh):
        out = compressed_psum(g, "data")
        psum_ms = timed(lambda: compressed_psum(g, "data"))
    want = decompress(*compress(g), g.shape)
    equal = bool(torch.equal(out, want))
    local_ms = timed(lambda: decompress(*compress(g), g.shape))
    flat = g.clone()
    group = mesh.get_group("data")
    allreduce_ms = timed(lambda: dist.all_reduce(flat, group=group))
    row = dict(numel=c["numel"], equal=equal, ms=sum(psum_ms) / len(psum_ms),
               ms_each=psum_ms, roundtrip_ms=sum(local_ms) / len(local_ms),
               fp32_all_reduce_ms=sum(allreduce_ms) / len(allreduce_ms),
               max_abs_err=float((out - want).abs().max()))
    log(f"[dist] (c) compressed_psum of {c['numel']} fp32 elements over NCCL (one rank): "
        f"equal to decompress(*compress(g)) {equal}; {row['ms']:.3f} ms (each "
        f"{[round(t, 3) for t in psum_ms]}), the local compress + decompress "
        f"{row['roundtrip_ms']:.3f} ms, a plain fp32 all_reduce {row['fp32_all_reduce_ms']:.3f}"
        f" ms")
    if not equal:
        raise AssertionError(f"dist (c): {row}")
    return row


def dist_pipeline(torch, dev, cfg):
    """(d): pipeline_apply on a one-stage 'pipe' mesh against the
    sequential layers, tanh(x @ w) at the model's width."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.pp import pipeline_apply

    c = DIST_PP
    d = cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn(c["layers"], d, d, generator=gen, device=dev) * d ** -0.5
    x = torch.randn(c["n_micro"], c["mb"], d, generator=gen, device=dev)
    body = lambda lw, h: torch.tanh(h @ lw)  # noqa: E731
    y = pipeline_apply(body, w, x, make_test_mesh((1,), ("pipe",)))
    ref = x
    for layer in range(c["layers"]):
        ref = body(w[layer], ref)
    err = float((y - ref).abs().max())
    row = dict(layers=c["layers"], n_micro=c["n_micro"], mb=c["mb"], d=d, max_abs_err=err,
               tol=c["tol"])
    log(f"[dist] (d) pipeline_apply, one stage, {c['layers']} layers of tanh(x @ w) at d "
        f"{d}, {c['n_micro']} microbatches of {c['mb']}: max |diff| against the "
        f"sequential layers {err:.3e} (limit {c['tol']:g})")
    if not err <= c["tol"]:
        raise AssertionError(f"dist (d): {row}")
    return row


def serve_tokens(torch, dev, vocab, shape, seed):
    return torch.randint(0, vocab, shape, generator=torch.Generator().manual_seed(seed)).to(dev)


def serve_run(torch, dev, cfg, params, prompts, max_len, steps, dtype, *, mesh=None,
              axes=None, feed=None, place_cache=None):
    """`prefill` then `steps` decode steps, sharded when `axes` is given
    (inside `use_mesh(mesh)`): greedy, or on the tokens of `feed` [B,
    steps].  `place_cache(cache)` may re-place prefill's cache before the
    steps.  Returns the logits of prefill and of each step (plain
    tensors), the tokens fed, the cache, and times: prefill s (host clock
    ending in a synchronize), each step's device ms (CUDA events) and
    host s per call, peak GB."""
    import contextlib

    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.transformer import decode_step, prefill

    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    ctx = use_mesh(mesh) if axes is not None else contextlib.nullcontext()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with ctx:
        t0 = time.perf_counter()
        lg, cache = prefill(cfg, params, {"tokens": prompts}, max_len, axes=axes, dtype=dtype)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if place_cache is not None:
            cache = place_cache(cache)
        logits, fed, events, host_s = [whole(lg)], [], [], []
        for t in range(steps):
            tok = logits[-1].argmax(-1) if feed is None else feed[:, t]
            fed.append(tok)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            h0 = time.perf_counter()
            ev[0].record()
            lg, cache = decode_step(cfg, params, cache, tok, axes=axes, dtype=dtype)
            ev[1].record()
            host_s.append(time.perf_counter() - h0)
            events.append(ev)
            logits.append(whole(lg))
        torch.cuda.synchronize()
    return dict(logits=logits, tokens=torch.stack(fed, 1), cache=cache, prefill_s=prefill_s,
                step_ms=[a.elapsed_time(b) for a, b in events], host_s=host_s,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def cache_placed(torch, cfg, cache, mesh, axes, divisible):
    """Whether every tensor leaf of `cache` is a DTensor placed by
    `cache_pspecs` (the branch `divisible` says)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import cache_pspecs, dp_spec, placements, spec_leaves
    from repro_torch.tree_util import leaves

    specs = spec_leaves(cache_pspecs(cfg, cache, dp_spec(axes), axes.tp, divisible))
    return all(isinstance(x, DTensor) and x.placements == placements(s, mesh)
               for x, s in zip(leaves(cache), specs) if torch.is_tensor(x))


def leaf_diff(torch, got, want):
    """Largest |got - want| over `want`'s largest |value|, and whether the
    two are bit-equal (`got` a DTensor or a plain tensor)."""
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    diff = float((got.float() - want.float()).abs().max())
    return diff / max(float(want.float().abs().max()), 1e-30), bool(torch.equal(got, want))


def dist_serve(torch, dev, mesh, axes):
    """(e): sharded `prefill` and `decode_step` against unsharded."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.sharding import (cache_pspecs, dp_spec, param_specs,
                                             shard_tree)
    from repro_torch.models.transformer import init_params
    from repro_torch.tree_util import leaves

    out = {}
    r = DIST_SERVE
    cfg = get_config(TRAIN_ARCH)
    bf16 = torch.bfloat16
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=bf16)
    sharded_params = shard_tree(params, param_specs(axes, params), mesh)
    prompts = serve_tokens(torch, dev, cfg.vocab_size, (r["batch"], r["prompt"]), 21)
    plain = serve_run(torch, dev, cfg, params, prompts, r["max_len"], r["steps"], bf16)
    sharded = serve_run(torch, dev, cfg, sharded_params, prompts, r["max_len"], r["steps"],
                        bf16, mesh=mesh, axes=axes)
    placed = cache_placed(torch, cfg, sharded["cache"], mesh, axes, True)
    equal = bool(torch.equal(sharded["tokens"], plain["tokens"]))
    # step t's logits are those of decode step t (index 0: prefill's)
    step_diff = [float((a - b).abs().max())
                 for a, b in zip(sharded["logits"], plain["logits"])]
    finite = all(bool(torch.isfinite(x).all()) for x in sharded["logits"])
    steady = lambda ms: sum(ms[r["warm"]:]) / len(ms[r["warm"]:])  # noqa: E731
    full = dict(arch=cfg.name, n_layers=cfg.n_layers, batch=r["batch"], prompt=r["prompt"],
                max_len=r["max_len"], steps=r["steps"], tokens_equal=equal,
                cache_placed=placed, prefill_logit_diff=step_diff[0],
                step1_logit_diff=step_diff[1], step32_logit_diff=step_diff[r["steps"]],
                max_logit_diff=max(step_diff), finite=finite)
    for name, run in (("sharded", sharded), ("unsharded", plain)):
        full[name] = dict(prefill_s=run["prefill_s"], step_ms=run["step_ms"],
                          ms_per_decode_step=steady(run["step_ms"]),
                          decode_tokens_per_s=r["batch"] / (steady(run["step_ms"]) / 1e3),
                          host_s_per_call=run["host_s"], peak_gb=run["peak_gb"])
    out["full"] = full
    log(f"[dist] (e) {cfg.name} full depth ({cfg.n_layers} layers), bf16, {r['batch']} "
        f"prompts of {r['prompt']}, cache {r['max_len']}, {r['steps']} greedy steps: tokens "
        f"sharded == unsharded {equal}; largest logit difference prefill "
        f"{step_diff[0]:.3e}, step 1 {step_diff[1]:.3e}, step {r['steps']} "
        f"{step_diff[r['steps']]:.3e}; cache placed by cache_pspecs {placed}")
    for name in ("sharded", "unsharded"):
        row = full[name]
        log(f"[dist]     {name}: prefill {row['prefill_s']:.3f} s, decode "
            f"{row['ms_per_decode_step']:.3f} ms per step (steady, CUDA events; the first "
            f"{[round(t, 2) for t in row['step_ms'][:4]]}), {row['decode_tokens_per_s']:.1f} "
            f"tokens/s, host s per call {[round(h, 4) for h in row['host_s_per_call'][:4]]}"
            f" ... {round(row['host_s_per_call'][-1], 4)}, peak {row['peak_gb']:.2f} GB")

    # B=1: prefill, then the cache placed by the rule's branch for a batch
    # that does not divide over dp (S over every mesh axis)
    b1 = DIST_SERVE_B1
    one = prompts[:1, :b1["prompt"]]
    max_len = b1["prompt"] + b1["steps"]

    def spread(cache):
        specs = cache_pspecs(cfg, cache, dp_spec(axes), axes.tp, False)
        whole = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                 for k, v in cache.items()}
        return shard_tree(whole, specs, mesh)

    p1 = serve_run(torch, dev, cfg, params, one, max_len, b1["steps"], bf16)
    s1 = serve_run(torch, dev, cfg, sharded_params, one, max_len, b1["steps"], bf16,
                   mesh=mesh, axes=axes, place_cache=spread)
    b1_row = dict(prompt=b1["prompt"], steps=b1["steps"],
                  cache_placed=cache_placed(torch, cfg, s1["cache"], mesh, axes, False),
                  tokens_equal=bool(torch.equal(s1["tokens"], p1["tokens"])),
                  max_logit_diff=max(float((a - b).abs().max())
                                     for a, b in zip(s1["logits"], p1["logits"])))
    out["b1"] = b1_row
    log(f"[dist] (e) B=1, {b1['prompt']} tokens, {b1['steps']} greedy steps on the cache placed "
        f"by the non-divisible branch (S over every axis; placed after the steps "
        f"{b1_row['cache_placed']}): tokens equal {b1_row['tokens_equal']}, largest logit "
        f"difference {b1_row['max_logit_diff']:.3e}")
    del params, sharded_params, plain, sharded, p1, s1
    gc.collect()
    torch.cuda.empty_cache()

    # each family's placements in fp32 at full width, cut in depth
    c = DIST_SERVE_FP32
    rows = []
    for name, layers in c["layers"].items():
        base = get_config(name)
        cut = dataclasses.replace(base, n_layers=layers or base.attn_every)
        t0 = time.perf_counter()
        params = init_params(cut, torch.Generator(device=dev).manual_seed(0), device=dev,
                             dtype=torch.float32)
        sharded_params = shard_tree(params, param_specs(axes, params), mesh)
        prompts = serve_tokens(torch, dev, cut.vocab_size, (c["batch"], c["prompt"]), 22)
        feed = serve_tokens(torch, dev, cut.vocab_size, (c["batch"], c["steps"]), 23)
        max_len = c["prompt"] + c["steps"]
        plain = serve_run(torch, dev, cut, params, prompts, max_len, c["steps"],
                          torch.float32, feed=feed)
        sharded = serve_run(torch, dev, cut, sharded_params, prompts, max_len, c["steps"],
                            torch.float32, mesh=mesh, axes=axes, feed=feed)
        logit = [leaf_diff(torch, a, b) for a, b in zip(sharded["logits"], plain["logits"])]
        cache = [leaf_diff(torch, a, b) for a, b in
                 zip(leaves(sharded["cache"]), leaves(plain["cache"])) if torch.is_tensor(b)]
        row = dict(arch=name, n_layers=cut.n_layers, batch=c["batch"], prompt=c["prompt"],
                   steps=c["steps"], logit_rel_diff=max(d for d, _ in logit),
                   logits_bit_equal=sum(e for _, e in logit), logit_outputs=len(logit),
                   cache_rel_diff=max(d for d, _ in cache),
                   cache_leaves_bit_equal=sum(e for _, e in cache), cache_leaves=len(cache),
                   cache_placed=cache_placed(torch, cut, sharded["cache"], mesh, axes, True),
                   sharded_prefill_s=sharded["prefill_s"], unsharded_prefill_s=plain["prefill_s"],
                   sharded_host_s_per_call=sharded["host_s"], run_s=time.perf_counter() - t0)
        rows.append(row)
        log(f"[dist] (e) fp32 {name} at full width, {cut.n_layers} layers, {c['batch']} x "
            f"{c['prompt']} + {c['steps']} steps, sharded against unsharded: logits "
            f"{row['logit_rel_diff']:.3e} of their max (bit-equal {row['logits_bit_equal']} of "
            f"{len(logit)}), cache leaves {row['cache_rel_diff']:.3e} (bit-equal "
            f"{row['cache_leaves_bit_equal']} of {len(cache)}); limit {c['tol']:g}; placed "
            f"{row['cache_placed']}; {row['run_s']:.1f} s")
        del params, sharded_params, plain, sharded
        gc.collect()
        torch.cuda.empty_cache()
    out["fp32"] = rows
    bad = [k for k, ok in (("tokens", full["tokens_equal"]), ("placed", full["cache_placed"]),
                           ("finite", full["finite"]), ("b1 tokens", b1_row["tokens_equal"]),
                           ("b1 placed", b1_row["cache_placed"]))
           if not ok]
    bad += [f"fp32 {x['arch']}" for x in rows if not (
        x["cache_placed"] and x["logit_rel_diff"] <= c["tol"] and x["cache_rel_diff"] <= c["tol"])]
    if bad:
        raise AssertionError(f"dist (e): {bad}")
    return out


def phase_dist(torch, dev, report):
    """The distribution layer over NCCL on the card, no kernel of the port
    on its path: (a) fp32 sharded loss and gradients against unsharded,
    (b) full-depth sharded training beside the unsharded step, (c) the
    compressed all-reduce, (d) the pipeline with one stage, (e) sharded
    serving against unsharded."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import MeshAxes

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        axes = MeshAxes()
        cfg = get_config(TRAIN_ARCH)
        out = report["dist"] = {"card": report.get("card"), "backend": dist.get_backend(),
                                "world_size": dist.get_world_size(),
                                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        log(f"[dist] {report.get('card')}; backend {out['backend']}, world "
            f"{out['world_size']}, mesh {out['mesh']}")
        out["check"] = dist_check(torch, dev, cfg, mesh, axes)
        gc.collect()
        torch.cuda.empty_cache()
        out["steps"] = dist_steps(torch, dev, cfg, mesh, axes, report)
        out["psum"] = dist_psum(torch, dev, mesh)
        out["pipeline"] = dist_pipeline(torch, dev, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out["serve"] = dist_serve(torch, dev, mesh, axes)
        out["serve"]["part_s"] = time.perf_counter() - t
        log(f"[dist] (e) in {out['serve']['part_s']:.1f} s")
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 13: the example twins on the card
# ---------------------------------------------------------------------------

# the serve_paged twin's ring for the snapshot the obsdump twin renders
EXAMPLES_RING = 4096
# s for the elastic twin's 8 gloo ranks together
EXAMPLES_ELASTIC_TIMEOUT = 300


def _obsdump(args):
    """`python -m repro_torch.tools.obsdump ARGS`: its stdout."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.tools.obsdump", *args],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    if r.returncode != 0:
        raise RuntimeError(f"obsdump {args} exited {r.returncode}: {r.stderr[-3000:]}")
    return r.stdout


def phase_examples(torch, dev, report):
    """`python -m repro_torch.examples.*` and the obsdump twin, each
    through its function: quickstart and train_tiny_lm on the card,
    serve_paged at full width in bf16 with the event ring, obsdump on
    the snapshot it wrote, elastic_restart on 8 gloo ranks of this
    machine's CPU (one card holds one NCCL rank)."""
    from repro_torch.configs import get_config
    from repro_torch.examples import elastic_restart, quickstart, serve_paged, train_tiny_lm
    from repro_torch.kernels import nbbs_alloc
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.trace_export import validate_trace

    out = report["examples"] = {"card": report.get("card")}
    out_dir = ROOT / "chiprun_out" / "examples"
    out_dir.mkdir(parents=True, exist_ok=True)

    def printed(name):
        lines = out.setdefault("printed", {}).setdefault(name, [])
        return lambda text: lines.extend(str(text).splitlines())

    # quickstart: kernels 4 and 3 on §4 and §6
    nbbs_alloc.wavefront_alloc_launches = 0
    nbbs_alloc.wavefront_step_launches = 0
    t = time.perf_counter()
    nums = quickstart.run(dev, out=printed("quickstart"))
    launches = {"nbbs_wavefront_alloc": nbbs_alloc.wavefront_alloc_launches,
                "nbbs_wavefront_step": nbbs_alloc.wavefront_step_launches}
    out["quickstart"] = dict(numbers=nums, launches=launches, s=time.perf_counter() - t)
    log(f"[examples] quickstart on the card: {nums}; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"quickstart: a kernel was not launched: {launches}")

    # serve_paged: stablelm-3b at full width in bf16, the ring on
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("stablelm-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=torch.bfloat16)
    snap = out_dir / "serve_paged.snapshot.json"
    nbbs_alloc.launches, pa.launches = 0, 0
    t = time.perf_counter()
    res = serve_paged.run(cfg, params, dev, torch.bfloat16, ring=EXAMPLES_RING,
                          snapshot=str(snap), out=printed("serve_paged"))
    launches = {"nbbs_pool_step": nbbs_alloc.launches, "paged_attention": pa.launches}
    host, jit = res["host"], res["jit"]
    same = sum(host["out_tokens"][i] == jit["out_tokens"][i] for i in host["out_tokens"])
    out["serve_paged"] = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, dtype="bfloat16",
        ring=EXAMPLES_RING, launches=launches, s=time.perf_counter() - t,
        host={k: v for k, v in host.items() if k != "out_tokens"},
        jit={k: v for k, v in jit.items() if k != "out_tokens"},
        requests_with_equal_tokens=same)
    log(f"[examples] serve_paged, {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}), bf16, {report.get('card')}: ServeEngine {host['tokens']} tokens, "
        f"{host['tokens_per_s']:.1f} tok/s, fully coalesced {host['fully_coalesced']}; "
        f"JitServeEngine {jit['tokens']} tokens, {jit['tokens_per_s']:.1f} tok/s (graph "
        f"capture included), free {jit['free_pages']}/{serve_paged.GEOM['num_pages']}; "
        f"equal tokens in {same} of {len(host['out_tokens'])} requests; launches {launches}")
    if not host["fully_coalesced"] or jit["free_pages"] != serve_paged.GEOM["num_pages"]:
        raise AssertionError(f"serve_paged: pages left in use: {out['serve_paged']}")
    if host["completed"] != serve_paged.N_REQUESTS or jit["completed"] != serve_paged.N_REQUESTS:
        raise AssertionError(f"serve_paged: not every request served: {out['serve_paged']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"serve_paged: a kernel was not launched: {launches}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # obsdump on that snapshot: the table, the events, a valid trace
    table = _obsdump([str(snap)])
    events = _obsdump([str(snap), "--events"])
    trace_path = out_dir / "serve_paged.trace.json"
    wrote = _obsdump([str(snap), "--trace", str(trace_path)])
    trace = json.loads(trace_path.read_text())
    validate_trace(trace)
    n_events = int(events.split()[0])
    n_steps = sum(1 for e in trace["traceEvents"]
                  if e["ph"] == "X" and e["name"].startswith("step "))
    out["obsdump"] = dict(table_lines=len(table.splitlines()), ring_events=n_events,
                          trace_events=len(trace["traceEvents"]), step_spans=n_steps,
                          wrote=wrote.strip())
    (out_dir / "serve_paged.metrics.txt").write_text(table)
    (out_dir / "serve_paged.events.txt").write_text(events)
    log(f"[examples] obsdump twin on the snapshot: a table of {out['obsdump']['table_lines']} "
        f"lines, {n_events} ring events, a trace of {len(trace['traceEvents'])} events "
        f"({n_steps} step spans) that validates")
    if "alloc_pages" not in table or n_events <= 0 or n_steps != jit["steps"]:
        raise AssertionError(f"obsdump: {out['obsdump']}, jit steps {jit['steps']}")

    # train_tiny_lm on the card, reduced by design
    t = time.perf_counter()
    tr = train_tiny_lm.run(dev, out=printed("train_tiny_lm"))
    out["train_tiny_lm"] = dict({k: v for k, v in tr.items() if k not in ("steps", "losses")},
                                s=time.perf_counter() - t)
    log(f"[examples] train_tiny_lm on the card: {tr['steps_run']} steps, first loss "
        f"{tr['first_loss']:.4f}, last {tr['last_loss']:.4f} (means of 10: "
        f"{tr['first_mean']:.4f} -> {tr['last_mean']:.4f}), {tr['restarts']} restart, "
        f"{out['train_tiny_lm']['s']:.1f} s")
    if tr["restarts"] != 1:
        raise AssertionError(f"train_tiny_lm: {tr['restarts']} restarts")

    # elastic_restart: 8 gloo ranks of this machine's CPU
    t = time.perf_counter()
    el = elastic_restart.run("cpu", timeout=EXAMPLES_ELASTIC_TIMEOUT,
                             out=printed("elastic_restart"))
    out["elastic_restart"] = dict(el, s=time.perf_counter() - t)
    log(f"[examples] elastic_restart, {el['ranks']} gloo ranks, {el['meshes'][0]} -> "
        f"{el['meshes'][1]}: losses {[round(x, 6) for x in el['losses']]}, unsharded "
        f"{[round(x, 6) for x in el['unsharded']]}, largest relative difference "
        f"{el['max_rel']:.3g}, {out['elastic_restart']['s']:.1f} s")
    for name, lines in out["printed"].items():
        for line in lines:
            log(f"[examples {name}] {line}")


# ---------------------------------------------------------------------------
# Phase 14: the sharded paths on gloo ranks of this machine's CPU
# ---------------------------------------------------------------------------

# Each case runs on a world of RANKS_N gloo ranks (subprocesses,
# `repro_torch.launch.ranks`: one thread each, CUDA hidden) at the reduced
# widths in fp32 under this machine's torch, and is held against the same
# case unsharded in this process with the tolerances of the CPU files that
# hold it against JAX (tests/test_torch_distribution*.py,
# tests/test_torch_moe_einsum_sharded.py): losses within 1e-5 relative,
# each gradient leaf within `grad_tol` of its largest element, the
# trainer's parameters within 5 x peak_lr and 1e-3 of each leaf's largest,
# the pipeline within 1e-5 (its gradient 1e-4), greedy tokens equal and
# logits within 1e-5 of their largest, compressed_psum bit-equal.
RANKS_N = 4
RANKS_TIMEOUT = 300      # s for the ranks together
RANKS_PG_TIMEOUT = 120   # s a collective waits for a peer before it raises
RANKS_SEED = 0
RANKS_BATCH = dict(batch=8, seq=16)
RANKS_OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6)
RANKS_STEPS = 3          # steps of the trainer case; the elastic case: 3 + 3
RANKS_SERVE = dict(batch=4, prompt=16, max_len=32, steps=4)
RANKS_PSUM = 1000        # elements of each rank's gradient
RANKS_PP = dict(layers=8, n_micro=4, mb=2, d=16)
_POD = ((2, 2), ("data", "model"))
_MOE = "phi3.5-moe-42b-a6.6b"
RANKS_CASES = {
    "grads-stablelm-3b": dict(kind="grads", arch="stablelm-3b", mesh=_POD),
    "grads-phi3.5-moe-scatter": dict(kind="grads", arch=_MOE, mesh=_POD),
    "grads-phi3.5-moe-einsum": dict(kind="grads", arch=_MOE, mesh=_POD,
                                    replace=dict(dispatch_mode="einsum", dispatch_group=32)),
    "grads-zamba2-1.2b": dict(kind="grads", arch="zamba2-1.2b", mesh=_POD, grad_tol=2e-5),
    "grads-rwkv6-7b": dict(kind="grads", arch="rwkv6-7b", mesh=_POD, grad_tol=2e-5),
    "grads-stablelm-3b-multipod": dict(kind="grads", arch="stablelm-3b",
                                       mesh=((2, 2, 1), ("pod", "data", "model")),
                                       axes=dict(dp=("pod", "data"))),
    "train-steps-stablelm-3b": dict(kind="steps", arch="stablelm-3b", mesh=_POD),
    "elastic-(2,2)-to-(1,4)": dict(kind="elastic", arch="stablelm-3b", mesh=_POD,
                                   to=((1, 4), ("data", "model"))),
    "compressed-psum": dict(kind="psum", mesh=_POD),
    "pipeline-2-stages": dict(kind="pp", mesh=((2, 2), ("pipe", "data"))),
    "serve-stablelm-3b": dict(kind="serve", arch="stablelm-3b", mesh=_POD),
    "serve-zamba2-1.2b": dict(kind="serve", arch="zamba2-1.2b", mesh=_POD),
}

# runs on every rank after `launch/ranks.py`'s preamble; `chip_smoke` is
# this file, on the ranks' path
RANKS_SCRIPT = """
import json, time, traceback
import chip_smoke
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.ranks import save_tree

inp = dict(np.load(os.path.join(OUT, "inputs.npz")))
meshes, status = {}, {}


def mesh_of(spec):
    key = (tuple(spec[0]), tuple(spec[1]))
    if key not in meshes:
        meshes[key] = make_test_mesh(*key)
    return meshes[key]


for key, case in chip_smoke.RANKS_CASES.items():
    t0 = time.perf_counter()
    try:
        res = chip_smoke.ranks_case(torch, case, inp, mesh_of, OUT)
        if RANK == 0:
            save_tree(os.path.join(OUT, key + ".npz"), res)
        err = None
    except Exception:
        err = traceback.format_exc()
        print(f"case {key} failed on rank {RANK}:\\n{err}", flush=True)
    status[key] = dict(seconds=time.perf_counter() - t0, error=err)
    if RANK == 0:
        with open(os.path.join(OUT, "status.json"), "w") as f:
            json.dump(status, f)
    dist.barrier()
print("RANK OK")
"""


def ranks_inputs(np) -> dict:
    """The cases' inputs, from numpy seeds; every rank reads them."""
    rng = np.random.default_rng(3)
    b, s = RANKS_BATCH["batch"], RANKS_BATCH["seq"]
    inp = {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
           "labels": rng.integers(0, 256, (b, s)).astype(np.int32)}
    rng = np.random.default_rng(7)
    psum = rng.standard_normal((RANKS_N, RANKS_PSUM)).astype(np.float32)
    psum[:, :7] = 0.0            # an all-zero start of a block: zero scales
    psum[1, 300] = 40.0          # one large element sets its block's max
    inp["psum"] = psum
    c = RANKS_PP
    inp["pp_w"] = (rng.standard_normal((c["layers"], c["d"], c["d"])) * 0.3).astype(np.float32)
    inp["pp_x"] = rng.standard_normal((c["n_micro"], c["mb"], c["d"])).astype(np.float32)
    inp["pp_t"] = rng.standard_normal((c["n_micro"], c["mb"], c["d"])).astype(np.float32)
    rng = np.random.default_rng(10)
    inp["prompts"] = rng.integers(0, 256, (RANKS_SERVE["batch"], RANKS_SERVE["prompt"])
                                  ).astype(np.int32)
    return inp


def _psum_reference(torch, rows):
    """compressed_psum's sum over the ranks holding `rows`: the shared
    per-block scale, each rank's int8 payload, their int32 sum."""
    from repro_torch.optim.compression import _blocks, _unblocks

    blocks = [_blocks(r)[0] for r in rows]
    scale = torch.stack([b.abs().amax(dim=1) for b in blocks]).amax(dim=0) / 127.0
    safe = torch.where(scale == 0, 1.0, scale)
    qsum = sum(torch.clamp(torch.round(b / safe[:, None]), -127, 127).to(torch.int8)
               .to(torch.int32) for b in blocks)
    return _unblocks(qsum.float() * scale[:, None], rows[0].shape)


def ranks_case(torch, case, inp, mesh_of=None, out_dir=None) -> dict:
    """One case of phase ranks as numpy arrays: on the ranks with
    `mesh_of` (a mesh for a (shape, names) pair), unsharded in one
    process without it."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, place_on_mesh
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.sharding import (MeshAxes, P, named_shardings, param_specs,
                                             placements, shard_tree)
    from repro_torch.models.transformer import decode_step, init_params, prefill, train_loss
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.train.pp import make_pp_loss, pipeline_apply
    from repro_torch.train.trainer import TrainConfig, TrainState, make_train_step
    from repro_torch.tree_util import flatten, leaves

    kind = case["kind"]
    mesh = mesh_of(case["mesh"]) if mesh_of else None
    axes = MeshAxes(**case.get("axes", {})) if mesh_of else None

    def scope(on=mesh):
        return use_mesh(on) if mesh_of else contextlib.nullcontext()

    def whole(x):
        x = x.detach()
        return (x.full_tensor() if isinstance(x, DTensor) else x).numpy()

    def model():
        cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case.get("replace", {}))
        return cfg, init_params(cfg, torch.Generator().manual_seed(RANKS_SEED), "cpu")

    def place(tree, on):
        return shard_tree(tree, param_specs(axes, tree), on) if mesh_of else tree

    if kind == "grads":
        cfg, params = model()
        params = place(params, mesh)
        for p in leaves(params):
            p.requires_grad_(True)
        batch = {k: inp[k] for k in ("tokens", "labels")}
        with scope():
            batch = (place_on_mesh(batch, mesh, axes.dp) if mesh_of
                     else {k: torch.from_numpy(v) for k, v in batch.items()})
            loss = train_loss(cfg, params, batch, axes=axes, dtype=torch.float32, remat=True)
            loss.backward()
        return dict({f"g{i:03d}": whole(p.grad) for i, p in enumerate(leaves(params))},
                    loss=whole(loss))

    if kind in ("steps", "elastic"):
        cfg, params = model()
        micro = 2 if kind == "steps" else 1
        step = make_train_step(cfg, TrainConfig(microbatches=micro, dtype=torch.float32,
                                                constrain_grads=True,
                                                optimizer=AdamWConfig(**RANKS_OPT)), axes)
        data = SyntheticLM(cfg.vocab_size, RANKS_BATCH["seq"], RANKS_BATCH["batch"], seed=0)
        state = place(TrainState(params, adamw.init(params), {}), mesh)
        losses = []

        def run(state, steps, on):
            with scope(on):
                for i in steps:
                    state, m = step(state, data.batch_at(i))
                    losses.append(float(m["loss"]))
            return state

        state = run(state, range(RANKS_STEPS), mesh)
        if kind == "steps":
            return dict({f"p{i:03d}": whole(x) for i, x in enumerate(leaves(state.params))},
                        losses=np.array(losses))
        if mesh_of:   # checkpoint on (2, 2), restore onto the other mesh
            ckpt = CheckpointManager(os.path.join(out_dir, "ckpt_elastic"), async_io=False)
            ckpt.save(RANKS_STEPS, state)
            to = mesh_of(case["to"])
            state = ckpt.restore(ckpt.latest_step(), state,
                                 shardings=named_shardings(param_specs(axes, state), to))
            if not all(t.device_mesh is to for t in flatten(state)[0]):
                raise AssertionError("a restored leaf is not on the new mesh")
            mesh = to
        run(state, range(RANKS_STEPS, 2 * RANKS_STEPS), mesh)
        return dict(losses=np.array(losses))

    if kind == "psum":
        rows = torch.from_numpy(inp["psum"])
        names = tuple(case["mesh"][1])
        out = {}
        for axis in (names[0], names[1], tuple(names)):
            key = "+".join(axis) if isinstance(axis, tuple) else axis
            if mesh_of:   # this rank's sum, gathered from every rank
                with scope():
                    mine = compressed_psum(rows[dist.get_rank()].clone(), axis)
                every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
                dist.all_gather(every, mine)
                out[key] = torch.stack(every).numpy()
                continue
            shape = case["mesh"][0]   # rank r at (r // shape[1], r % shape[1])
            coord = [divmod(r, shape[1]) for r in range(len(rows))]
            dims = ((0,) if axis == names[0] else (1,) if axis == names[1] else (0, 1))
            out[key] = torch.stack([
                _psum_reference(torch, [rows[q] for q in range(len(rows))
                                        if all(coord[q][d] == coord[r][d]
                                               for d in (0, 1) if d not in dims)])
                for r in range(len(rows))]).numpy()
        return out

    if kind == "pp":
        def body(w, h):
            return torch.tanh(h @ w)

        x = torch.from_numpy(inp["pp_x"])
        res = {}
        for mode in ("sharded", "whole"):
            w = torch.from_numpy(inp["pp_w"]).clone()
            if mesh_of and mode == "sharded":
                from torch.distributed.tensor import distribute_tensor
                w = distribute_tensor(w, mesh, placements(P("pipe"), mesh))
            w.requires_grad_(True)
            if mesh_of:
                y = pipeline_apply(body, w, x, mesh)
            else:
                y = x
                for layer in range(w.shape[0]):
                    y = body(w[layer], y)
            torch.square(y).sum().backward()
            res["y_" + mode], res["g_" + mode] = whole(y), whole(w.grad)
        w = torch.from_numpy(inp["pp_w"]).clone().requires_grad_(True)
        t = torch.from_numpy(inp["pp_t"])
        if mesh_of:
            loss = make_pp_loss(body, RANKS_PP["n_micro"])(w, x, t, mesh)
        else:
            y = x
            for layer in range(w.shape[0]):
                y = body(w[layer], y)
            loss = torch.mean(torch.square(y - t))
        loss.backward()
        res["loss"], res["loss_g"] = whole(loss), whole(w.grad)
        return res

    if kind == "serve":
        cfg, params = model()
        params = place(params, mesh)
        c = RANKS_SERVE
        res, toks = {}, []
        with scope():
            lg, cache = prefill(cfg, params, {"tokens": torch.from_numpy(inp["prompts"])},
                                c["max_len"], axes=axes, dtype=torch.float32)
            res["prefill"] = whole(lg)
            for t in range(c["steps"]):
                last = res["prefill"] if t == 0 else res[f"step{t - 1}"]
                nxt = torch.from_numpy(last.argmax(-1).astype(np.int32))
                toks.append(nxt.numpy())
                lg, cache = decode_step(cfg, params, cache, nxt, axes=axes, dtype=torch.float32)
                res[f"step{t}"] = whole(lg)
        res["tokens"] = np.stack(toks, 1)
        return res
    raise ValueError(kind)


def _rel_to_max(got, want) -> float:
    import numpy as np

    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def ranks_compare(case, got, want) -> tuple:
    """(ok, detail) of one case: the ranks' arrays against unsharded."""
    import numpy as np

    kind = case["kind"]
    if sorted(got) != sorted(want):
        return False, f"keys differ: {sorted(set(got) ^ set(want))}"
    if any(np.shape(got[k]) != np.shape(want[k]) for k in want):
        return False, "shapes differ"
    if kind == "grads":
        tol = case.get("grad_tol", 1e-5)
        loss = abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
        errs = [_rel_to_max(got[k], want[k]) for k in want if k != "loss"]
        equal = sum(np.array_equal(got[k], want[k]) for k in want if k != "loss")
        return (loss <= 1e-5 and max(errs) <= tol,
                f"loss {float(got['loss']):.6f} rel {loss:.2e} (limit 1e-5); worst of "
                f"{len(errs)} gradient leaves {max(errs):.2e} of its max (limit {tol:g}), "
                f"{equal} bit-equal")
    if kind in ("steps", "elastic"):
        g, w = got["losses"], want["losses"]
        rel = float(np.max(np.abs(g - w) / np.abs(w)))
        ok, detail = rel <= 1e-5, f"{len(w)} losses, worst rel {rel:.2e} (limit 1e-5)"
        if kind == "steps":
            lim = 5 * RANKS_OPT["peak_lr"] + 1e-7
            worst = max(float(np.abs(got[k] - want[k]).max()) for k in want if k != "losses")
            leaf = max(_rel_to_max(got[k], want[k]) for k in want if k != "losses")
            ok = ok and worst < lim and leaf <= 1e-3
            detail += (f"; parameters after {RANKS_STEPS} steps: worst {worst:.2e} (limit "
                       f"{lim:g}), {leaf:.2e} of a leaf's max (limit 1e-3)")
        return ok, detail
    if kind == "psum":
        equal = {k: bool(np.array_equal(got[k].view(np.uint32), want[k].view(np.uint32)))
                 for k in want}
        return all(equal.values()), f"bit-equal over each axis: {equal}"
    if kind == "pp":
        errs = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
        lim = dict(y_sharded=1e-5, y_whole=1e-5, g_sharded=1e-4, g_whole=1e-4, loss_g=1e-4,
                   loss=1e-5 * abs(float(want["loss"])))
        return (all(errs[k] <= lim[k] for k in want),
                ", ".join(f"{k} {errs[k]:.1e} (limit {lim[k]:.0e})" for k in sorted(want)))
    if kind == "serve":
        same = bool(np.array_equal(got["tokens"], want["tokens"]))
        errs = [_rel_to_max(got[k], want[k]) for k in want if k != "tokens"]
        return (same and max(errs) <= 1e-5,
                f"greedy tokens equal {same}; logits of prefill and {len(errs) - 1} decode "
                f"steps, worst {max(errs):.2e} of their max (limit 1e-5)")
    raise ValueError(kind)


def phase_ranks(torch, dev, report, out_dir=None):
    """The sharded paths on RANKS_N gloo ranks under this machine's torch,
    each case against the unsharded port in this process (computed while
    the ranks run); one line per case."""
    import numpy as np

    from repro_torch.launch.ranks import Ranks, load_tree

    out_dir = Path(out_dir or ROOT / "chiprun_out" / "ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    inp = ranks_inputs(np)
    np.savez(out_dir / "inputs.npz", **inp)
    t0 = time.perf_counter()
    ranks = Ranks(RANKS_N, RANKS_SCRIPT, out_dir, path=(str(ROOT),),
                  pg_timeout=RANKS_PG_TIMEOUT)
    want, ref_s, crashed = {}, {}, None
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for key, case in RANKS_CASES.items():
            t = time.perf_counter()
            want[key] = ranks_case(torch, case, inp)
            ref_s[key] = time.perf_counter() - t
    finally:
        torch.set_num_threads(threads)
        try:
            ranks.wait(RANKS_TIMEOUT)
        except RuntimeError as exc:
            crashed = exc
    wall = time.perf_counter() - t0
    status_path = out_dir / "status.json"
    status = json.loads(status_path.read_text()) if status_path.exists() else {}
    rows, failed = [], []
    log(f"[ranks] {RANKS_N} gloo ranks on this machine's CPU, torch {torch.__version__}, "
        f"fp32 at the reduced widths, each case against the unsharded port in this process")
    for key, case in RANKS_CASES.items():
        st = status.get(key)
        if st is None:
            ok, detail, secs = False, "not reached: the ranks ended before it", None
        elif st["error"]:
            ok, detail, secs = False, st["error"].strip().splitlines()[-1], st["seconds"]
        else:
            ok, detail = ranks_compare(case, load_tree(out_dir / f"{key}.npz"), want[key])
            secs = st["seconds"]
        rows.append(dict(case=key, mesh=case["mesh"], ok=ok, detail=detail,
                         error=st["error"] if st else None, seconds=secs,
                         unsharded_s=ref_s.get(key)))
        if not ok:
            failed.append(key)
        host = "-" if secs is None else f"{secs:.2f}"
        log(f"[ranks] {key} on {tuple(case['mesh'][0])} {case['mesh'][1]}: "
            f"{'ok' if ok else 'FAILED'}: {detail}; {host} s on the ranks, "
            f"{ref_s.get(key, 0):.2f} s unsharded")
    report["ranks"] = dict(torch=torch.__version__, n=RANKS_N, rows=rows, seconds=wall,
                           crashed=None if crashed is None else str(crashed)[-3000:])
    log(f"[ranks] {len(rows) - len(failed)} of {len(rows)} cases ok in {wall:.1f} s")
    if crashed is not None:
        raise AssertionError(f"ranks: {str(crashed)[-3000:]}")
    if failed:
        raise AssertionError(f"ranks: cases failed: {failed}")


# ---------------------------------------------------------------------------
# Phase 15: the dry run on a fake 256/512-rank world, the counter on the card
# ---------------------------------------------------------------------------

# (arch, shape, mesh, variant): one dry-run process each, side by side
DRYRUN_CELLS = (
    ("stablelm-3b", "train_4k", "single", "baseline"),
    ("stablelm-3b", "prefill_32k", "single", "baseline"),
    ("stablelm-3b", "decode_32k", "single", "baseline"),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "multi", "opt"),
    ("rwkv6-7b", "long_500k", "multi", "baseline"),
)
DRYRUN_TIMEOUT = 420    # seconds for the processes together
# part (b): phase dist (e)'s unsharded decode step (B=8, cache 1024) at 512
DRYRUN_COUNT = dict(batch=8, max_len=1024, pos=512, reps=5, warm=2)

NEST_CHECK = """
import json, sys
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.sharding import shard_range
rows = []
for rank in (0, 1, 15, 16, 17, 255, 256, 300, 511):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=512)
    mesh = make_production_mesh(multi_pod=True, device_type=sys.argv[1])
    place = [Shard(0), Shard(0), Replicate()]
    for size in (64, 50, 20):
        shape, offset = compute_local_shape_and_global_offset((size, 8), mesh, place)
        rows.append([rank, size, offset[0], shape[0], *shard_range(size, mesh, place, 0)])
    dist.destroy_process_group()
print(json.dumps(rows))
"""


def dryrun_processes(torch, out_dir):
    """(a): the dry-run processes side by side, each on the card's torch
    with fake CUDA tensors; their lines (the records go to `out_dir`)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    procs = []
    for arch, shape, mesh, variant in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cuda",
               "--arch", arch, "--shape", shape, "--mesh", mesh, "--variant", variant,
               "--out", str(out_dir)]
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    deadline = time.perf_counter() + DRYRUN_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.perf_counter(), 1)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = []
    for (arch, shape, mesh, variant), p, (stdout, stderr) in zip(DRYRUN_CELLS, procs, outs):
        lines = stdout.splitlines()
        alloc = [int(line.split("=")[1]) for line in lines
                 if line.startswith("cuda max_memory_allocated=")]
        made = [ln for ln in lines if ln.startswith("cuda allocation:")]
        runs.append(dict(arch=arch, shape=shape, mesh=mesh, variant=variant, rc=p.returncode,
                         lines=[ln for ln in lines if ln.startswith(("[", "cuda "))],
                         cuda_allocated=alloc[0] if alloc else None,
                         # allocations other than FakeTensorMode's context start
                         by_the_port=[ln for ln in made if " by init_gpu_context at " not in ln]))
        for line in runs[-1]["lines"]:
            log(f"[dryrun] {line}")
        if p.returncode != 0:
            log(f"[dryrun] {arch} {mesh} {variant}: exit {p.returncode}\n{stderr[-6000:]}")
    return runs


def dryrun_records(out_dir):
    """The records the processes wrote, cell by cell."""
    cells = []
    for path in sorted(out_dir.glob("*.json")):
        r = json.loads(path.read_text())
        if r.get("status") != "ok":
            cells.append(dict(arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                              status=r["status"], reason=r.get("reason", r.get("error"))))
            continue
        t = r["roofline"]
        gb = r["memory_analysis"]["peak_bytes_per_device"] / 1e9
        cells.append(dict(
            arch=r["arch"], shape=r["shape"], mesh=r["mesh"], variant=r["variant"],
            status="ok", gb_per_device=gb, of_gb=r["hw"]["hbm_bytes"] / 1e9,
            dominant=t["dominant"], compute_ms=t["compute_s"] * 1e3,
            memory_ms=t["memory_s"] * 1e3, collective_ms=t["collective_s"] * 1e3,
            per_collective=r["op_count_per_device"]["per_collective"],
            build_s=r["build_s"], count_s=r["count_s"],
            cuda_bytes=r["cuda_bytes_allocated"]))
        c = cells[-1]
        log(f"[dryrun] {c['arch']} {c['shape']} {c['mesh']} {c['variant']}: ok, "
            f"{gb:.2f} GB per device of {c['of_gb']:.0f}, dominant {c['dominant']}, "
            f"c/m/coll {c['compute_ms']:.1f}/{c['memory_ms']:.1f}/"
            f"{c['collective_ms']:.1f} ms, counted in {c['count_s']} s, "
            f"{c['cuda_bytes']} bytes allocated on the card")
    return cells


def nested_split(torch, device_type):
    """Rows of a dim split over ('pod', 'data') of the (2, 16, 16) mesh on
    this torch: DTensor's offset and length for sampled ranks of a fake
    world of 512 against `sharding.shard_range`'s nested chunks, for
    dims that divide (64) and that do not (50, 20: some shards short or
    empty)."""
    r = subprocess.run([sys.executable, "-c", NEST_CHECK, device_type], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT),
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    if r.returncode != 0:
        raise RuntimeError(f"nested split check: exit {r.returncode}\n{r.stderr[-4000:]}")
    rows = json.loads(r.stdout.strip().splitlines()[-1])
    # [rank, size, offset, length] by DTensor, then by shard_range; an
    # empty shard's offset is immaterial
    return dict(rows=rows, equal=all(row[3] == row[5] and (row[3] == 0 or row[2] == row[4])
                                     for row in rows))


def dryrun_counter(torch, dev):
    """(b): the counter on stablelm-3b's unsharded bf16 `decode_step` on
    the card, against the same call counted on fake CPU tensors, beside
    the step's measured ms."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import fake_tensors
    from repro_torch.models.transformer import decode_step, init_cache, init_params
    from repro_torch.roofline.op_count import HW_H100, OpCounter, roofline_terms

    r = DRYRUN_COUNT
    cfg = get_config(TRAIN_ARCH)
    bf16 = torch.bfloat16

    def inputs(device, gen):
        params = init_params(cfg, gen, device=device, dtype=bf16)
        cache = init_cache(cfg, r["batch"], r["max_len"], bf16, device)
        cache["pos"] = r["pos"]
        return params, cache, torch.zeros(r["batch"], dtype=torch.long, device=device)

    def count(args):
        counter = OpCounter()
        with counter:
            decode_step(cfg, *args, dtype=bf16)
        return counter

    params, cache, tokens = inputs(dev, torch.Generator(device=dev).manual_seed(0))
    card = count((params, cache, tokens))
    with fake_tensors():
        fake = count(inputs("cpu", torch.Generator().manual_seed(0)))
    step_ms = []
    for i in range(r["warm"] + r["reps"]):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        decode_step(cfg, params, cache, tokens, dtype=bf16)
        ev[1].record()
        torch.cuda.synchronize()
        if i >= r["warm"]:
            step_ms.append(ev[0].elapsed_time(ev[1]))
    got, want = card.result(), fake.result()
    differ = {op: (card.by_op.get(op), fake.by_op.get(op))
              for op in set(card.by_op) | set(fake.by_op)
              if card.by_op.get(op) != fake.by_op.get(op)}
    terms = roofline_terms(got, HW_H100)
    out = dict(card=got, fake_cpu=want, differ=differ,
               equal={k: got[k] == want[k] for k in ("flops", "bytes", "layout_bytes", "n_ops")},
               roofline=terms, step_ms=step_ms)
    log(f"[dryrun] (b) stablelm-3b decode_step B={r['batch']} at {r['pos']} on the card: "
        f"{got['flops']:.4e} flops, {got['bytes']:.4e} bytes, {got['layout_bytes']:.4e} "
        f"layout bytes, {got['n_ops']} ops; fake CPU {want['flops']:.4e} / "
        f"{want['bytes']:.4e} / {want['layout_bytes']:.4e} / {want['n_ops']}; equal "
        f"{out['equal']}; differing ops {sorted(differ)}")
    log(f"[dryrun] (b) memory_s {terms['memory_s'] * 1e3:.3f} ms, compute_s "
        f"{terms['compute_s'] * 1e3:.3f} ms; measured "
        f"{', '.join(f'{t:.3f}' for t in step_ms)} ms per step")
    del params, cache
    return out


def phase_dryrun(torch, dev, report):
    """The dry run of the production meshes on this card's torch: (a) the
    cells of `DRYRUN_CELLS`, one subprocess each (`python -m
    repro_torch.launch.dryrun --device cuda`: a fake world of 256 or 512
    ranks, fake CUDA tensors, nothing allocated on the card); the nested
    dp split of the multi-pod mesh against `sharding.shard_range`; (b)
    the counter on the card against fake CPU tensors."""
    out_dir = ROOT / "chiprun_out" / "dryrun_torch"
    shutil.rmtree(out_dir, ignore_errors=True)
    out = report["dryrun"] = {"card": report.get("card")}
    t = time.perf_counter()
    out["runs"] = dryrun_processes(torch, out_dir)
    out["cells"] = dryrun_records(out_dir)
    out["a_s"] = time.perf_counter() - t
    out["nested"] = nested_split(torch, "cuda")
    log(f"[dryrun] nested ('pod', 'data') split equals shard_range at every sampled rank: "
        f"{out['nested']['equal']}")
    gc.collect()
    torch.cuda.empty_cache()
    out["counter"] = dryrun_counter(torch, dev)
    bad = [r for r in out["runs"]
           if r["rc"] != 0 or r["cuda_allocated"] is None or r["by_the_port"]]
    ok = [c for c in out["cells"] if c["status"] == "ok"]
    if bad or len(ok) != len(DRYRUN_CELLS):
        raise RuntimeError(f"dry run: {len(ok)} cells ok of {len(DRYRUN_CELLS)}; failed processes, "
                           f"or allocations on the card besides FakeTensorMode's: "
                           f"{[(r['arch'], r['rc'], r['by_the_port']) for r in bad]}")
    if not out["nested"]["equal"]:
        raise RuntimeError(f"nested split differs from shard_range: {out['nested']['rows']}")
    if not all(math.isfinite(x) and x > 0 for x in
               (out["counter"]["card"]["flops"], out["counter"]["card"]["bytes"])):
        raise RuntimeError("the counter gave no work for the card's decode step")


# ---------------------------------------------------------------------------
# Phase 16: flash attention (kernel 5) through ops.flash_attention
# ---------------------------------------------------------------------------

FLASH_S = 4096         # stablelm-3b and phi3-medium rows
FLASH_S_GEMMA = 8192   # gemma2-27b's global and local rows
FLASH_S_FP32 = 2048
FLASH_GRAD_S, FLASH_GRAD_WINDOW = 2048, 1024


def flash_rows(torch):
    """(name, config, S, variant, dtype, SDPA computes it) per row."""
    from repro_torch.configs import get_config

    stablelm, phi3 = get_config("stablelm-3b"), get_config("phi3-medium-14b")
    gemma = get_config("gemma2-27b")
    cap = dict(causal=True, softcap=gemma.attn_softcap)
    local = max(gemma.window_pattern)
    return [
        ("stablelm-3b", stablelm, FLASH_S, dict(causal=True), torch.bfloat16, True),
        ("phi3-medium-14b", phi3, FLASH_S, dict(causal=True), torch.bfloat16, True),
        ("gemma2-27b global", gemma, FLASH_S_GEMMA, cap, torch.bfloat16, False),
        ("gemma2-27b local", gemma, FLASH_S_GEMMA, dict(cap, window=local),
         torch.bfloat16, False),
        ("stablelm-3b fp32", stablelm, FLASH_S_FP32, dict(causal=True), torch.float32, True),
        ("phi3-medium-14b fp32", phi3, FLASH_S_FP32, dict(causal=True), torch.float32, True),
        ("gemma2-27b local fp32", gemma, FLASH_S_FP32, dict(cap, window=FLASH_GRAD_WINDOW),
         torch.float32, False),
    ]


def flash_inputs(torch, dev, cfg, S, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((1, cfg.n_heads, S, cfg.head_dim), (1, cfg.n_kv_heads, S, cfg.head_dim),
              (1, cfg.n_kv_heads, S, cfg.head_dim))
    return [torch.randn(sh, generator=g, device=dev, dtype=torch.float32).to(dtype)
            for sh in shapes]


def flash_pairs(S, Sk, causal, window):
    """Unmasked (row, col) pairs: the work these inputs need."""
    import numpy as np

    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i + 1, Sk) if causal else np.full(S, Sk)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(q, k, v, var):
    """Kernel 5's least time for these inputs: each input read once and
    the output written once over HBM_BPS, against 4 * B * Hq * pairs * D
    operations over the type's peak; for fp32 the lesser of the CUDA
    cores' term and the 3xTF32 split's (three TF32 products per product
    on the tensor cores), both kept."""
    B, Hq, S, D = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    pairs = flash_pairs(S, k.shape[2], var.get("causal", True), var.get("window"))
    ops_n = 4 * B * Hq * pairs * D
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    terms = {dtype: ops_n / PEAK[dtype] * 1e3}
    if dtype == "float32":
        terms = {"fp32 CUDA cores": terms[dtype],
                 "3xTF32 tensor cores": 3 * ops_n / TF32_PEAK * 1e3}
    ops_term = min(terms, key=terms.get)
    t_bytes = nbytes / HBM_BPS * 1e3
    return dict(pairs=pairs, operations=ops_n, bytes=nbytes, ops_terms_ms=terms,
                ops_term=ops_term, bytes_ms=t_bytes, bound_ms=max(t_bytes, terms[ops_term]),
                bound_by="operations" if terms[ops_term] >= t_bytes else "bytes")


def device_kernels(torch, fn, reps=3, attempts=5):
    """{kernel name: mean device ms per call} of the kernels that `reps`
    calls of fn ran, from a `torch.profiler` trace; {} when `attempts`
    traces in a row came back without device events (seen late in a
    process that traced much before)."""
    for _ in range(attempts):
        torch.cuda.synchronize()
        with traced(torch) as tr:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in tr.events:
            if on_card(e):
                ms = (e.time_range.end - e.time_range.start) / 1e3 / reps
                out[e.name] = out.get(e.name, 0.0) + ms
        if out:
            return out
    return {}


def flash_parts_ms(torch, fn):
    """Device ms per forward of kernel 5's launches by part: `split` (the
    fp32 body's split of K and V), `attention` (the attention kernel);
    None when the profiler saw no kernel."""
    names = device_kernels(torch, fn)
    if not names:
        return None
    return {part: sum(ms for name, ms in names.items() if key in name)
            for part, key in (("split", "split_kv_tf32"), ("attention", "flash_fwd"))}


def phase_flash(torch, dev, report, state):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    rows = flash_rows(torch)
    inputs = [flash_inputs(torch, dev, cfg, S, dtype, seed)
              for seed, (_, cfg, S, _, dtype, _) in enumerate(rows)]
    gemma = rows[2][1]
    gvar = dict(causal=True, softcap=gemma.attn_softcap, window=FLASH_GRAD_WINDOW)
    gq, gk, gv = flash_inputs(torch, dev, gemma, FLASH_GRAD_S, torch.float32, 99)
    weight = torch.randn(gq.shape, generator=torch.Generator(device=dev).manual_seed(7),
                         device=dev)

    # the path: the user's differentiable op, forward (kernel 5) and
    # backward, with the launch count read around it
    fa.launches = 0
    outs = [ops.flash_attention(q, k, v, **var)
            for (q, k, v), (_, _, _, var, _, _) in zip(inputs, rows)]
    leaves = [t.clone().requires_grad_() for t in (gq, gk, gv)]
    gout = ops.flash_attention(*leaves, **gvar)
    grads = torch.autograd.grad((gout * weight).sum(), leaves)
    gout = gout.detach()
    torch.cuda.synchronize()
    launches = fa.launches
    log(f"[flash] path: {len(rows)} rows and one gradient through ops.flash_attention, "
        f"{launches} kernel 5 launches")
    if launches != len(rows) + 1:
        raise AssertionError(f"kernel 5 launched {launches} times, expected {len(rows) + 1}")
    state["launches"] = {**state.get("launches", {}), "flash_attention": launches}

    # the build: registers and spills of each body (ptxas), and the
    # tensor-core instructions in its SASS
    from repro_torch.kernels import _build

    ptxas = report.get("ptxas", {}).get("flash_attention", {})
    sass = sass_counts(_build.BUILD_DIR / "flash_attention.so")
    for entry, ops_ in sass.items():
        info = ptxas.get(entry, {})
        smem = ""
        m = re.search(r"DP=(\d+), BK=(\d+), NST=(\d+)", entry)
        t = re.search(r"3xTF32, DP=(\d+), NST=(\d+)", entry)
        if t:   # the 3xTF32 launcher's: Q_lo of two warpgroups, the hi/lo K and V^T ring
            dp, nst = int(t[1]), int(t[2])
            panels = -(-dp // 32)
            smem = (f", {1024 + 2 * panels * 8192 + nst * 2 * 32 * (128 * panels + 4 * dp)}"
                    " bytes dynamic shared memory")
        elif m:   # the bf16 launcher's dynamic shared memory: Q and the K/V ring
            panels, bk, nst = -(-int(m[1]) // 64), int(m[2]), int(m[3])
            smem = (f", {1024 + panels * 128 * (2 * 64 + 2 * nst * bk)} bytes dynamic "
                    "shared memory")
        log(f"[flash] SASS {entry}: {ops_['HGMMA']} HGMMA, {ops_['HMMA']} HMMA; ptxas "
            f"{info.get('registers', 'not rebuilt')} registers, spill stores / loads "
            f"{info.get('spill_stores')} / {info.get('spill_loads')} bytes{smem}")
    for kind in ("<bf16", "<fp32 3xTF32, DP"):
        bodies = {e: c for e, c in sass.items() if e.startswith(kind)}
        if not bodies or any(c["HGMMA"] == 0 for c in bodies.values()):
            raise AssertionError(f"a {kind[1:]} body of kernel 5 has no wgmma (HGMMA) "
                                 f"instruction: {sass}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out_rows = []
    for (name, cfg, S, var, dtype, has_lib), (q, k, v), out in zip(rows, inputs, outs):
        want = fa.flash_attention_plain(q, k, v, **var)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs()
        max_err = float(err.max())
        limit = out_limit(torch, want)
        slack = float((err / limit).max())   # <= 1 passes
        ok = (out.shape == q.shape and bool(torch.isfinite(out).all()) and slack <= 1.0)
        tol = OUT_TOL[str(dtype).replace("torch.", "")]
        del want, err, limit
        ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **var), reps=5, warmup=1)
        parts = flash_parts_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **var))
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **var),
                           reps=2, warmup=1)
        library_ms, library_note = None, "SDPA has no logit softcap or sliding window"
        library_kernels = None
        if has_lib:
            gqa = cfg.n_heads != cfg.n_kv_heads
            try:
                kw = {"enable_gqa": True} if gqa else {}
                lib_err = float((sdpa(q, k, v, is_causal=True, **kw).float()
                                 - out.float()).abs().max())
                library_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True, **kw),
                                     reps=5, warmup=1)
                library_kernels = device_kernels(
                    torch, lambda: sdpa(q, k, v, is_causal=True, **kw))
                library_note = (f"scaled_dot_product_attention(is_causal=True"
                                f"{', enable_gqa=True' if gqa else ''}); max |diff| to "
                                f"kernel 5 {lib_err:.3e}; its kernels (profiler, ms): "
                                + ("; ".join(f"{n[:100]} {t:.4f}"
                                             for n, t in library_kernels.items())
                                   or "not measured (the profiler saw none)"))
            except TypeError as exc:   # a torch without enable_gqa
                library_note = f"scaled_dot_product_attention refused: {exc}"
        B, Hq, _, D = q.shape
        bound = flash_bound(q, k, v, var)
        bound_ms, ops_n = bound["bound_ms"], bound["operations"]
        row = dict(case=name, dtype=str(dtype).replace("torch.", ""), B=B, Hq=Hq,
                   Hkv=k.shape[1], D=D, S=S, **{k_: v_ for k_, v_ in var.items()},
                   max_abs_err=max_err, tol=tol, err_over_limit=slack, ok=ok, ms=ms,
                   parts_ms=parts, plain_ms=plain_ms,
                   library_ms=library_ms, library=library_note,
                   library_kernels=library_kernels, **bound,
                   tflops=ops_n / ms / 1e9, over_bound=ms / bound_ms,
                   over_library=None if library_ms is None else ms / library_ms)
        over_lib = ("no library call" if library_ms is None
                    else f"{row['over_library']:.2f}x library")
        terms = ", ".join(f"{n} {t:.4f} ms" for n, t in bound["ops_terms_ms"].items())
        split = ("not measured (the profiler saw no kernel)" if parts is None else
                 f"split {parts['split']:.4f} ms, attention {parts['attention']:.4f} ms")
        log(f"[flash] {name} ({row['dtype']}, {Hq}/{row['Hkv']} heads, D={D}, S={S}, "
            f"{var}): max_abs_err {max_err:.3e}, at most {slack:.3f} of its limit "
            f"({tol}) kernel {ms:.3f} ms (profiler: {split}) plain "
            f"{plain_ms:.3f} ms library {library_ms} ms bound {bound_ms:.4f} ms "
            f"({row['bound_by']}: bytes {bound['bytes_ms']:.4f} ms, operations "
            f"{ops_n:.3e}: {terms}); {row['tflops']:.1f} TFLOP/s "
            f"useful, {row['over_bound']:.2f}x bound, {over_lib}; {library_note}")
        out_rows.append(row)
        if not ok:
            raise AssertionError(f"kernel 5 disagrees with its plain version: {name}")
    del outs, inputs

    # The backward recomputes the reference, so this checks the autograd
    # wiring (argument order, the options' Nones), not kernel 5.
    plain_leaves = [t.clone().requires_grad_() for t in (gq, gk, gv)]
    want = torch.autograd.grad(
        (fa.flash_attention_plain(*plain_leaves, **gvar) * weight).sum(), plain_leaves)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(grads, want))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        gwant = fa.flash_attention_plain(gq, gk, gv, **gvar)
    fwd_slack = float(((gout - gwant).abs() / out_limit(torch, gwant)).max())
    log(f"[flash] gradient at gemma2-27b local widths, S={FLASH_GRAD_S}, window "
        f"{FLASH_GRAD_WINDOW}, fp32: max |grad diff| {grad_err:.3e} (tol 1e-5) "
        f"against autograd through the plain version; its forward (kernel 5) at most "
        f"{fwd_slack:.3f} of its limit ({OUT_TOL['float32']})")
    if not finite or grad_err > 1e-5:
        raise AssertionError(f"flash gradient differs by {grad_err}")
    if not fwd_slack <= 1.0:
        raise AssertionError(f"the gradient's forward is {fwd_slack} of its limit")
    report["flash"] = dict(rows=out_rows, launches=launches, sass=sass,
                           gradient=dict(S=FLASH_GRAD_S, window=FLASH_GRAD_WINDOW,
                                         max_abs_err=grad_err, tol=1e-5,
                                         forward_err_over_limit=fwd_slack))
    torch.cuda.empty_cache()
    return out_rows


# ---------------------------------------------------------------------------


def main(argv) -> int:
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
    if argv[:1] == ["--trace-loss"]:
        return trace_loss(torch, dev, argv)
    if argv:
        return ab(torch, dev, card, argv)
    report = {"card": card, "device": name, "torch": torch.__version__}
    t0 = time.perf_counter()
    logs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {sorted(logs)} in {report['build_s']:.1f} s")
    report["ptxas"] = {src: ptxas_entries(text) for src, text in logs.items()}
    for src, entries in report["ptxas"].items():
        for entry, info in entries.items():
            log(f"[ptxas {src}{entry}] {info['registers']} registers, "
                f"{info['spill_stores']} / {info['spill_loads']} bytes spill "
                f"stores / loads, {info['stack']} bytes stack")
    log("[build] nbbs_pool_step.so: nbbs_pool_step, nbbs_wavefront_step and "
        "nbbs_wavefront_alloc each launch nbbs_step_kernel<layout, tier, slab> by "
        "the tree layout, the memory tier and the fastpath")

    state: dict = {}
    failures = []
    phases = [
        ("attention", lambda: phase_attention(torch, dev, report)),
        ("alloc", lambda: phase_alloc(torch, dev, report)),
        ("fastpath", lambda: phase_fastpath(torch, dev, report)),
        ("frontends", lambda: phase_frontends(torch, dev, report)),
        ("single_tree", lambda: phase_single_tree(torch, dev, report, state)),
        ("engine", lambda: phase_engine(torch, dev, report, state)),
        ("profile", lambda: phase_profile(torch, dev, report, state)),
        ("cpu_trace", lambda: phase_cpu_trace(torch, report, state)),
        ("host_engine", lambda: phase_host_engine(torch, dev, report, state)),
        ("moe", lambda: phase_moe(torch, dev, report, state)),
        ("fp32", lambda: phase_fp32(torch, dev, report)),
        ("train", lambda: phase_train(torch, dev, report)),
        ("ssm", lambda: phase_ssm(torch, dev, report)),
        ("dist", lambda: phase_dist(torch, dev, report)),
        ("examples", lambda: phase_examples(torch, dev, report)),
        ("ranks", lambda: phase_ranks(torch, dev, report)),
        ("dryrun", lambda: phase_dryrun(torch, dev, report)),
        ("flash", lambda: phase_flash(torch, dev, report, state)),
    ]
    for pname, fn in phases:
        if pname in ("cpu_trace", "host_engine", "moe") and run_name(
                *ENGINE_RUNS[-1]) not in state:
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
    alloc = report["alloc"][0]     # unpacked S=1, depth 12
    slab = report["fastpath"]["rows"][0]   # the same churn with the slab
    # bench_wavefront's widest shape (depth 14, K=256), unpacked
    single = {r["kernel"]: r for r in report["single_tree"]["rows"]
              if r["layout"] == "unpacked" and r["depth"] == 14 and r["K"] == 256}
    flash = report["flash"]["rows"][2]   # gemma2-27b global, bf16
    # no single PyTorch call computes a buddy-allocator step
    kernels = [
        {"name": "nbbs_pool_step", "route": "cuda",
         "source": "src/repro_torch/csrc/nbbs_pool_step.cu",
         "replaces": "src/repro/kernels/nbbs_alloc.py:249",
         "launches": state["launches"]["nbbs_pool_step"],
         "max_abs_err": 0, "ms": alloc["ms"], "plain_ms": alloc["plain_ms"],
         "bound_ms": alloc["bound_ms"], "bound_by": alloc["bound_by"],
         "library_ms": None},
        {"name": "nbbs_pool_step (fastpath slab)", "route": "cuda",
         "source": "src/repro_torch/csrc/nbbs_pool_step.cu",
         "replaces": "src/repro/kernels/nbbs_alloc.py:249",
         "launches": state["launches"]["nbbs_pool_step_slab"],
         "max_abs_err": 0, "ms": slab["ms"], "plain_ms": slab["plain_ms"],
         "bound_ms": slab["bound_ms"], "bound_by": slab["bound_by"],
         "library_ms": None},
    ] + [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/csrc/nbbs_pool_step.cu",
         "replaces": f"src/repro/kernels/nbbs_alloc.py:{line}",
         "launches": state["launches"][name],
         "max_abs_err": 0, "ms": single[name]["ms"],
         "plain_ms": single[name]["plain_ms"], "bound_ms": single[name]["bound_ms"],
         "bound_by": single[name]["bound_by"], "library_ms": None}
        for name, line in (("nbbs_wavefront_step", 133), ("nbbs_wavefront_alloc", 86))
    ] + [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:37",
         "launches": state["launches"]["paged_attention"],
         "max_abs_err": att["max_abs_err"], "ms": att["ms"],
         "plain_ms": att["plain_ms"], "bound_ms": att["bound_ms"],
         "bound_by": att["bound_by"], "library_ms": None},
        # SDPA has no softcap: no single PyTorch call computes this row
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:47",
         "launches": state["launches"]["flash_attention"],
         "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
         "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
         "bound_by": flash["bound_by"], "library_ms": flash["library_ms"]},
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
    sys.exit(main(sys.argv[1:]))
