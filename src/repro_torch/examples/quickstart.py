"""Quickstart: the non-blocking buddy system in 60 seconds, through the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The twin of `examples/quickstart.py`, printing the same numbers: the
paper's API (alloc/free with splitting+coalescing), the packed bunch
variant (§III-D), the wavefront adaptation, and the hand-written CUDA
kernels (kernel 4 `nbbs_wavefront_alloc`, kernel 3
`nbbs_wavefront_step`) behind `kernels/ops.py`, which on CPU tensors
take their plain versions.  §1-§2 run on the host; §3-§6 on `--device`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import pool
from repro_torch.core.bunch import BunchBuddy
from repro_torch.core.concurrent import BUNCH_PACKED, TreeConfig, wavefront_alloc
from repro_torch.core.ref import NBBSRef
from repro_torch.examples import resolve_device
from repro_torch.kernels import ops


def run(device, out=print) -> dict:
    """All six sections on `device`, their lines given to `out`; returns
    the numbers they print.  Raises where the example asserts."""
    dev = torch.device(device)
    out("== 1. paper-faithful allocator (core/ref.py) ==")
    a = NBBSRef(total_memory=1024, min_size=8)
    x = a.nb_alloc(512)
    y = a.nb_alloc(256)
    z = a.nb_alloc(200)  # rounded up to 256
    out(f"alloc 512@{x}  256@{y}  200->256@{z}  free={a.free_bytes()}B")
    a.nb_free(y)
    w = a.nb_alloc(64)
    out(f"freed the middle 256; 64B lands inside it @ {w}")
    a.nb_free(x), a.nb_free(z), a.nb_free(w)
    a.check_invariants()
    out(f"all freed -> coalesced: alloc(1024) = {a.nb_alloc(1024)} (full block)")
    out(f"RMW instrumentation: {a.stats.cas_attempts} CAS attempts\n")

    out("== 2. packed bunches (paper §III-D; 3-level/32-bit words) ==")
    b = BunchBuddy(1024, 8, bunch_levels=4, word_bits=64)
    addrs = [b.nb_alloc(s) for s in (512, 256, 200)]
    for ad in addrs:
        b.nb_free(ad)
    out(f"same trace, word-RMWs: {b.stats.word_rmws} "
        f"(vs {a.stats.cas_attempts} unpacked)\n")
    nums = dict(cas_attempts=a.stats.cas_attempts, word_rmws=b.stats.word_rmws)

    out("== 3. wavefront: 32 concurrent allocations, one arbitration round ==")
    cfg = TreeConfig(depth=10, max_level=0)
    levels = torch.from_numpy(
        np.random.default_rng(0).integers(5, 11, 32).astype(np.int32)).to(dev)
    ones = torch.ones(32, dtype=torch.bool, device=dev)
    tree, nodes, ok, stats = wavefront_alloc(cfg, cfg.empty_tree(dev), levels, ones)
    out(f"committed {int(ok.sum())}/32 in {int(stats['rounds'])} round(s); "
        f"merged word-updates {int(stats['merged_writes'])} vs "
        f"{int(stats['logical_rmws'])} logical RMWs\n")
    nums.update(committed=int(ok.sum()), rounds=int(stats["rounds"]),
                merged_writes=int(stats["merged_writes"]),
                logical_rmws=int(stats["logical_rmws"]))

    out(f"== 4. the same wavefront as a CUDA kernel (kernel 4; {dev.type} tensors) ==")
    t2, n2, _, _ = ops.nbbs_wavefront_alloc(cfg, cfg.empty_tree(dev), levels)
    if not (torch.equal(t2, tree) and torch.equal(n2, nodes)):
        raise AssertionError("§4: the kernel differs from the plain rounds")
    out("kernel output bit-identical to the plain rounds  [OK]")

    out("\n== 5. sharded pool: 4 replicated trees, overflow routing ==")
    pcfg = pool.PoolConfig(TreeConfig(depth=8, max_level=0), n_shards=4)
    trees, pnodes, shard, pok, pstats = pool.pool_wavefront_alloc(
        pcfg, pcfg.empty_trees(dev), levels - 2, ones)
    per_shard = torch.bincount(shard[pok].long(), minlength=4).tolist()
    out(f"committed {int(pok.sum())}/32 across shards {per_shard} "
        f"in {int(pstats['rounds'])} round(s); "
        f"{int(pstats['overflows'])} overflowed their home shard")
    trees, _, _ = pool.pool_wavefront_free(pcfg, trees, pnodes, shard, pok)
    if trees.any():
        raise AssertionError("§5: burst release left a tree non-empty")
    out("burst release: one merged pass per shard, all trees empty  [OK]")
    nums.update(pool_committed=int(pok.sum()), pool_rounds=int(pstats["rounds"]),
                pool_overflows=int(pstats["overflows"]), per_shard=per_shard)

    out("\n== 6. packed-bunch device layout (§III-D on the wavefront) ==")
    pcfg6 = TreeConfig(depth=10, max_level=0, layout=BUNCH_PACKED)
    ptree, pn, pko, pst = ops.nbbs_wavefront_alloc(pcfg6, pcfg6.empty_tree(dev), levels)
    if not torch.equal(pn, nodes):  # same answers
        raise AssertionError("§6: packed nodes differ from unpacked")
    out(f"identical nodes to the unpacked tree; state "
        f"{pcfg6.n_state_words} uint32 words vs {cfg.n_state_words} int32 "
        f"(~{cfg.n_state_words / pcfg6.n_state_words:.1f}x smaller); "
        f"merged climb writes {int(pst['merged_writes'])} vs "
        f"{int(stats['merged_writes'])}")
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    ptree, _, _, _ = ops.nbbs_wavefront_step(pcfg6, ptree, pn, pko, none)
    if ptree.any():
        raise AssertionError("§6: packed release left words set")
    out("packed release drains to an all-zero packed tree  [OK]")
    nums.update(packed_words=pcfg6.n_state_words, unpacked_words=cfg.n_state_words,
                packed_merged_writes=int(pst["merged_writes"]))
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
