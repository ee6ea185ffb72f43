"""Public kernel ops of the port.

Counterpart of `repro/kernels/ops.py:76-419`.  There is no
`impl` switch: each op dispatches on the device of its tensors.  CPU
tensors take the plain PyTorch version; CUDA tensors launch the
hand-written kernel or raise.  No path falls back from the card to the
plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import fastpath as fpmod
from repro_torch.core import magazine as magmod
from repro_torch.core import pool as pool_mod
from repro_torch.core.concurrent import I32, TreeConfig
from repro_torch.core.pool import PoolConfig
from repro_torch.kernels import nbbs_alloc
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.kernels.ref import mha_reference
from repro_torch.obs.schema import WAVEFRONT_ALLOC_SLOTS, WAVEFRONT_STEP_SLOTS, unpack_slots


class _FlashAttention(torch.autograd.Function):
    """`jax.custom_vjp` of `repro/kernels/ops.py:76-112`: the forward is
    the kernel (on the card), the backward recomputes `mha_reference`
    and returns its vector-Jacobian product.  Like JAX's, the backward
    materialises the S x Sk logits; there is no backward kernel.  The
    kernel's output never enters the gradient: a gradient test checks
    this wiring, not the kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return flash_attention_fwd(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = mha_reference(*leaves, **ctx.opts)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable attention. q: [B,Hq,S,D], k/v: [B,Hkv,Sk,D]."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)


def _all_active(levels: torch.Tensor, active: torch.Tensor | None) -> torch.Tensor:
    if active is None:
        return torch.ones(levels.shape[0], dtype=torch.bool, device=levels.device)
    return active


def nbbs_wavefront_alloc(
    cfg: TreeConfig,
    tree: torch.Tensor,
    levels: torch.Tensor,
    *,
    active: torch.Tensor | None = None,
    max_rounds: int = 64,
):
    """Allocation wavefront on one tree (kernel 4 on the card).
    Returns (tree, nodes, ok, stats-dict)."""
    tree, nodes, ok, row = nbbs_alloc.wavefront_alloc(
        cfg, tree, levels, _all_active(levels, active), max_rounds
    )
    return tree, nodes, ok, unpack_slots(WAVEFRONT_ALLOC_SLOTS, row)


def nbbs_wavefront_step(
    cfg: TreeConfig,
    tree: torch.Tensor,
    free_nodes: torch.Tensor,
    free_active: torch.Tensor,
    levels: torch.Tensor,
    *,
    active: torch.Tensor | None = None,
    max_rounds: int = 64,
):
    """Mixed release+allocation round on one tree (kernel 3 on the
    card): the merged release, then the alloc wavefront.  Returns
    (tree, nodes, ok, stats)."""
    tree, nodes, ok, row = nbbs_alloc.wavefront_step(
        cfg, tree, free_nodes, free_active, levels,
        _all_active(levels, active), max_rounds,
    )
    out = unpack_slots(WAVEFRONT_STEP_SLOTS, row)
    out["free_writes"] = out["free_merged_writes"]  # legacy alias
    return tree, nodes, ok, out


def nbbs_pool_wavefront_step(
    pcfg: PoolConfig,
    trees: torch.Tensor,
    free_nodes: torch.Tensor,
    free_shard: torch.Tensor,
    free_active: torch.Tensor,
    levels: torch.Tensor,
    *,
    lane_ids: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
    max_rounds: int = 64,
    mags: magmod.MagazineState | None = None,
    free_mag_lane: torch.Tensor | None = None,
    alloc_mag_lane: torch.Tensor | None = None,
    free_mag_rank: torch.Tensor | None = None,
    alloc_mag_rank: torch.Tensor | None = None,
    assume_owned_frees: bool = False,
):
    """Pooled mixed release + allocation step across S sharded trees
    (the lockstep router's semantics; one kernel launch on the card,
    slab phase included with `pcfg.fastpath`).  Returns (trees, nodes,
    shard, ok, stats).

    With `mags` (needs `pcfg.magazines`) the magazines fuse around the
    step, as `core.pool.pool_wavefront_step_mag`; the `*_mag_rank` and
    `assume_owned_frees` arguments are its stash and claim fast paths.
    On CPU tensors that plain function runs; on the card
    `_pool_step_mag` does.  Returns (trees, mags, nodes, shard, ok,
    stats) in this mode."""
    active = _all_active(levels, active)
    if mags is None:
        return nbbs_alloc.pool_step(
            pcfg, trees, free_nodes, free_shard, free_active, levels,
            active, lane_ids, max_rounds,
        )
    if pcfg.magazines is None:
        raise ValueError("mags given but pcfg has no MagazineConfig")
    if lane_ids is None:
        lane_ids = torch.arange(levels.shape[0], dtype=I32, device=trees.device)
    args = (pcfg, trees, mags, free_nodes, free_shard, free_active, levels,
            active, max_rounds, lane_ids, free_mag_lane, alloc_mag_lane,
            free_mag_rank, alloc_mag_rank, assume_owned_frees)
    if trees.device.type == "cpu":
        return pool_mod.pool_wavefront_step_mag(*args)
    return _pool_step_mag(*args)


def _pool_step_mag(pcfg, trees, mags, free_nodes, free_shard, free_active, levels,
                   active, max_rounds, lane_ids, free_mag_lane, alloc_mag_lane,
                   free_mag_rank, alloc_mag_rank, assume_owned_frees):
    """The magazine path on the card, with no host sync: the stash
    phase, the claim, one launch of kernel A (the release of what did
    not stash, then the rounds of the claim's misses), and a second
    launch that spills every stashed page back and retries the failed
    lanes from home, both masked by `do_spill` (failed lanes and a
    non-empty magazine).  With nothing to spill the second launch
    changes nothing and counts nothing.  Magazines are PyTorch ops here
    as they are jnp ops around the Pallas kernel in JAX.  Equal to
    `core.pool.pool_wavefront_step_mag`, every stat slot included."""
    K, dev = levels.shape[0], trees.device
    active = active.to(torch.bool)
    mcfg = pcfg.magazines
    if free_mag_lane is None:
        free_mag_lane = torch.full((free_nodes.shape[0],), -1, dtype=I32, device=dev)
    if alloc_mag_lane is None:
        alloc_mag_lane = torch.full((K,), -1, dtype=I32, device=dev)
    mags, fa, stashed, f_spills = pool_mod._mag_stash_phase(
        pcfg, trees, mags, free_nodes, free_shard, free_active, free_mag_lane,
        mag_rank=free_mag_rank, assume_owned=assume_owned_frees,
    )
    # the claim lands only in the pool wavefront's first round, so one
    # claim ahead of the launch equals the reference's per-round claim
    mags, mag_got, g_shard, g_node = pool_mod.pool_claim_mag(
        pcfg, mags, levels, active, alloc_mag_lane, alloc_mag_rank
    )
    trees, n1, s1, _, st1 = nbbs_alloc.pool_step(
        pcfg, trees, free_nodes, free_shard, fa, levels, active & ~mag_got,
        lane_ids, max_rounds,
    )
    nodes = torch.where(mag_got, g_node, n1)
    shard = torch.where(mag_got, g_shard, s1)

    failed = active & ~(nodes > 0)
    do_spill = failed.any() & (magmod.mag_total(mags) > 0)
    gids, live = magmod.mag_contents(mags)
    sp_shard, sp_node = pool_mod._gid_parts(pcfg, gids)
    retry = failed & do_spill
    trees, n2, s2, _, st2 = nbbs_alloc.pool_step(
        pcfg, trees, sp_node, sp_shard, live & do_spill, levels, retry,
        lane_ids, max_rounds,
    )
    n_spill = torch.where(do_spill, live.sum(dtype=I32), 0).to(I32)
    mags = magmod.mag_clear(mags, do_spill)
    nodes = torch.where(retry, n2, nodes)
    shard = torch.where(retry, s2, shard)
    ok = nodes > 0

    home = pool_mod.home_shard(pcfg, lane_ids)
    magh = mag_got.sum(dtype=I32)
    # the reference's first round runs whenever a lane is active, even if
    # the claim served every one of them
    first = (active.any() & (max_rounds > 0)).to(I32)
    fast_total = pool_mod._fast_total(pcfg, levels, active)
    if pcfg.fastpath is not None and fpmod.fp_level(pcfg.tree, pcfg.fastpath) == pcfg.tree.depth:
        fast_total = fast_total - magh  # magazine-served lanes never reached the slab
    hits = st1["fastpath_hits"] + st2["fastpath_hits"]
    stats = {
        "rounds": torch.maximum(st1["rounds"], first) + st2["rounds"],
        "merged_writes": st1["merged_writes"] + st2["merged_writes"]
        + st2["free_merged_writes"],
        "logical_rmws": st1["logical_rmws"] + st2["logical_rmws"]
        + st2["free_logical_rmws"],
        "overflows": (ok & ~mag_got & (shard != home)).sum(dtype=I32),
        "fastpath_hits": hits,
        "fastpath_spills": fast_total - hits,
        "magazine_hits": magh,
        "magazine_spills": f_spills + n_spill,
        "magazine_refills": torch.zeros((), dtype=I32, device=dev),
        "free_writes": st1["free_merged_writes"],
        "free_merged_writes": st1["free_merged_writes"],
        "free_logical_rmws": st1["free_logical_rmws"],
        "freed": st1["freed"] + stashed.sum(dtype=I32),
    }
    return trees, mags, nodes, shard, ok, pool_mod._check_slots(stats)
