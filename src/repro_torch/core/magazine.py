"""Per-lane magazines: a recycling cache over the pool with zero
shared-state RMWs.

Counterpart of `repro/core/magazine.py`; see that module for the
design.  Each requester lane keeps a fixed-capacity LIFO of global leaf
page ids (`shard * 2^depth + offset`, -1 in empty slots) and a depth
counter.  A claim pops one page per wanting lane (lanes sharing a
magazine take distinct slots top-down in lane order), a stash pushes
one (bottom-up in lane order; ranks past capacity drop through to the
caller's ordinary release).  A magazine only holds pages the pool still
marks allocated, so a pop never hands out a page the trees can.

These are PyTorch ops on every device: as in the JAX package, where the
magazines live outside the Pallas kernel, no CUDA kernel runs them.
`group_rank` is the one op with a sort (`argsort(stable=True)`); callers
whose lane structure makes the rank trivial pass it and skip the sort.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class MagazineConfig:
    """Static magazine geometry: `mag_cap` pages per lane, and the pages
    one `pool_magazine_refill` burst pre-claims per selected lane."""

    mag_cap: int = 4
    refill_batch: int = 0

    def validate(self) -> None:
        if self.mag_cap < 1:
            raise ValueError(f"magazine mag_cap must be >= 1, got {self.mag_cap}")
        if self.refill_batch < 0:
            raise ValueError(
                f"magazine refill_batch must be >= 0, got {self.refill_batch}"
            )


class MagazineState(NamedTuple):
    """Per-lane magazine contents."""

    pages: torch.Tensor  # int32[n_lanes, mag_cap]; global page ids, -1 empty
    depth: torch.Tensor  # int32[n_lanes]; slots 0..depth-1 are live


def init_magazines(mcfg: MagazineConfig, n_lanes: int, device="cuda") -> MagazineState:
    """All-empty magazines for `n_lanes` requester lanes."""
    mcfg.validate()
    return MagazineState(
        pages=torch.full((n_lanes, mcfg.mag_cap), -1, dtype=I32, device=device),
        depth=torch.zeros(n_lanes, dtype=I32, device=device),
    )


def mag_total(mags: MagazineState) -> torch.Tensor:
    """int32 scalar: pages currently stashed across all magazines."""
    return mags.depth.sum(dtype=I32)


def mag_contents(mags: MagazineState):
    """Flattened view: (pages int32[L*C], live bool[L*C])."""
    L, C = mags.pages.shape
    slots = torch.arange(C, dtype=I32, device=mags.depth.device)
    live = slots[None, :] < mags.depth[:, None]
    return mags.pages.reshape(-1), live.reshape(-1)


def mag_clear(mags: MagazineState, enable: torch.Tensor) -> MagazineState:
    """Empty every magazine when `enable` (bool scalar) is set."""
    return MagazineState(
        pages=torch.where(enable, -1, mags.pages).to(I32),
        depth=torch.where(enable, 0, mags.depth).to(I32),
    )


def mag_free_per_shard(mags: MagazineState, n_shards: int, pages_per_shard: int):
    """int32[S]: stashed pages per owning shard."""
    pages, live = mag_contents(mags)
    sh = (pages.clamp(min=0) // pages_per_shard).clamp(0, n_shards - 1)
    out = torch.zeros(n_shards, dtype=I32, device=pages.device)
    return out.scatter_add(0, sh.long(), live.to(I32))


def group_rank(keys: torch.Tensor, cand: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Rank of each candidate among the candidates sharing its key, in
    lane order; 0 for non-candidates (a stable sort)."""
    K = keys.shape[0]
    key = torch.where(cand, keys.to(I32), n_groups).to(I32)
    order = torch.argsort(key, stable=True)
    skey = key[order].contiguous()
    first = torch.searchsorted(skey, skey, right=False).to(I32)
    rank_sorted = torch.arange(K, dtype=I32, device=keys.device) - first
    rank = torch.zeros(K, dtype=I32, device=keys.device).scatter(0, order, rank_sorted)
    return torch.where(cand, rank, 0)


def _lanes(mags, mag_lane, want, rank):
    """(cand, safe_lane, rank) of a claim or stash."""
    L = mags.pages.shape[0]
    lane = mag_lane.to(I32)
    cand = want & (lane >= 0) & (lane < L)
    safe_lane = torch.where(cand, lane, 0)
    if rank is None:
        rank = group_rank(safe_lane, cand, L)
    else:
        rank = torch.where(cand, rank.to(I32), 0)
    return cand, safe_lane, rank


def mag_claim(mcfg: MagazineConfig, mags: MagazineState, want: torch.Tensor,
              mag_lane: torch.Tensor, rank: torch.Tensor | None = None):
    """Pop one page per wanting lane from its own magazine.

    Lanes with `mag_lane` out of range never claim; claimants of one
    magazine take distinct slots top-down in lane order, and those
    ranked past its depth miss.  `rank`, when given, replaces the
    `group_rank` sort and must equal it (all zeros when every lane has
    its own magazine).  Returns (mags, pages int32[K] (-1 on a miss),
    got bool[K], hits)."""
    L, C = mags.pages.shape
    cand, safe_lane, rank = _lanes(mags, mag_lane, want, rank)
    depth_k = mags.depth[safe_lane.long()]
    got = cand & (rank < depth_k)
    slot = torch.where(got, depth_k - 1 - rank, 0)
    pages = torch.where(got, mags.pages[safe_lane.long(), slot.long()], -1).to(I32)
    flat = (safe_lane * C + slot).long()
    drop = torch.zeros(L * C, dtype=I32, device=pages.device).scatter_add(
        0, flat, got.to(I32)).reshape(L, C) > 0
    pops = torch.zeros(L, dtype=I32, device=pages.device).scatter_add(
        0, safe_lane.long(), got.to(I32))
    new = MagazineState(pages=torch.where(drop, -1, mags.pages).to(I32),
                        depth=mags.depth - pops)
    return new, pages, got, got.sum(dtype=I32)


def mag_stash(mcfg: MagazineConfig, mags: MagazineState, pages: torch.Tensor,
              want: torch.Tensor, mag_lane: torch.Tensor,
              rank: torch.Tensor | None = None):
    """Push one page per candidate lane into its own magazine: stashers
    of one magazine land bottom-up in lane order, ranks past capacity
    drop through (stashed=False).  `rank` as in `mag_claim` (dense per
    magazine, in lane order).  Returns (mags, stashed bool[K])."""
    L, C = mags.pages.shape
    cand, safe_lane, rank = _lanes(mags, mag_lane, want, rank)
    depth_k = mags.depth[safe_lane.long()]
    slot = depth_k + rank
    stashed = cand & (slot < C)
    slot = torch.where(stashed, slot, 0)
    flat = (safe_lane * C + slot).long()
    upd = torch.full((L * C,), -1, dtype=I32, device=pages.device).scatter_reduce(
        0, flat, torch.where(stashed, pages.to(I32), -1), "amax", include_self=True
    ).reshape(L, C)
    adds = torch.zeros(L, dtype=I32, device=pages.device).scatter_add(
        0, safe_lane.long(), stashed.to(I32))
    new = MagazineState(pages=torch.where(upd >= 0, upd, mags.pages).to(I32),
                        depth=mags.depth + adds)
    return new, stashed
