"""Fixed-size fast path: a bitmap slab carved out of each buddy tree.

Counterpart of `repro/core/fastpath.py`; see that module for the
design.  In short: at `PoolConfig` init the leftmost node at
`slab_level` is committed as allocated in every shard's tree (through
the layout's own `commit_allocs`), and its blocks at the fast octave
`level` (the leaf level by default) are tracked by a bitmap of
`fp_state_words` words appended to the shard's state row.  A claim
ranks the wanting lanes in lane order and hands rank r the (r+1)-th
free slot in find-first-zero order; a release clears the bits of valid
handles (bit set, min-lane dedup).  Handles are ordinary node indices,
so frees route by node range.

The JAX package keeps the slab words as uint32.  Here they are int32
with the same bits (PyTorch has almost no CPU uint32 kernels), and
unlike the packed tree words they use all 32 bits: the arithmetic runs
in int64 on the low 32 bits (`_u32`) and comes back through `_i32`, so
bit 31 is set and cleared exactly as in JAX.

Every function takes a stack of slabs, one row per shard: `int32[S,
fp_state_words]`, with per-shard lane masks `[S, K]` and per-shard
counters `int32[S]`.  That is the batch axis the JAX package adds with
`jax.vmap`; the single-slab functions `slab_claim` / `slab_release`
are the S=1 case.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.concurrent import I32, INF, TreeConfig, _level_of

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FastPathConfig:
    """Static geometry of the fixed-size front end.

    `level` is the fast octave (None: the leaf level); the leftmost node
    at `slab_level` is reserved for the slab, a 1/2^slab_level fraction
    of each shard's capacity."""

    level: int | None = None
    slab_level: int = 2

    def validate(self, cfg: TreeConfig) -> None:
        lv = self.resolved_level(cfg)
        if not (1 <= self.slab_level <= lv <= cfg.depth):
            raise ValueError(
                "fastpath needs 1 <= slab_level <= level <= depth, got "
                f"slab_level={self.slab_level} level={lv} depth={cfg.depth}"
            )
        if self.slab_level < cfg.max_level:
            raise ValueError(
                "fastpath slab_level must be >= tree max_level "
                f"({self.slab_level} < {cfg.max_level})"
            )

    def resolved_level(self, cfg: TreeConfig) -> int:
        return cfg.depth if self.level is None else self.level


# ---------------------------------------------------------------------------
# Static geometry (Python ints)
# ---------------------------------------------------------------------------


def fp_level(cfg: TreeConfig, fp: FastPathConfig) -> int:
    return fp.resolved_level(cfg)


def fp_carve_node(fp: FastPathConfig) -> int:
    """The reserved subtree root: leftmost node at slab_level."""
    return 1 << fp.slab_level


def fp_n_slots(cfg: TreeConfig, fp: FastPathConfig) -> int:
    """Fast-octave blocks under the carve (slab bitmap width)."""
    return 1 << (fp_level(cfg, fp) - fp.slab_level)


def fp_node_base(cfg: TreeConfig, fp: FastPathConfig) -> int:
    """Node index of slab slot 0 (slots are nodes base..base+n_slots)."""
    return 1 << fp_level(cfg, fp)


def fp_units_per_slot(cfg: TreeConfig, fp: FastPathConfig) -> int:
    return 1 << (cfg.depth - fp_level(cfg, fp))


def fp_state_words(cfg: TreeConfig, fp: FastPathConfig) -> int:
    """Slab bitmap words appended to each shard's tree-state row."""
    return (fp_n_slots(cfg, fp) + 31) // 32


def carved_empty_tree(cfg: TreeConfig, fp: FastPathConfig, device="cuda") -> torch.Tensor:
    """Empty tree state with the slab's subtree committed as allocated
    by the layout's own merged commit."""
    win = torch.zeros((1, cfg.n_words), dtype=torch.bool, device=device)
    win[0, fp_carve_node(fp)] = True
    tree, _ = cfg.layout.commit_allocs(cfg, cfg.empty_tree(device)[None], win)
    return tree[0]


# ---------------------------------------------------------------------------
# Node-range routing masks (frees route by address range)
# ---------------------------------------------------------------------------


def in_slab_leaf(cfg: TreeConfig, fp: FastPathConfig, nodes: torch.Tensor) -> torch.Tensor:
    """bool: node is a slab slot (fast-octave block under the carve)."""
    base = fp_node_base(cfg, fp)
    return (nodes >= base) & (nodes < base + fp_n_slots(cfg, fp))


def in_carved_junk(cfg: TreeConfig, fp: FastPathConfig, nodes: torch.Tensor) -> torch.Tensor:
    """bool: node is inside or on the path to the carved subtree but is
    not a slab slot.  Neither allocator can have issued it, and a
    tree-side free of it could merge the carve away, so the pool drops
    it."""
    n = nodes.to(I32).clamp(1, cfg.n_words - 1)
    lev = _level_of(n, cfg.depth)
    carve = fp_carve_node(fp)
    shift = (lev - fp.slab_level).clamp(min=0)
    inside = (lev >= fp.slab_level) & ((n >> shift) == carve)
    on_path = (lev < fp.slab_level) & (n == (torch.ones_like(lev) << lev))
    in_range = (nodes >= 1) & (nodes < cfg.n_words)
    return in_range & (inside | on_path) & ~in_slab_leaf(cfg, fp, nodes)


# ---------------------------------------------------------------------------
# Slab bitmap claim / release (one merged RMW per burst), batched by shard
# ---------------------------------------------------------------------------


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int64 view of int32 words holding uint32 bits."""
    return words.to(torch.int64) & _U32


def _i32(u: torch.Tensor) -> torch.Tensor:
    """int32 words with the bits of uint32 values held in int64."""
    return (u - ((u >> 31) & 1) * (1 << 32)).to(I32)


def _slab_occ(cfg: TreeConfig, fp: FastPathConfig, slabs: torch.Tensor) -> torch.Tensor:
    """bool[S, n_slots]: slot occupied (bit set)."""
    idx = torch.arange(fp_n_slots(cfg, fp), device=slabs.device)
    return ((_u32(slabs)[:, idx >> 5] >> (idx & 31)) & 1) != 0


def _bits(sel: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """int64: the bit of each selected slot within its word, else 0."""
    one = torch.ones_like(slot, dtype=torch.int64)
    return torch.where(sel, one << (slot & 31).to(torch.int64), 0)


def slab_claims(cfg: TreeConfig, fp: FastPathConfig, slabs: torch.Tensor,
                want: torch.Tensor):
    """Claim one fast-octave block per wanting lane on every shard:
    lanes ranked in lane order, rank r takes the (r+1)-th free slot
    (`searchsorted` over the free prefix sums), the claimed bits OR in
    with one scatter.  Returns (slabs, nodes[S, K], got[S, K],
    merged_writes[S], hits[S])."""
    occ = _slab_occ(cfg, fp, slabs)
    free = ~occ
    cnt = free.sum(dim=1, dtype=I32)[:, None]
    rank = torch.cumsum(want.to(I32), dim=1, dtype=I32) - 1
    csum = torch.cumsum(free.to(I32), dim=1, dtype=I32)
    slot = torch.searchsorted(csum, (rank + 1).contiguous(), right=False).to(I32)
    sel = want & (rank < cnt)
    slot = torch.where(sel, slot, 0)
    u = _u32(slabs)
    new = u.scatter_add(1, (slot >> 5).long(), _bits(sel, slot))  # distinct: add == OR
    merged = (new != u).sum(dim=1, dtype=I32)
    nodes = torch.where(sel, fp_node_base(cfg, fp) + slot, 0).to(I32)
    return _i32(new), nodes, sel, merged, sel.sum(dim=1, dtype=I32)


def slab_releases(cfg: TreeConfig, fp: FastPathConfig, slabs: torch.Tensor,
                  nodes: torch.Tensor, active: torch.Tensor):
    """Release a burst of slab handles (`nodes[K]`, shared by every
    shard; `active[S, K]`): validity = in range and bit set, duplicates
    go to the minimum lane id, the cleared bits commit with one AND-NOT.
    Returns (slabs, freed[S, K], merged_writes[S], logical_rmws[S])."""
    S, K = active.shape
    base, n_slots = fp_node_base(cfg, fp), fp_n_slots(cfg, fp)
    nodes = nodes.to(I32)[None, :].expand(S, K)
    in_r = active & (nodes >= base) & (nodes < base + n_slots)
    slot = torch.where(in_r, nodes - base, 0).long()
    occ = _slab_occ(cfg, fp, slabs)
    valid = in_r & torch.gather(occ, 1, slot)
    ids = torch.arange(K, dtype=I32, device=slabs.device).expand(S, K)
    own = torch.full((S, n_slots), INF, dtype=I32, device=slabs.device)
    own.scatter_reduce_(1, slot, torch.where(valid, ids, INF), "amin", include_self=True)
    valid = valid & (torch.gather(own, 1, slot) == ids)
    u = _u32(slabs)
    mask = torch.zeros_like(u).scatter_add(1, slot >> 5, _bits(valid, slot))
    new = u & ~mask
    merged = (new != u).sum(dim=1, dtype=I32)
    return _i32(new), valid, merged, valid.sum(dim=1, dtype=I32)


def slab_claim(cfg: TreeConfig, fp: FastPathConfig, slab: torch.Tensor, want: torch.Tensor):
    """One slab: (slab, nodes, got, merged_writes, hits)."""
    s, n, g, m, h = slab_claims(cfg, fp, slab[None], want[None])
    return s[0], n[0], g[0], m[0], h[0]


def slab_release(cfg: TreeConfig, fp: FastPathConfig, slab: torch.Tensor,
                 nodes: torch.Tensor, active: torch.Tensor):
    """One slab: (slab, freed, merged_writes, logical_rmws)."""
    s, f, m, l = slab_releases(cfg, fp, slab[None], nodes, active[None])
    return s[0], f[0], m[0], l[0]


# ---------------------------------------------------------------------------
# Occupancy introspection
# ---------------------------------------------------------------------------


def slab_free_slots(cfg: TreeConfig, fp: FastPathConfig, slabs: torch.Tensor) -> torch.Tensor:
    """int32[S] (or a scalar for one slab): free fast-octave blocks."""
    one = slabs.dim() == 1
    n = (~_slab_occ(cfg, fp, slabs[None] if one else slabs)).sum(dim=1, dtype=I32)
    return n[0] if one else n


def slab_free_units(cfg: TreeConfig, fp: FastPathConfig, slabs: torch.Tensor) -> torch.Tensor:
    return slab_free_slots(cfg, fp, slabs) * fp_units_per_slot(cfg, fp)
