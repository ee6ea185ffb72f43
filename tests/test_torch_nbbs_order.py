"""A plain model of the order of work of the NBBS step kernel
(`src/repro_torch/csrc/nbbs_pool_step.cu`), held against the port's
rounds and the JAX package's.

`kernel_round` does one alloc round the way the CUDA body does it:

  1. the levels with a pending lane form a bitmask; the allocatable
     predicate runs only over the words of the first round's levels
     ("items", 32 nodes each: levels 0-4 of a shard share one), one bit
     per node, with an exclusive prefix of popcounts over the items.
     Later rounds keep the bits: each winner clears its own, its
     ancestors' and its subtree's bits at the levels still pending
     (`clear`), and `pool_alloc` checks them against a fresh evaluation
     after every round;
  2. each lane is ranked among the earlier pending lanes of its
     (shard, level) key by a count within its warp of lanes plus a
     per-warp, per-key count table scanned once over the warps; the
     r-th lane takes the r-th set bit of its segment (a binary search
     over the prefix, then a bit walk);
  3. a lane wins iff its id is below the owner of every targeted strict
     ancestor and of every targeted strict descendant of its target.
     The targets of a (shard, level) are the first `npend` allocatable
     nodes of its segment, owned in lane order, so the owner of rank r
     is below lane k iff r is below the count of that key's lanes before
     k (the table's prefix for k's warp plus k's lower peers): per other
     pending level, the rank of the ancestor in the bitmap, or of the
     first allocatable node under the target, against that count.

`pool_alloc` drives it with the layouts' commit and the pool's overflow
routing.  Both are held equal to `core.concurrent.alloc_rounds` of the
port and `alloc_round` of the JAX package on seeded trees, in both
layouts, with 1-8 pending levels, S > 1 with overflow and K up to 2048.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import concurrent as jconc
from repro.core import pool as jpool
from repro_torch.core import concurrent as tconc
from repro_torch.core import pool as tpool
from repro_torch.core.bits import OCC
from repro_torch.core.layout import _bunch_layers

_j_alloc_round = jax.jit(jconc.alloc_round, static_argnums=0)
_j_pool_alloc = jax.jit(jpool.pool_wavefront_alloc, static_argnums=(0, 4))

LAYOUTS = {"unpacked": (jconc.UNPACKED, tconc.UNPACKED),
           "packed": (jconc.BUNCH_PACKED, tconc.BUNCH_PACKED)}
WARP = 32


def _level(n):
    return int(n).bit_length() - 1


class Geometry:
    """A stack of S trees as the kernel sees it: node-index space per
    tree, the layout's words, and this round's items."""

    def __init__(self, cfg, S, words, lmask):
        self.cfg, self.S, self.depth = cfg, S, cfg.depth
        self.N = 1 << (cfg.depth + 1)
        self.T = S * self.N
        self.words = words                      # int64[S, TW]
        self.packed = isinstance(cfg.layout, tconc.BunchPacked)
        if self.packed:
            self.layer_of = {}
            for L, F, off in _bunch_layers(cfg.depth, cfg.layout.bunch_levels):
                for lev in range(L, F + 1):
                    self.layer_of[lev] = (L, F, off)
        self.lmask = lmask
        low = lmask & 31
        self.n_low = 0 if not low else (S if self.N >= 32 else (self.T + 31) // 32)
        self.NI = self.n_low + S * ((lmask & ~31) >> 5)

    # -- the layout's per-node views (one word read each) -------------
    def _slots(self, s, n, lev):
        L, F, off = self.layer_of[lev]
        r = n >> (lev - L)
        first = (n << (F - lev)) - (r << (F - L))
        w = int(self.words[s, off + r - (1 << L)])
        return [(w >> (5 * q)) & 31 for q in range(first, first + (1 << (F - lev)))]

    def node_occ(self, s, n, lev):
        if self.packed:
            return all(x & OCC for x in self._slots(s, n, lev))
        return bool(self.words[s, n] & OCC)

    def node_free(self, s, n, lev):
        if self.packed:
            return not any(self._slots(s, n, lev))
        return self.words[s, n] == 0

    def allocatable(self, s, n):
        lev = _level(n)
        if not self.node_free(s, n, lev):
            return False
        return not any(self.node_occ(s, n >> (lev - la), la) for la in range(lev))

    # -- items -----------------------------------------------------------
    def item_base(self, l):
        return self.n_low + self.S * ((self.lmask & ((1 << l) - 1) & ~31) >> 5)

    def pos(self, s, l, x):
        """(item, bit) of node x of level l on shard s, x in [2^l, 2^(l+1)]:
        the segment's end is bit 0 of the next item."""
        if l < 5:
            if self.N >= 32:
                return (s, x) if x < 32 else (s + 1, 0)
            g = s * self.N + x
            return g >> 5, g & 31
        o = x - (1 << l)
        return self.item_base(l) + s * (1 << (l - 5)) + (o >> 5), o & 31

    def node(self, s, l, j, b):
        if l < 5:
            return b if self.N >= 32 else 32 * j + b - s * self.N
        return (1 << l) + 32 * (j - self.item_base(l) - s * (1 << (l - 5))) + b

    def item_nodes(self, j):
        """The (shard, node) of each of item j's 32 bits (None: no node of
        a pending level)."""
        if j < self.n_low:
            g0 = j * self.N if self.N >= 32 else 32 * j
            out = []
            for b in range(WARP):
                g = g0 + b
                s, n = divmod(g, self.N)
                ok = g < self.T and n >= 1 and (self.lmask >> _level(n)) & 1
                out.append((s, n) if ok and n < 32 else None)
            return out
        for l in range(5, self.depth + 1):
            if not (self.lmask >> l) & 1:
                continue
            per = 1 << (l - 5)
            if j < self.item_base(l) + self.S * per:
                s, o = divmod(j - self.item_base(l), per)
                return [(s, (1 << l) + 32 * o + b) for b in range(WARP)]
        raise AssertionError(j)


def _nth_bit(m, r):
    for _ in range(r):
        m &= m - 1
    return (m & -m).bit_length() - 1


def evaluate(g):
    """The allocatable bits of every item of `g` on its words."""
    ab = np.zeros(g.NI, np.int64)
    for j in range(g.NI):
        for b, sn in enumerate(g.item_nodes(j)):
            if sn is not None and g.allocatable(*sn):
                ab[j] |= 1 << b
    return ab


def clear(g, ab, levels, s, l, t):
    """A committed winner t (level l, shard s), its ancestors and its
    descendants leave the allocatable bits at the levels still pending
    (`Items::clear`)."""
    for l2 in range(g.depth + 1):
        if not (levels >> l2) & 1:
            continue
        if l2 <= l:
            j, b = g.pos(s, l2, t >> (l - l2))
            ab[j] &= ~(1 << b)
            continue
        cnt = 1 << (l2 - l)
        j, b = g.pos(s, l2, t << (l2 - l))
        if cnt < 32:
            ab[j] &= ~(((1 << cnt) - 1) << b)
        else:
            ab[j : j + cnt // 32] = 0


def kernel_round(cfg, words, levels, pending, shard, bits=None):
    """One alloc round in the kernel's order of work.  `bits` is (the
    first round's Geometry, its allocatable bits after the clears of the
    rounds since); None evaluates them here.  Returns per lane (target,
    got, exhausted, won), the bits and this round's pending levels."""
    S, K = words.shape[0], len(levels)
    D1 = cfg.depth + 1
    nlw = (K + WARP - 1) // WARP
    valid = pending & (levels >= cfg.max_level) & (levels <= cfg.depth)
    key = np.where(valid, shard * D1 + levels, -1)
    lmask = 0
    for l in set(levels[valid].tolist()):
        lmask |= 1 << int(l)

    # 1. allocatable bits and their prefix over the items
    if bits is None:
        g = Geometry(cfg, S, words, lmask)
        bits = g, evaluate(g)
    g, ab = bits
    assert lmask & ~g.lmask == 0          # pending levels only shrink
    pre = np.zeros(g.NI + 1, np.int64)
    pre[1:] = np.cumsum([bin(int(x)).count("1") for x in ab])

    def rank_at(jb):
        j, b = jb
        return int(pre[j]) + (bin(int(ab[j]) & ((1 << b) - 1)).count("1") if b else 0)

    # 2. ranks: within the warp of lanes, then the count table
    kcnt = np.zeros((nlw + 1, S * D1), np.int64)
    kmask = np.zeros((nlw, S * D1), np.int64)
    wr = np.zeros(K, np.int64)
    for k in range(K):
        if key[k] < 0:
            continue
        w = k // WARP
        wr[k] = kcnt[w, key[k]]
        kcnt[w, key[k]] += 1
        kmask[w, key[k]] |= 1 << (k % WARP)
    for c in range(S * D1):
        run = 0
        for w in range(nlw):
            kcnt[w, c], run = run, run + kcnt[w, c]
        kcnt[nlw, c] = run

    target = np.zeros(K, np.int64)
    got = np.zeros(K, bool)
    exh = np.zeros(K, bool)
    won = np.zeros(K, bool)
    for k in range(K):
        if key[k] < 0:
            continue
        s, l, c = int(shard[k]), int(levels[k]), int(key[k])
        r = int(kcnt[k // WARP, c] + wr[k])
        start, end = g.pos(s, l, 1 << l), g.pos(s, l, 2 << l)
        rs = rank_at(start)
        acnt = rank_at(end) - rs
        if acnt == 0:
            exh[k] = True
            continue
        if r >= acnt:
            continue
        R = rs + r
        lo, hi = start[0], end[0] - (end[1] == 0)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if pre[mid] <= R else (lo, mid - 1)
        t = g.node(s, l, lo, _nth_bit(int(ab[lo]), R - int(pre[lo])))
        target[k], got[k] = t, True

        # 3. arbitration against the other pending levels of shard s: the
        # owner of rank r of key c2 is below k iff r is below the count of
        # c2's lanes before k (its warp's prefix and its lower peers)
        win = True
        w = k // WARP
        for l2 in range(cfg.depth + 1):
            if l2 == l or not (lmask >> l2) & 1:
                continue
            c2 = s * D1 + l2
            p0, p1 = int(kcnt[w, c2]), int(kcnt[w + 1, c2])
            before = p0 + (bin(int(kmask[w, c2]) & ((1 << (k % WARP)) - 1)).count("1")
                           if p1 > p0 else 0)
            base2 = rank_at(g.pos(s, l2, 1 << l2)) + before
            if l2 < l:
                ja, ba = g.pos(s, l2, t >> (l - l2))
                if (int(ab[ja]) >> ba) & 1 and rank_at((ja, ba)) < base2:
                    win = False
            else:
                r0 = rank_at(g.pos(s, l2, t << (l2 - l)))
                if r0 < base2 and rank_at(g.pos(s, l2, (t + 1) << (l2 - l))) > r0:
                    win = False
        won[k] = win
    return target, got, exh, won, bits, lmask


def pool_alloc(pcfg, trees, levels, active, lane_ids, max_rounds=64):
    """The pool's alloc loop with `kernel_round` in each round, the
    layout's commit, the winners' clears, and the overflow routing of
    `core/pool.py`; after each round the cleared bits must equal a fresh
    evaluation of the committed trees.  Returns (trees, nodes, shard,
    rounds, merged, logical, overflows)."""
    cfg, S = pcfg.tree, pcfg.n_shards
    K = len(levels)
    home = tpool.home_shard(pcfg, torch.from_numpy(lane_ids)).numpy().astype(np.int64)
    shard, att = home.copy(), np.zeros(K, np.int64)
    pending, nodes = active.copy(), np.zeros(K, np.int64)
    rounds = merged = logical = 0
    bits = None
    while rounds < max_rounds and pending.any():
        words = trees.numpy().astype(np.int64)
        target, got, exh, won, bits, lmask = kernel_round(cfg, words, levels, pending, shard,
                                                          bits)
        win_mask = torch.zeros((S, cfg.n_words), dtype=torch.bool)
        for k in np.flatnonzero(won):
            win_mask[shard[k], target[k]] = True
        trees, m = cfg.layout.commit_allocs(cfg, trees, win_mask)
        merged += int(m.sum())
        g, ab = bits
        for k in np.flatnonzero(won):
            clear(g, ab, lmask, shard[k], levels[k], target[k])
        fresh = evaluate(Geometry(cfg, S, trees.numpy().astype(np.int64), g.lmask))
        for l in range(cfg.depth + 1):                   # the levels still pending
            if (lmask >> l) & 1:
                for s in range(S):
                    (j0, b0), (j1, b1) = g.pos(s, l, 1 << l), g.pos(s, l, 2 << l)
                    for j in range(j0, j1 + (b1 > 0)):
                        lo = b0 if j == j0 else 0
                        hi = b1 if (j == j1 and b1) else 32
                        m = ((1 << hi) - 1) & ~((1 << lo) - 1)
                        assert (ab[j] & m) == (fresh[j] & m), (l, s, j)
        lv = torch.from_numpy(levels.astype(np.int32))
        for s in range(S):
            logical += int(cfg.layout.alloc_logical_rmws(
                cfg, torch.from_numpy(won & (shard == s))[None], lv[None]).sum())
        nodes = np.where(won, target, nodes)
        att = att + exh
        give_up = exh & (att >= S)
        shard = np.where(exh & ~give_up, (shard + 1) % S, shard)
        pending = pending & ~won & ~give_up
        rounds += 1
    overflows = int(((nodes > 0) & (shard != home)).sum())
    return trees, nodes, shard, rounds, merged, logical, overflows


def _state(tcfg, S, seed, fill):
    """A seeded stack: alloc bursts over mixed octaves, then a share of
    the winners freed, through the port's plain pool."""
    rng = np.random.default_rng(seed)
    pcfg = tpool.PoolConfig(tcfg, S)
    trees = pcfg.empty_trees("cpu")
    for _ in range(3):
        K = min(16, 1 << max(tcfg.depth - 2, 0))
        lv = rng.integers(max(tcfg.depth - 3, 0), tcfg.depth + 1, size=K).astype(np.int32)
        act = rng.random(K) < fill
        trees, nodes, shard, ok, _ = tpool.pool_wavefront_alloc(
            pcfg, trees, torch.from_numpy(lv), torch.from_numpy(act))
        drop = ok & torch.from_numpy(rng.random(K) < 0.4)
        trees, _, _, _ = tpool.pool_free_round(pcfg, trees, nodes, shard, drop)
    return trees


def _lanes(rng, depth, K, n_levels, max_level=0):
    """K lanes over n_levels distinct levels of [max_level, depth]."""
    pick = rng.choice(np.arange(max_level, depth + 1), size=n_levels, replace=False)
    levels = rng.choice(pick, size=K).astype(np.int32)
    levels[rng.random(K) < 0.03] = depth + 2            # never served
    return levels, rng.random(K) < 0.9


# (S, depth, K, pending levels, max_level): one depth per layout and
# shape keeps the JAX compiles few
CASES = [
    (1, 9, 64, 1, 0), (1, 9, 300, 3, 0), (1, 9, 2048, 8, 0), (2, 9, 512, 5, 1),
    (4, 3, 40, 4, 0), (3, 4, 96, 5, 0), (2, 6, 200, 6, 0),
]


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("S,depth,K,n_levels,max_level", CASES)
def test_round_matches_alloc_rounds_and_jax(layout, S, depth, K, n_levels, max_level):
    """One round on a seeded stack: the model's targets, exhaustion and
    winners equal the port's `alloc_rounds` and, shard by shard, the
    JAX `alloc_round`."""
    jl, tl = LAYOUTS[layout]
    tcfg = tconc.TreeConfig(depth=depth, max_level=max_level, layout=tl)
    jcfg = jconc.TreeConfig(depth=depth, max_level=max_level, layout=jl)
    rng = np.random.default_rng(K + depth)
    trees = _state(tcfg, S, K, fill=0.8)
    levels, act = _lanes(rng, depth, K, n_levels, max_level)
    shard = rng.integers(0, S, size=K)
    target, got, exh, won, _, _ = kernel_round(tcfg, trees.numpy().astype(np.int64),
                                               levels, act, shard)
    assert won.any()
    lane_mask = torch.from_numpy(shard[None, :] == np.arange(S)[:, None])
    pend = torch.from_numpy(act)[None, :] & lane_mask
    zeros = torch.zeros((S, K), dtype=torch.int32)
    _, nodes_s, pend_s, _, _, won_s = tconc.alloc_rounds(
        tcfg, trees, torch.from_numpy(levels), pend, zeros)
    assert np.array_equal(won_s.any(dim=0).numpy(), won)
    assert np.array_equal((nodes_s * won_s).sum(dim=0).numpy(), np.where(won, target, 0))
    gone = (pend & ~pend_s & ~won_s).any(dim=0).numpy()     # exhausted on its shard
    assert np.array_equal(gone, exh)
    for s in range(S):
        on = act & (shard == s)
        jr = _j_alloc_round(jcfg, jnp.asarray(trees[s].numpy().astype(np.uint32)
                                              if layout == "packed" else trees[s].numpy()),
                            jnp.asarray(levels), jnp.asarray(on),
                            jnp.zeros(K, jnp.int32))
        assert np.array_equal(np.asarray(jr[5]), won & on)
        assert np.array_equal(np.asarray(jr[1]), np.where(won & on, target, 0))
        assert np.array_equal(np.asarray(jr[2]), on & ~won & ~exh)


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("S,depth,K", [(4, 6, 96), (2, 8, 320), (3, 4, 48)])
def test_pool_alloc_with_overflow_matches_port_and_jax(layout, S, depth, K):
    """The pool's whole alloc loop with the model's rounds: nodes,
    shards, rounds, merged and logical counts and overflows equal the
    port's `pool_wavefront_alloc` and the JAX one, overflow included."""
    jl, tl = LAYOUTS[layout]
    tcfg = tconc.TreeConfig(depth=depth, layout=tl)
    pcfg = tpool.PoolConfig(tcfg, S)
    jpcfg = jpool.PoolConfig(jconc.TreeConfig(depth=depth, layout=jl), S)
    rng = np.random.default_rng(S * depth)
    trees = _state(tcfg, S, depth, fill=0.9)
    levels, act = _lanes(rng, depth, K, 2, max_level=depth - 1)
    ids = rng.integers(0, 2**31 - 1, size=8 * K).astype(np.int32)
    home = tpool.home_shard(pcfg, torch.from_numpy(ids)).numpy()
    crowd = ids[home == 0][: 3 * K // 4]                  # most lanes homed on shard 0
    ids = np.concatenate([crowd, ids[home != 0][: K - len(crowd)]])
    m = pool_alloc(pcfg, trees, levels, act, ids)
    assert m[6] > 0                                      # lanes overflowed
    t = tpool.pool_wavefront_alloc(pcfg, trees, torch.from_numpy(levels),
                                   torch.from_numpy(act), 64, torch.from_numpy(ids))
    assert torch.equal(m[0], t[0])
    assert np.array_equal(m[1], t[1].numpy()) and np.array_equal(m[2], t[2].numpy())
    assert (m[3], m[4], m[5], m[6]) == tuple(
        int(t[4][k]) for k in ("rounds", "merged_writes", "logical_rmws", "overflows"))
    jtrees = trees.numpy().astype(np.uint32) if layout == "packed" else trees.numpy()
    j = _j_pool_alloc(jpcfg, jnp.asarray(jtrees), jnp.asarray(levels), jnp.asarray(act),
                      64, jnp.asarray(ids))
    assert np.array_equal(np.asarray(j[0]).astype(np.int64), m[0].numpy().astype(np.int64))
    assert np.array_equal(np.asarray(j[1]), m[1]) and np.array_equal(np.asarray(j[2]), m[2])
    assert int(j[4]["overflows"]) == m[6] and int(j[4]["rounds"]) == m[3]


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("S,depth,K,n_levels", [(1, 9, 512, 6), (2, 7, 256, 8), (4, 3, 64, 4)])
def test_bits_kept_across_rounds_match_fresh_ones(layout, S, depth, K, n_levels):
    """Many levels pending over many rounds: after every round the bits
    the winners cleared equal a fresh evaluation (asserted inside
    `pool_alloc`), and the loop equals the port's pool."""
    tcfg = tconc.TreeConfig(depth=depth, layout=LAYOUTS[layout][1])
    pcfg = tpool.PoolConfig(tcfg, S)
    rng = np.random.default_rng(K + n_levels)
    trees = _state(tcfg, S, K, fill=0.7)
    levels, act = _lanes(rng, depth, K, n_levels)
    ids = rng.integers(0, 2**31 - 1, size=K).astype(np.int32)
    m = pool_alloc(pcfg, trees, levels, act, ids)
    assert m[3] > 2                                      # several rounds
    t = tpool.pool_wavefront_alloc(pcfg, trees, torch.from_numpy(levels),
                                   torch.from_numpy(act), 64, torch.from_numpy(ids))
    assert torch.equal(m[0], t[0])
    assert np.array_equal(m[1], t[1].numpy()) and np.array_equal(m[2], t[2].numpy())
    assert (m[3], m[4], m[5], m[6]) == tuple(
        int(t[4][k]) for k in ("rounds", "merged_writes", "logical_rmws", "overflows"))


def test_lane_ranks_use_the_warp_count_table():
    """With every lane on one key the ranks run 0..K-1 across warps;
    with keys interleaved each key's ranks follow lane order."""
    cfg = tconc.TreeConfig(depth=12)
    words = np.zeros((1, cfg.n_words), np.int64)
    K = 2048
    levels = np.full(K, 12, np.int32)
    target, got, exh, won, _, _ = kernel_round(cfg, words, levels, np.ones(K, bool),
                                               np.zeros(K, np.int64))
    assert got.all() and won.all() and not exh.any()
    assert np.array_equal(target, 4096 + np.arange(K))
    levels = np.where(np.arange(K) % 3 == 0, 12, 11).astype(np.int32)
    target, got, _, won, _, _ = kernel_round(cfg, words, levels, np.ones(K, bool),
                                             np.zeros(K, np.int64))
    leaf = np.flatnonzero(levels == 12)
    assert np.array_equal(target[leaf], 4096 + np.arange(len(leaf)))
    # level-11 lanes take 2048.. in order; a leaf under one loses to a lower id
    mid = np.flatnonzero(levels == 11)
    assert np.array_equal(target[mid], 2048 + np.arange(len(mid)))
    for k in leaf:
        owner = mid[target[k] // 2 - 2048] if target[k] // 2 - 2048 < len(mid) else K
        assert won[k] == (k < owner)
