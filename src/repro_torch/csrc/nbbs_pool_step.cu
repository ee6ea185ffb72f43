// NBBS wavefront steps in ONE launch: a merged release, then the alloc
// rounds, over a stack of S trees, in both tree layouts and in either
// shared or device memory.  Three entry points share one body:
//
//   nbbs_pool_step       kernel A; replaces `_pool_step_kernel`
//                        (repro/kernels/nbbs_alloc.py:249, entry
//                        `pool_wavefront_step_pallas` :366);
//   nbbs_wavefront_step  kernel 3; replaces `_wavefront_step_kernel`
//                        (repro/kernels/nbbs_alloc.py:133, entry
//                        `wavefront_step_pallas` :195): S=1, no lane
//                        hashing, no overflow;
//   nbbs_wavefront_alloc kernel 4; replaces `_wavefront_kernel`
//                        (repro/kernels/nbbs_alloc.py:86, entry
//                        `wavefront_alloc_pallas` :439): S=1, no release.
//
// Each computes exactly what its plain version computes (the lockstep
// router `pool_wavefront_step`, `wavefront_step`, `wavefront_alloc` of
// repro_torch/core), stat slots included: the Pallas dispatcher re-routes
// overflowed lanes between launches, kernel A re-routes them between
// rounds inside the launch, so it equals the router even on overflow.
// The stat row's slots are the prefix of POOL_STEP_SLOTS' order that the
// entry point fills: 3 (alloc), 6 (step) or 8 (pool, + overflows and
// fastpath hits).
//
// What bounds it on an H100.  A launch moves a few KB to a few hundred
// KB (the state words in and out, the lanes, the handles): 10^-5 to
// 10^-4 ms at 3.35 TB/s.  Its time is launch latency (an empty launch of
// this block shape takes about 0.005 ms behind a queue) plus chains of
// dependent shared-memory steps between block barriers: one 1024-thread
// block, because every round depends on the whole tree, and a round's
// time is set by its slowest lane.  So the design cuts the work of a
// round to what its pending lanes need, and the barriers:
//
//   1. Work only at pending levels, once.  The first round's levels
//      with a pending lane (a mask ORed in with the round's first
//      barrier) fix the "items": 32 nodes of one level (levels 0-4 of a
//      shard share one), one allocatable bit each from one ballot.  Only
//      those items are evaluated, in the first round only: a node's
//      ancestors at levels <= l-5 are common to its item (the warp's
//      lanes read one level each), each lane reads its own word and its
//      four nearest ancestors'.  Pending levels only shrink, so later
//      rounds keep the bits: each winner clears its own, its ancestors'
//      and its subtree's bits at the levels still pending (phase E; a
//      commit changes no other node's allocatability), and a round only
//      recounts popcounts.  Each warp runs over a contiguous run of items,
//      so their exclusive prefix costs one more barrier.
//   2. O(K) lane ranks.  Lanes are ranked among the earlier pending
//      lanes of their (shard, level) key by `__match_any_sync` within
//      each warp of 32 lanes, plus a count table [lane warp][key]
//      scanned once per key over the warps.  The r-th lane of a key
//      takes the r-th set bit of its segment: a binary search over the
//      prefix and a bit walk.  The slab claim ranks the same way, keyed
//      by shard.
//   3. Arbitration without per-node owner arrays or atomics.  The
//      targets of a (shard, level) are its first npend allocatable
//      nodes, owned in lane order, and the owner of rank r is below lane
//      k iff r is below the count of that key's lanes before k (the
//      count table's entry for k's lane warp plus k's lower peers in the
//      warp's key mask).  So per other pending level a lane reads the
//      rank of its ancestor (if that is allocatable) or of the first
//      allocatable node under it, and compares: a few independent reads,
//      no atomics, no search.  With one pending level (the engine)
//      nothing conflicts and nothing is read.
//   4. Per node only a flag byte (the release) and three bits
//      (allocatable, a prefix per 32, the commit's "first to reach"
//      mark), so every stack of up to 2^15 nodes (one depth-14 tree, S=2
//      at depth 13) runs from shared memory at K <= 256 in both layouts;
//      larger stacks run the same body from a device-memory workspace.
//   5. Targets, arbitration and commit share one phase: a round has four
//      block barriers (six with the slab) where it had about fifteen.
// The release reads its handles in register chunks of eight per thread.
// It keeps its full bottom-up sweep, one barrier per level unpacked, per
// layer packed: it must rebuild what the plain version rebuilds on any
// input tree, including words no handle touches.
//
// Layouts (template parameter PACKED, uniform over the block):
//   Unpacked     one int32 status word per node (state stride 2^(depth+1));
//   BunchPacked  paper §III-D: B=3 levels per word, four 5-bit leaf slots,
//                bottom-aligned layers stored top layer first
//                (repro/core/layout.py:241-491).  Only the words persist;
//                a node's any/occ derive from its leaf-slot range (OR of
//                its bits, AND of its OCC), and the commit ORs BUSY over
//                each winner's leaf range plus one OCC_LEFT/OCC_RIGHT
//                cross mark per bunch root it climbs through.
//                merged_writes counts packed words that changed, once per
//                word: the first atomicOr that changes a word sets its
//                mark bit.
//
// Fastpath slab (template parameter SLAB, set when SW > 0, so launches
// without a fastpath compile it out; kernel A only;
// repro/kernels/nbbs_alloc.py:281-290 and :310-318, core/fastpath.py):
// each shard's row is TW tree words followed by SW bitmap words over
// n_slots fast-octave blocks, the nodes 2^fp_level .. 2^fp_level +
// n_slots - 1 under the carve.  The release routes each handle by node
// range before the buddy release: a slab leaf clears its bit, a node
// inside or on the path to the carve is dropped, any other takes the
// merged release.  Every round starts with the slab claim: the lanes
// pending at fp_level are ranked in lane order within their current
// shard, and rank r takes the (r+1)-th free slot in find-first-zero
// order (`searchsorted(csum, rank + 1)`).  Lanes past the shard's free
// count fall through to the same round's buddy round.  merged_writes
// counts slab words changed, logical_rmws and fastpath_hits one per claim.
//
// The release (free_round, concurrent.py:402-457) runs once before the
// rounds: validity against the (derived) OCC, the slab's against its
// words before the release; duplicate handles of one node keep the
// lowest handle index (a mark bit per node finds the nodes with
// duplicates; only their handles narrow bit by bit of the index, two
// barriers per bit); free_logical_rmws against the pre-round state; then
// apply_frees as one bottom-up sweep (the packed sweep rebuilds every
// word canonically).
//
// Memory tiers (template parameter SHARED).  The state words and scratch
// take `workspace_bytes` (kernels/nbbs_alloc.py; `sizes_of` below).
// When that fits one block's 227 KB they live in dynamic shared memory;
// otherwise the wrapper passes a device-memory workspace and the same
// body runs from it (one block, so __syncthreads() still orders the
// phases).  The tier is a template parameter, not a runtime pointer
// choice, so that the shared tier compiles to shared-memory loads,
// stores and atomics rather than generic ones.  The lanes (at most two
// per thread) live in registers.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int OCC_RIGHT = 0x1;
constexpr int OCC_LEFT = 0x2;
constexpr int COAL_RIGHT = 0x4;
constexpr int COAL_LEFT = 0x8;
constexpr int OCC = 0x10;
constexpr int BUSY = OCC | OCC_LEFT | OCC_RIGHT;
constexpr uint32_t FIB_HASH = 2654435761u;
constexpr int THREADS = 1024;
constexpr int NWARPS = THREADS / 32;
constexpr int MAXL = 2;  // lanes per thread: K <= MAXL * THREADS
constexpr int MAX_LEVELS = 32;
constexpr unsigned FULL = 0xffffffffu;

// stat slots, in the order of obs/schema.py's POOL_STEP_SLOTS prefix
enum {
  ST_ROUNDS, ST_MERGED, ST_LOGICAL, ST_FREE_MERGED, ST_FREE_LOGICAL,
  ST_FREED, ST_OVERFLOWS, ST_FP_HITS, N_STATS
};

// per-node flag bits (the release)
constexpr unsigned F_TOUCH = 1;   // freed / release climb passes through
constexpr unsigned F_SUBOCC = 2;  // sub-tree (packed: bunch) still reserved
constexpr unsigned F_SEEN = 4;    // a candidate handle names this node
constexpr unsigned F_DUP = 8;     // ... and so does another
constexpr unsigned F_Z0 = 16;     // duplicate narrowing, even bits
constexpr unsigned F_Z1 = 32;     // ... odd bits
constexpr unsigned F_PAST = 64;   // a handle of an earlier chunk took this node
constexpr int FPT = 8;            // release handles per thread per chunk

struct Args {
  const int* trees_in;
  int* trees_out;
  int S, depth, max_level, W;  // W: state words per row (TW + SW)
  int TW, SW;                  // tree words, slab words (0: no fastpath)
  int fp_level, slab_level, n_slots;
  const int* free_nodes;
  const int* free_shard;       // null: every handle on shard 0
  const int* free_active;
  int F;
  const int* levels;
  const int* active;
  const int* lane_ids;         // null: every lane homed on shard 0
  int K, max_rounds;
  int* nodes_out;
  int* shard_out;              // may be null
  int* freed_out;              // per handle; also its scratch in the release
  int* stats_out;
  int n_stats;
  int release;                 // 0: no release phase at all (kernel 4)
  unsigned char* workspace;    // device-memory tier only
};

// Byte offsets of the workspace regions; kernels/nbbs_alloc.py's
// `workspace_bytes` repeats this count.
struct Sizes {
  int T, NW, NWD, nlw, NK;
  size_t flags, ints, total;  // offsets of the flag bytes and the int32 arrays; size
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

__host__ __device__ inline Sizes sizes_of(int S, int depth, int TW, int SW, int K) {
  Sizes z;
  z.T = S << (depth + 1);
  z.NW = S * SW;
  z.NWD = (z.T + 31) >> 5;
  z.nlw = (K + 31) >> 5;
  z.NK = S * (depth + 1);
  // state, slab, slab before a phase, free-slot prefix (+1)
  z.flags = align16(4 * (size_t)(S * TW + 3 * z.NW + 1));
  z.ints = z.flags + align16((size_t)z.T);
  const size_t ints = 3 * (size_t)z.NWD + 1                        // ab, pre (+1), mk
                      + (size_t)(z.nlw + 1) * z.NK                 // kcnt (+ totals)
                      + (size_t)z.nlw * z.NK                       // kmask
                      + (SW > 0 ? (size_t)(z.nlw + 1) * S : 0);    // slab ranks
  z.total = z.ints + 4 * ints;
  return z;
}

// Bunch layering of one depth, as repro/core/layout.py::_bunch_layers.
struct Layers {
  int n;                                             // layer count
  int root[MAX_LEVELS], leaf[MAX_LEVELS], off[MAX_LEVELS];  // by layer, top first
  int lroot[MAX_LEVELS], lleaf[MAX_LEVELS], loff[MAX_LEVELS];  // by tree level
  int crosses[MAX_LEVELS];  // bunch-root levels in (max_level, level]
};

__device__ void build_layers(Layers& ly, int depth, int max_level) {
  int roots[MAX_LEVELS], leaves[MAX_LEVELS], n = 0;
  for (int leaf = depth; leaf >= 0;) {  // bottom-up
    const int root = leaf - 2 > 0 ? leaf - 2 : 0;
    roots[n] = root;
    leaves[n++] = leaf;
    leaf = root - 1;
  }
  int off = 0;
  ly.n = n;
  for (int j = 0; j < n; ++j) {  // top-first
    const int root = roots[n - 1 - j], leaf = leaves[n - 1 - j];
    ly.root[j] = root;
    ly.leaf[j] = leaf;
    ly.off[j] = off;
    for (int lev = root; lev <= leaf; ++lev) {
      ly.lroot[lev] = root;
      ly.lleaf[lev] = leaf;
      ly.loff[lev] = off;
    }
    off += 1 << root;
  }
  for (int lev = 0; lev <= depth; ++lev) {
    int c = 0;
    for (int j = 0; j < n; ++j) c += ly.root[j] > max_level && ly.root[j] <= lev;
    ly.crosses[lev] = c;
  }
}

__device__ __forceinline__ int level_of(int n) { return 31 - __clz(n); }

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The position of the r-th set bit of m (r < popc(m)): five halvings.
__device__ __forceinline__ int nth_bit(uint32_t m, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const uint32_t lo = m & ((1u << w) - 1u);
    const int c = __popc(lo);
    if (r >= c) {
      r -= c;
      m >>= w;
      pos += w;
    } else {
      m = lo;
    }
  }
  return pos;
}

// Fastpath routing by node range (core/fastpath.py in_slab_leaf,
// in_carved_junk).
__device__ __forceinline__ bool in_slab(const Args& a, int n) {
  const int base = 1 << a.fp_level;
  return n >= base && n < base + a.n_slots;
}

__device__ __forceinline__ bool in_junk(const Args& a, int n, int N) {
  if (n < 1 || n >= N || in_slab(a, n)) return false;
  const int lev = level_of(n), sl = a.slab_level;
  return lev >= sl ? (n >> (lev - sl)) == (1 << sl) : n == (1 << lev);
}

// The bits of slab word w (within its shard) that are real slots.
__device__ __forceinline__ uint32_t slot_mask(int w, int n_slots) {
  const int rem = n_slots - 32 * w;
  return rem >= 32 ? 0xffffffffu : (1u << rem) - 1u;
}

__device__ __forceinline__ int home_of(const int* lane_ids, int k, int S) {
  return lane_ids ? (int)(((uint32_t)lane_ids[k] * FIB_HASH) % (uint32_t)S) : 0;
}

// Packed: the word index of node n (level lev) within its tree, and its
// leaf-slot range [first, first + cnt).
__device__ __forceinline__ int packed_word(const Layers& ly, int n, int lev,
                                           int& first, int& cnt) {
  const int L = ly.lroot[lev], Fl = ly.lleaf[lev];
  const int r = n >> (lev - L);
  first = (n << (Fl - lev)) - (r << (Fl - L));
  cnt = 1 << (Fl - lev);
  return ly.loff[lev] + r - (1 << L);
}

// Derived (any, occ, busy) of node n from its tree's packed words.
__device__ __forceinline__ void packed_derive(const int* words, const Layers& ly,
                                              int n, bool& any, bool& occ,
                                              bool& busy) {
  int first, cnt;
  const uint32_t w = (uint32_t)words[packed_word(ly, n, level_of(n), first, cnt)];
  any = false;
  occ = true;
  busy = false;
  for (int q = first; q < first + cnt; ++q) {
    const int s = (w >> (5 * q)) & 31;
    any |= s != 0;
    occ &= (s & OCC) != 0;
    busy |= (s & BUSY) != 0;
  }
}

// (Derived) OCC of node n at level lev: the word's OCC bit, or every
// leaf slot of the range OCC.
template <bool PACKED>
__device__ __forceinline__ bool node_occ(const int* words, const Layers& ly, int n, int lev) {
  if (!PACKED) return words[n] & OCC;
  int first, cnt;
  const uint32_t w = (uint32_t)words[packed_word(ly, n, lev, first, cnt)];
  const uint32_t rep = cnt == 1 ? 0x10u : cnt == 2 ? 0x210u : 0x84210u;  // OCC per slot
  const uint32_t m = rep << (5 * first);
  return (w & m) == m;
}

// A node's word (range) is bit-free: CAS(0 -> BUSY) could take it.
template <bool PACKED>
__device__ __forceinline__ bool node_free(const int* words, const Layers& ly, int n, int lev) {
  if (!PACKED) return words[n] == 0;
  int first, cnt;
  const uint32_t w = (uint32_t)words[packed_word(ly, n, lev, first, cnt)];
  return ((w >> (5 * first)) & ((1u << (5 * cnt)) - 1u)) == 0;
}

// OR `mask` into a packed word; 1 if this call is the first to change it
// (its bit in `mk`, indexed by the word's place in the stack, marks it).
__device__ __forceinline__ int or_word(int* state, uint32_t* mk, int w, int mask) {
  const int old = atomicOr(&state[w], mask);
  if ((old | mask) == old) return 0;
  const uint32_t b = 1u << (w & 31);
  return (atomicOr(&mk[w >> 5], b) & b) ? 0 : 1;
}

// The flag byte of node i as a bit field of its 32-bit word.
__device__ __forceinline__ unsigned* flag_word(uint8_t* flags, int i) {
  return reinterpret_cast<unsigned*>(flags + (i & ~3));
}

__device__ __forceinline__ int flag_shift(int i) { return 8 * (i & 3); }

// Inclusive warp prefix sum.
__device__ __forceinline__ int warp_incl(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Copy n words; 16 bytes at a time when both ends allow it.
__device__ void copy_words(int* dst, const int* src, int n) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int j = threadIdx.x; j < n4; j += blockDim.x)
      reinterpret_cast<int4*>(dst)[j] = reinterpret_cast<const int4*>(src)[j];
    for (int j = 4 * n4 + threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j];
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j];
  }
}

// This round's items: 32 nodes each, over the levels in L (levels 0-4 of
// a shard share one item; with fewer than 32 nodes per tree an item is
// 32 nodes of the stack).  Items of level l >= 5 run shard by shard.
struct Items {
  int S, N, T, n_low;
  unsigned L;

  __device__ int base(int l) const {
    return n_low + S * (int)((L & ((1u << l) - 1u) & ~31u) >> 5);
  }

  // (item, bit) of node x of level l on shard s, x in [2^l, 2^(l+1)]:
  // the segment's end is bit 0 of the next item.
  __device__ void pos(int s, int l, int x, int& j, int& b) const {
    if (l < 5) {
      if (N >= 32) {
        j = x < 32 ? s : s + 1;
        b = x < 32 ? x : 0;
      } else {
        const int g = s * N + x;
        j = g >> 5;
        b = g & 31;
      }
    } else {
      const int o = x - (1 << l);
      j = base(l) + (s << (l - 5)) + (o >> 5);
      b = o & 31;
    }
  }

  // The node of bit b of item j in segment (s, l).
  __device__ int node(int s, int l, int j, int b) const {
    if (l < 5) return N >= 32 ? b : 32 * j + b - s * N;
    return (1 << l) + 32 * (j - base(l) - (s << (l - 5))) + b;
  }

  // The level, shard and word offset of level item j >= n_low.
  __device__ void locate(int j, int& l, int& s, int& o) const {
    int jj = j - n_low;
    l = 5;
    for (unsigned m = L >> 5;; m >>= 1, ++l) {
      if (!(m & 1)) continue;
      const int cnt = S << (l - 5);
      if (jj < cnt) break;
      jj -= cnt;
    }
    s = jj >> (l - 5);
    o = jj & ((1 << (l - 5)) - 1);
  }

  // A committed winner t (level l, shard s) and every ancestor and
  // descendant of it stop being allocatable: clear their bits at the
  // levels in `levels` (those still pending: the others are never read
  // again).  Bits already clear are left alone, so the winners under one
  // ancestor do not queue on its word.
  __device__ void clear(uint32_t* ab, unsigned levels, int s, int l, int t) const {
    for (unsigned m = levels; m; m &= m - 1) {
      const int l2 = __ffs(m) - 1;
      int j, b;
      if (l2 <= l) {
        pos(s, l2, t >> (l - l2), j, b);
        if ((ab[j] >> b) & 1) atomicAnd(&ab[j], ~(1u << b));
        continue;
      }
      const int cnt = 1 << (l2 - l);  // the range under t, from bit b of item j
      pos(s, l2, t << (l2 - l), j, b);
      if (cnt < 32) {
        const uint32_t mask = ((1u << cnt) - 1u) << b;
        if (ab[j] & mask) atomicAnd(&ab[j], ~mask);
      } else {
        for (int q = 0; q < cnt >> 5; ++q) ab[j + q] = 0;
      }
    }
  }
};

// Allocatable bits of low item j (levels 0-4), one per lane's node
// (warp-collective): the node's word is bit-free and no strict ancestor
// is (derived) OCC.
template <bool PACKED>
__device__ uint32_t eval_low(const Items& it, int j, const int* state, int TW, int depth,
                             const Layers& ly) {
  const int lane = threadIdx.x & 31;
  const int g = (it.N >= 32 ? j * it.N : 32 * j) + lane;
  bool ok = false;
  if (g < it.T) {
    const int s = g >> (depth + 1), n = g & (it.N - 1);
    if (n >= 1 && n < 32 && ((it.L >> level_of(n)) & 1)) {
      const int* words = state + s * TW;
      const int lev = level_of(n);
      ok = node_free<PACKED>(words, ly, n, lev);
      for (int la = lev - 1; ok && la >= 0; --la)
        if (node_occ<PACKED>(words, ly, n >> (lev - la), la)) ok = false;
    }
  }
  return __ballot_sync(FULL, ok);
}

// The same for the 32 nodes n0 .. n0+31 of level l >= 5 in one tree's
// words: their ancestors at levels 0 .. l-5 are common (one level per
// lane, one vote), each lane reads its own word and its four nearest
// ancestors' (independent loads).
template <bool PACKED>
__device__ uint32_t eval_level(const int* words, int l, int n0, const Layers& ly) {
  const int lane = threadIdx.x & 31, n = n0 + lane;
  const bool c = lane <= l - 5 && node_occ<PACKED>(words, ly, n0 >> (l - lane), lane);
  if (__any_sync(FULL, c)) return 0;
  const bool anc = node_occ<PACKED>(words, ly, n >> 1, l - 1) |
                   node_occ<PACKED>(words, ly, n >> 2, l - 2) |
                   node_occ<PACKED>(words, ly, n >> 3, l - 3) |
                   node_occ<PACKED>(words, ly, n >> 4, l - 4);
  return __ballot_sync(FULL, !anc && node_free<PACKED>(words, ly, n, l));
}

__device__ __forceinline__ int rank_at(const int* pre, const uint32_t* ab, int j, int b) {
  return pre[j] + (b ? __popc(ab[j] & ((1u << b) - 1u)) : 0);
}

template <bool PACKED, bool SHARED, bool SLAB>
__global__ void __launch_bounds__(THREADS, 1) nbbs_step_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int st[N_STATS];
  __shared__ int wsum[NWARPS];   // popcount of each warp's items
  __shared__ int swsum[NWARPS];  // free slab slots of each warp's words
  __shared__ unsigned lm[2];     // levels with a pending lane, by round parity
  __shared__ Layers ly;

  const int S = a.S, depth = a.depth, max_level = a.max_level, W = a.W;
  const int TW = a.TW, SW = SLAB ? a.SW : 0;
  const int K = a.K, F = a.F;
  const int N = 1 << (depth + 1), D1 = depth + 1;
  const Sizes z = sizes_of(S, depth, TW, SW, K);
  const int T = z.T, NW = z.NW, nlw = z.nlw, NK = z.NK;
  unsigned char* ws = SHARED ? smem_raw : a.workspace;
  int* state = reinterpret_cast<int*>(ws);  // [S*TW] persistent tree words
  int* slab = state + S * TW;  // [NW] persistent slab words
  int* sold = slab + NW;       // [NW] slab words before a phase
  int* spc = sold + NW;        // [NW+1] exclusive prefix of free slots
  uint8_t* flags = ws + z.flags;                              // [T] release flags
  uint32_t* ab = reinterpret_cast<uint32_t*>(ws + z.ints);    // [NWD] allocatable bits
  int* pre = reinterpret_cast<int*>(ab + z.NWD);              // [NWD+1] their prefix
  uint32_t* mk = reinterpret_cast<uint32_t*>(pre + z.NWD + 1);  // [NWD] commit marks
  int* kcnt = reinterpret_cast<int*>(mk + z.NWD);             // [nlw+1][NK] key counts
  uint32_t* kmask = reinterpret_cast<uint32_t*>(kcnt + (nlw + 1) * NK);  // [nlw][NK]
  int* skc = reinterpret_cast<int*>(kmask + nlw * NK);        // [nlw+1][S] slab ranks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (PACKED && tid == 0) build_layers(ly, depth, max_level);
  for (int s = 0; s < S; ++s) {  // row s: TW tree words, then SW slab words
    copy_words(state + s * TW, a.trees_in + s * W, TW);
    for (int j = tid; j < SW; j += THREADS)  // sold: the release's merged count
      slab[s * SW + j] = sold[s * SW + j] = a.trees_in[s * W + TW + j];
  }
  // without handles an unpacked release changes nothing; a packed one
  // still rebuilds every word canonically, as apply_frees does
  const bool release = a.release && (PACKED || F > 0);
  if (release)
    for (int j = tid; j < (int)(align16(T) >> 4); j += THREADS)
      reinterpret_cast<int4*>(flags)[j] = make_int4(0, 0, 0, 0);
  if (tid < N_STATS) st[tid] = 0;
  if (tid < 2) lm[tid] = 0;
  // the lanes, in registers: lane tid + j * THREADS
  int lv[MAXL], sh[MAXL], att[MAXL], nd[MAXL], wr[MAXL];
  bool pend[MAXL];
#pragma unroll
  for (int j = 0; j < MAXL; ++j) {
    const int k = tid + j * THREADS;
    const bool in = k < K;
    lv[j] = in ? a.levels[k] : -1;
    sh[j] = in ? home_of(a.lane_ids, k, S) : 0;
    att[j] = nd[j] = wr[j] = 0;
    pend[j] = in && a.active[k];
  }
  __syncthreads();

  // ---------------- merged release (free_round on every shard) -------
  if (release) {
    // Handles go in chunks of FPT per thread, held in registers (one
    // chunk up to 8192 handles); a node's lowest candidate handle wins.
    int freed_local = 0, flog_local = 0, sfreed_local = 0;
    const int fchunks = (F + FPT * THREADS - 1) / (FPT * THREADS);
    for (int c = 0; c < fchunks; ++c) {
      const int c0 = c * FPT * THREADS;
      int hs[FPT], hn[FPT];
      unsigned live = 0;  // bit q: handle q is a candidate (later: its node's lowest)
#pragma unroll
      for (int q = 0; q < FPT; ++q) {
        const int f = c0 + q * THREADS + tid;
        const bool in = f < F;
        hs[q] = in && a.free_shard ? a.free_shard[f] : 0;
        hn[q] = in ? a.free_nodes[f] : 0;
        if (in && a.free_active[f]) live |= 1u << q;
      }
      // 1. candidates: in range, (derived) OCC, not carved junk; a node
      // named by two candidates is marked F_DUP
      bool dup = false;
#pragma unroll
      for (int q = 0; q < FPT; ++q) {
        if (!((live >> q) & 1)) continue;
        const int s = hs[q], n = hn[q];
        bool cand = s >= 0 && s < S && n > 0 && n < N;
        if (cand) {
          if (SLAB && in_slab(a, n)) {  // against the slab before the release
            const int slot = n - (1 << a.fp_level);
            cand = ((uint32_t)sold[s * SW + (slot >> 5)] >> (slot & 31)) & 1u;
          } else if (SLAB && in_junk(a, n, N)) {
            cand = false;
          } else {
            cand = node_occ<PACKED>(state + s * TW, ly, n, level_of(n));
          }
        }
        if (cand) {
          const int i = s * N + n, sft = flag_shift(i);
          const unsigned old = atomicOr(flag_word(flags, i), F_SEEN << sft) >> sft;
          if (old & F_PAST) {
            cand = false;  // a handle of an earlier chunk is lower
          } else if (old & F_SEEN) {
            atomicOr(flag_word(flags, i), F_DUP << sft);
            dup = true;
          }
        }
        if (!cand) live &= ~(1u << q);
      }
      // 2. where a node has two, its lowest handle, bit by bit of the index
      if (__syncthreads_or(dup)) {
        for (int b = 31 - __clz(min(F - c0, FPT * THREADS) - 1); b >= 0; --b) {
          const unsigned zb = (b & 1) ? F_Z1 : F_Z0, zo = (F_Z0 | F_Z1) ^ zb;
#pragma unroll
          for (int q = 0; q < FPT; ++q) {
            const int i = hs[q] * N + hn[q], sft = flag_shift(i);
            if (!((live >> q) & 1) || !(flags[i] & F_DUP)) continue;
            atomicAnd(flag_word(flags, i), ~(zo << sft));  // the previous bit's mark
            if (!(((q * THREADS + tid) >> b) & 1)) atomicOr(flag_word(flags, i), zb << sft);
          }
          __syncthreads();
#pragma unroll
          for (int q = 0; q < FPT; ++q) {
            const int i = hs[q] * N + hn[q];
            if (((live >> q) & 1) && (((q * THREADS + tid) >> b) & 1) &&
                (flags[i] & F_DUP) && (flags[i] & zb))
              live &= ~(1u << q);
          }
          __syncthreads();
        }
      }
      // 3. apply: slab bits, run-alone climbs, touch marks
#pragma unroll
      for (int q = 0; q < FPT; ++q) {
        const int f = c0 + q * THREADS + tid;
        if (f < F) a.freed_out[f] = (live >> q) & 1;
        if (!((live >> q) & 1)) continue;
        const int s = hs[q], n = hn[q], i = s * N + n, sft = flag_shift(i);
        if (fchunks > 1) atomicOr(flag_word(flags, i), F_PAST << sft);
        if (SLAB && in_slab(a, n)) {  // one AND-NOT per handle; duplicates were dropped
          const int slot = n - (1 << a.fp_level);
          atomicAnd(&slab[s * SW + (slot >> 5)], ~(int)(1u << (slot & 31)));
          ++sfreed_local;
          continue;
        }
        const int* words = state + s * TW;
        // run-alone FREENODE climb against the pre-round state
        int cur = n, lev = level_of(n), climb = 0;
        while (lev > max_level) {
          if (PACKED) {
            if (ly.lroot[lev] == lev) ++climb;  // crosses a bunch root
            bool any, occ, busy;
            packed_derive(words, ly, cur ^ 1, any, occ, busy);
            if (busy) break;
          } else {
            ++climb;
            const int buddy = (cur & 1) ? OCC_LEFT : OCC_RIGHT;
            if (words[cur >> 1] & buddy) break;
          }
          cur >>= 1;
          --lev;
        }
        flog_local += 2 * climb + 1;
        ++freed_local;
        atomicOr(flag_word(flags, i), F_TOUCH << sft);
      }
      if (c + 1 < fchunks) __syncthreads();  // F_PAST lands before the next chunk
    }
    int fmerged_local = 0;
    if (PACKED) {
      __syncthreads();
      // canonical rebuild, one layer per barrier, deepest layer first
      for (int j = ly.n - 1; j >= 0; --j) {
        const int L = ly.root[j], Fl = ly.leaf[j], off = ly.off[j];
        const int nroots = 1 << L, nslots = 1 << (Fl - L);
        for (int x = tid; x < S * nroots; x += THREADS) {
          const int s = x >> L, r = nroots + (x & (nroots - 1));
          const int nb = s * N, w = s * TW + off + r - nroots;
          const uint32_t old = (uint32_t)state[w];
          uint32_t nw = 0;
          bool bocc = false;
          for (int q = 0; q < nslots; ++q) {
            const int node = (r << (Fl - L)) + q;
            bool fl = false;  // freed at-or-above the slot, inside the bunch
            for (int p = node, lev = Fl; lev >= L && !fl; p >>= 1, --lev)
              fl = flags[nb + p] & F_TOUCH;
            const bool in_occ = ((old >> (5 * q)) & OCC) && !fl;
            const bool bl = Fl < depth && (flags[nb + 2 * node] & F_SUBOCC);
            const bool br = Fl < depth && (flags[nb + 2 * node + 1] & F_SUBOCC);
            nw |= (uint32_t)((in_occ ? BUSY : 0) | (bl ? OCC_LEFT : 0) |
                             (br ? OCC_RIGHT : 0)) << (5 * q);
            bocc |= in_occ || bl || br;
          }
          if (nw != old) {
            state[w] = (int)nw;
            ++fmerged_local;
          }
          flags[nb + r] = (flags[nb + r] & ~F_SUBOCC) | (bocc ? F_SUBOCC : 0);
        }
        __syncthreads();
      }
    } else if (__syncthreads_or(freed_local)) {  // no tree handle: nothing changes
      fmerged_local = freed_local;
      for (int i = tid; i < T; i += THREADS) {
        uint8_t fl = flags[i];
        int t = state[i];
        if (fl & F_TOUCH) { t = 0; state[i] = 0; }
        if (t & OCC) fl |= F_SUBOCC;
        flags[i] = fl;
      }
      __syncthreads();
      for (int lev = depth - 1; lev >= max_level; --lev) {
        const int Wl = 1 << lev;
        for (int j = tid; j < S * Wl; j += THREADS) {
          const int base = (j >> lev) * N;
          const int p = Wl + (j & (Wl - 1));
          const uint8_t c0 = flags[base + 2 * p], c1 = flags[base + 2 * p + 1];
          const bool any_tch = (c0 | c1) & F_TOUCH;
          const int pv = state[base + p];
          const bool own_occ = pv & OCC;
          const int derived = ((c0 & F_SUBOCC) ? OCC_LEFT : 0) |
                              ((c1 & F_SUBOCC) ? OCC_RIGHT : 0);
          const int nv = (any_tch && !own_occ) ? derived : pv;
          if (nv != pv) { state[base + p] = nv; ++fmerged_local; }
          uint8_t fl = flags[base + p] & F_TOUCH;
          if (own_occ || ((c0 | c1) & F_SUBOCC)) fl |= F_SUBOCC;
          if (any_tch) fl |= F_TOUCH;
          flags[base + p] = fl;
        }
        __syncthreads();
      }
    }
    // the slab's AND-NOTs landed before the barriers above
    for (int i = tid; i < NW; i += THREADS) fmerged_local += slab[i] != sold[i];
    freed_local += sfreed_local;
    flog_local += sfreed_local;
    if (freed_local) atomicAdd(&st[ST_FREED], freed_local);
    if (flog_local) atomicAdd(&st[ST_FREE_LOGICAL], flog_local);
    if (fmerged_local) atomicAdd(&st[ST_FREE_MERGED], fmerged_local);
    __syncthreads();  // the slab phase below rewrites sold
  }

  // ---------------- lockstep alloc rounds ----------------------------
  int rounds = 0;
  const int ich_words = (NW + NWARPS - 1) / NWARPS;  // slab words per warp
  const int sw0 = min(warp * ich_words, NW), sw1 = min(sw0 + ich_words, NW);
  Items it;  // the items of the first round's pending levels
  it.S = S;
  it.N = N;
  it.T = T;
  it.L = 0;
  it.n_low = 0;
  int NI = 0, j0 = 0, j1 = 0;
  while (true) {
    const int buf = rounds & 1;
    bool any = false;
#pragma unroll
    for (int j = 0; j < MAXL; ++j) any |= pend[j];

    // A. keys of the buddy round: counts per lane warp, pending levels
    auto buddy_keys = [&]() {
      unsigned levs = 0;
#pragma unroll
      for (int j = 0; j < MAXL; ++j) {
        const int w = warp + j * NWARPS;  // lane warp: lanes 32w .. 32w+31
        if (w >= nlw) continue;
        for (int c = lane; c < NK; c += 32) kcnt[w * NK + c] = 0;
        __syncwarp();
        const int l = lv[j];
        const int key = (pend[j] && l >= max_level && l <= depth) ? sh[j] * D1 + l : -1;
        const unsigned peers = __match_any_sync(FULL, key);
        if (key >= 0) {
          wr[j] = __popc(peers & lanemask_lt());
          if (!(peers & lanemask_lt())) {
            kcnt[w * NK + key] = __popc(peers);
            kmask[w * NK + key] = peers;
          }
          levs |= 1u << l;
        }
      }
      levs = __reduce_or_sync(FULL, levs);
      if (lane == 0 && levs) atomicOr(&lm[buf], levs);
    };

    if (SLAB) {
      // C.A  ranks of the lanes pending at fp_level, keyed by shard, and
      // the free slots of every slab word (warp runs)
#pragma unroll
      for (int j = 0; j < MAXL; ++j) {
        const int w = warp + j * NWARPS;
        if (w >= nlw) continue;
        for (int c = lane; c < S; c += 32) skc[w * S + c] = 0;
        __syncwarp();
        const int key = (pend[j] && lv[j] == a.fp_level) ? sh[j] : -1;
        const unsigned peers = __match_any_sync(FULL, key);
        if (key >= 0) {
          wr[j] = __popc(peers & lanemask_lt());
          if (!(peers & lanemask_lt())) skc[w * S + key] = __popc(peers);
        }
      }
      int run = 0;
      for (int i0 = sw0; i0 < sw1; i0 += 32) {
        const int i = i0 + lane;
        int v = 0;
        if (i < sw1) {
          const int x = slab[i];
          sold[i] = x;
          v = __popc(~(uint32_t)x & slot_mask(i % max(SW, 1), a.n_slots));
        }
        const int incl = warp_incl(v);
        if (i < sw1) spc[i] = run + incl - v;
        run += __shfl_sync(FULL, incl, 31);
      }
      if (lane == 0) swsum[warp] = run;
    } else {
      buddy_keys();
    }
    any = __syncthreads_or(any);
    if (!any || rounds >= a.max_rounds) break;
    ++rounds;

    if (SLAB) {
      // C.B  slab ranks over the lane warps; slab prefix over the warps
      for (int c = tid; c < S; c += THREADS) {
        int run = 0;
        for (int w = 0; w < nlw; ++w) {
          const int v = skc[w * S + c];
          skc[w * S + c] = run;
          run += v;
        }
      }
      {
        const int v = swsum[lane];
        const int incl = warp_incl(v);
        const int base = __shfl_sync(FULL, incl - v, warp);
        for (int i = sw0 + lane; i < sw1; i += 32) spc[i] += base;
        const int total = __shfl_sync(FULL, incl, 31);
        if (tid == 0) spc[NW] = total;
      }
      __syncthreads();
      // C.C  claims: rank r takes the (r+1)-th free slot of its shard
      int hits_local = 0, cmerged_local = 0;
#pragma unroll
      for (int j = 0; j < MAXL; ++j) {
        const int k = tid + j * THREADS;
        if (!pend[j] || lv[j] != a.fp_level) continue;
        const int s = sh[j], r = skc[(k >> 5) * S + s] + wr[j];
        const int first = s * SW, base = spc[first];
        if (r >= spc[first + SW] - base) continue;  // slab exhausted: buddy round
        int lo = first, hi = first + SW - 1;  // last word whose prefix <= r
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (spc[mid] - base <= r) lo = mid; else hi = mid - 1;
        }
        const uint32_t bits = ~(uint32_t)sold[lo] & slot_mask(lo - first, a.n_slots);
        const int bit = nth_bit(bits, r - (spc[lo] - base));
        const int old = atomicOr(&slab[lo], (int)(1u << bit));
        cmerged_local += old == sold[lo];  // the word's first claim changes it
        nd[j] = (1 << a.fp_level) + 32 * (lo - first) + bit;
        pend[j] = false;
        ++hits_local;
      }
      if (hits_local) {
        atomicAdd(&st[ST_FP_HITS], hits_local);
        atomicAdd(&st[ST_LOGICAL], hits_local);
      }
      if (cmerged_local) atomicAdd(&st[ST_MERGED], cmerged_local);
      buddy_keys();
      __syncthreads();
    }

    // B. column scan of the pending keys; the allocatable bits: the
    // first round evaluates its levels' items, later rounds keep them
    // (the clears of phase E) and only count them
    const unsigned L = lm[buf];
    if (tid == 0) lm[buf ^ 1] = 0;
    for (int c = tid; c < NK; c += THREADS) {
      if (!((L >> (c % D1)) & 1)) continue;
      int run = 0;
      for (int w = 0; w < nlw; ++w) {
        const int v = kcnt[w * NK + c];
        kcnt[w * NK + c] = run;
        run += v;
      }
      kcnt[nlw * NK + c] = run;
    }
    if (rounds == 1) {  // pending levels only shrink: this layout serves every round
      it.L = L;
      it.n_low = (L & 31u) ? (N >= 32 ? S : z.NWD) : 0;
      NI = it.n_low + S * (int)((L & ~31u) >> 5);
      const int ich = (NI + NWARPS - 1) / NWARPS;
      j0 = min(warp * ich, NI);
      j1 = min(j0 + ich, NI);
      int run = 0, j = j0;
      for (; j < min(j1, it.n_low); ++j) {
        const uint32_t bits = eval_low<PACKED>(it, j, state, TW, depth, ly);
        if (lane == 0) {
          ab[j] = bits;
          pre[j] = run;
        }
        run += __popc(bits);
      }
      if (j < j1) {
        int l, sj, o;
        it.locate(j, l, sj, o);
        for (; j < j1; ++j) {
          const uint32_t bits = eval_level<PACKED>(state + sj * TW, l, (1 << l) + 32 * o, ly);
          if (lane == 0) {
            ab[j] = bits;
            pre[j] = run;
          }
          run += __popc(bits);
          if (j + 1 < j1 && ++o == 1 << (l - 5)) {  // the next item's segment
            o = 0;
            if (++sj == S) {
              sj = 0;
              do ++l; while (!((L >> l) & 1));
            }
          }
        }
      }
      if (lane == 0) wsum[warp] = run;
    } else {
      int run = 0;
      for (int j = j0; j < j1; j += 32) {
        const int v = j + lane < j1 ? __popc(ab[j + lane]) : 0;
        const int incl = warp_incl(v);
        if (j + lane < j1) pre[j + lane] = run + incl - v;
        run += __shfl_sync(FULL, incl, 31);
      }
      if (lane == 0) wsum[warp] = run;
    }
    for (int i = tid; i < z.NWD; i += THREADS) mk[i] = 0;
    __syncthreads();

    // C. each warp's items take the popcount of the warps before it
    {
      const int v = wsum[lane];
      const int incl = warp_incl(v);
      const int base = __shfl_sync(FULL, incl - v, warp);
      for (int j = j0 + lane; j < j1; j += 32) pre[j] += base;
      const int total = __shfl_sync(FULL, incl, 31);
      if (tid == 0) pre[NI] = total;
    }
    __syncthreads();

    // D. targets, arbitration, commit + merged climb, routing
    const bool several = __popc(L) > 1;
    int merged_local = 0, logical_local = 0;
    unsigned won = 0;  // bit j: lane j's target was committed
#pragma unroll
    for (int j = 0; j < MAXL; ++j) {
      const int k = tid + j * THREADS, l = lv[j];
      if (!pend[j] || l < max_level || l > depth) continue;
      const int s = sh[j], c = s * D1 + l;
      const int r = kcnt[(k >> 5) * NK + c] + wr[j];
      int js, bs, je, be;
      it.pos(s, l, 1 << l, js, bs);
      it.pos(s, l, 2 << l, je, be);
      const int rs = rank_at(pre, ab, js, bs);
      const int acnt = rank_at(pre, ab, je, be) - rs;
      if (acnt == 0) {  // exhausted: probe the next shard, or fail
        if (++att[j] >= S) pend[j] = false;
        else sh[j] = (s + 1) % S;
        continue;
      }
      if (r >= acnt) continue;
      const int R = rs + r;
      int lo = js, hi = be ? je : je - 1;  // last item whose prefix <= R
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pre[mid] <= R) lo = mid; else hi = mid - 1;
      }
      const int t = it.node(s, l, lo, nth_bit(ab[lo], R - pre[lo]));
      // The owner of rank r of key c2 is below lane k iff r is below
      // the count of c2's lanes before k: its lane warp's exclusive count
      // plus the peers below it in that warp's key mask.
      bool win = true;
      const unsigned lt_k = lanemask_lt();
      for (unsigned others = several ? L & ~(1u << l) : 0u; others && win;
           others &= others - 1) {
        const int l2 = __ffs(others) - 1, c2 = s * D1 + l2;
        const int p0 = kcnt[(k >> 5) * NK + c2], p1 = kcnt[((k >> 5) + 1) * NK + c2];
        const int before = p0 + (p1 > p0 ? __popc(kmask[(k >> 5) * NK + c2] & lt_k) : 0);
        int j2, b2;
        it.pos(s, l2, 1 << l2, j2, b2);
        const int base2 = rank_at(pre, ab, j2, b2) + before;  // ranks below it lose to k's owners
        if (l2 < l) {  // the ancestor, if it is targeted by a lower id
          it.pos(s, l2, t >> (l - l2), j2, b2);
          win = !(((ab[j2] >> b2) & 1) && rank_at(pre, ab, j2, b2) < base2);
        } else {  // the first targeted node under t, if its owner is lower
          int jh, bh;
          it.pos(s, l2, t << (l2 - l), j2, b2);
          it.pos(s, l2, (t + 1) << (l2 - l), jh, bh);
          const int r0 = rank_at(pre, ab, j2, b2);
          win = !(r0 < base2 && rank_at(pre, ab, jh, bh) > r0);
        }
      }
      if (!win) continue;
      if (PACKED) {
        int first, cnt, Lr = ly.lroot[l];
        const int w = s * TW + packed_word(ly, t, l, first, cnt);
        int mask = 0;
        for (int q = first; q < first + cnt; ++q) mask |= BUSY << (5 * q);
        merged_local += or_word(state, mk, w, mask);
        logical_local += 1 + ly.crosses[l];
        // one cross mark per bunch root above, up to the top layer
        for (int rr = t >> (l - Lr); Lr > 0;) {
          const int q = rr >> 1, lq = Lr - 1;
          int qfirst, qcnt;
          const int wq = s * TW + packed_word(ly, q, lq, qfirst, qcnt);
          merged_local += or_word(state, mk, wq,
                                  ((rr & 1) ? OCC_RIGHT : OCC_LEFT) << (5 * qfirst));
          Lr = ly.lroot[lq];
          rr = q >> (lq - Lr);
        }
      } else {
        const int base = s * N;
        state[base + t] = BUSY;
        ++merged_local;
        logical_local += 1 + l - max_level;
        for (int cur = t, lev = l; lev - 1 >= max_level; --lev) {
          const int p = cur >> 1, right = cur & 1, i = base + p;
          atomicOr(&state[i], right ? OCC_RIGHT : OCC_LEFT);
          atomicAnd(&state[i], ~(right ? COAL_RIGHT : COAL_LEFT));
          if (atomicOr(&mk[i >> 5], 1u << (i & 31)) & (1u << (i & 31))) break;
          ++merged_local;  // first to reach p
          cur = p;
        }
      }
      nd[j] = t;
      pend[j] = false;
      won |= 1u << j;
    }
    if (merged_local) atomicAdd(&st[ST_MERGED], merged_local);
    if (logical_local) atomicAdd(&st[ST_LOGICAL], logical_local);
    __syncthreads();

    // E. a winner, its ancestors and its descendants leave the
    // allocatable bits (the next round's phase A writes no shared array
    // that this reads)
#pragma unroll
    for (int j = 0; j < MAXL; ++j)
      if ((won >> j) & 1) it.clear(ab, L, sh[j], lv[j], nd[j]);
  }

  // ---------------- outputs ------------------------------------------
  for (int s = 0; s < S; ++s) {
    copy_words(a.trees_out + s * W, state + s * TW, TW);
    for (int j = tid; j < SW; j += THREADS) a.trees_out[s * W + TW + j] = slab[s * SW + j];
  }
  int over_local = 0;
#pragma unroll
  for (int j = 0; j < MAXL; ++j) {
    const int k = tid + j * THREADS;
    if (k >= K) continue;
    a.nodes_out[k] = nd[j];
    if (a.shard_out) a.shard_out[k] = sh[j];
    over_local += nd[j] > 0 && sh[j] != home_of(a.lane_ids, k, S);
  }
  if (over_local) atomicAdd(&st[ST_OVERFLOWS], over_local);
  if (tid == 0) st[ST_ROUNDS] = rounds;
  __syncthreads();
  if (tid < a.n_stats) a.stats_out[tid] = st[tid];
}

template <bool PACKED, bool SHARED, bool SLAB>
int launch(const Args& a, int smem_bytes, void* stream) {
  const int smem = SHARED ? smem_bytes : 0;
  if (SHARED) {
    // raised per device to the largest size asked for so far, so that a
    // launch captured into a CUDA graph makes no attribute call
    static int allowed[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || smem > allowed[dev]) {
      err = cudaFuncSetAttribute(nbbs_step_kernel<PACKED, SHARED, SLAB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) allowed[dev] = smem;
    }
  }
  nbbs_step_kernel<PACKED, SHARED, SLAB><<<1, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool SLAB>
int run_slab(const Args& a, int packed, int smem_bytes, void* stream) {
  if (a.workspace)
    return packed ? launch<true, false, SLAB>(a, smem_bytes, stream)
                  : launch<false, false, SLAB>(a, smem_bytes, stream);
  return packed ? launch<true, true, SLAB>(a, smem_bytes, stream)
                : launch<false, true, SLAB>(a, smem_bytes, stream);
}

// A null workspace selects the shared-memory tier; SW > 0 the slab phase.
// `ws_bytes` is the size of the workspace (either tier); a launch whose
// layout needs more, or with more lanes than MAXL per thread, is refused.
int run(const Args& a, int packed, int ws_bytes, void* stream) {
  if (a.K > MAXL * THREADS || (a.release && a.F > 0 && !a.freed_out) ||
      sizes_of(a.S, a.depth, a.TW, a.SW, a.K).total > (size_t)ws_bytes)
    return (int)cudaErrorInvalidValue;
  return a.SW > 0 ? run_slab<true>(a, packed, ws_bytes, stream)
                  : run_slab<false>(a, packed, ws_bytes, stream);
}

__global__ void __launch_bounds__(THREADS) empty_kernel() {}

}  // namespace

// Kernel A: one pooled step over S trees (8 stat slots).  A row holds W
// words: W - SW tree words, then SW slab words (SW = 0: no fastpath).
extern "C" int nbbs_pool_step(const int* trees_in, int* trees_out, int S,
                              int depth, int max_level, int packed, int W,
                              int SW, int fp_level, int slab_level,
                              int n_slots, const int* free_nodes,
                              const int* free_shard,
                              const int* free_active, int F, const int* levels,
                              const int* active, const int* lane_ids, int K,
                              int max_rounds, int* nodes_out, int* shard_out,
                              int* freed_out, int* stats_out,
                              unsigned char* workspace, int ws_bytes,
                              void* stream) {
  Args a{trees_in, trees_out, S, depth, max_level, W, W - SW, SW, fp_level,
         slab_level, n_slots, free_nodes, free_shard,
         free_active, F, levels, active, lane_ids, K, max_rounds, nodes_out,
         shard_out, freed_out, stats_out, N_STATS, 1, workspace};
  return run(a, packed, ws_bytes, stream);
}

// Kernel 3: release then alloc rounds on one tree (6 stat slots).
extern "C" int nbbs_wavefront_step(const int* tree_in, int* tree_out,
                                   int depth, int max_level, int packed, int W,
                                   const int* free_nodes,
                                   const int* free_active, int F,
                                   const int* levels, const int* active, int K,
                                   int max_rounds, int* nodes_out,
                                   int* freed_out, int* stats_out,
                                   unsigned char* workspace, int ws_bytes,
                                   void* stream) {
  Args a{tree_in, tree_out, 1, depth, max_level, W, W, 0, 0, 0, 0,
         free_nodes, nullptr,
         free_active, F, levels, active, nullptr, K, max_rounds, nodes_out,
         nullptr, freed_out, stats_out, ST_FREED + 1, 1, workspace};
  return run(a, packed, ws_bytes, stream);
}

// Kernel 4: alloc rounds only on one tree (3 stat slots).
extern "C" int nbbs_wavefront_alloc(const int* tree_in, int* tree_out,
                                    int depth, int max_level, int packed,
                                    int W, const int* levels, const int* active,
                                    int K, int max_rounds, int* nodes_out,
                                    int* stats_out, unsigned char* workspace,
                                    int ws_bytes, void* stream) {
  Args a{tree_in, tree_out, 1, depth, max_level, W, W, 0, 0, 0, 0, nullptr,
         nullptr,
         nullptr, 0, levels, active, nullptr, K, max_rounds, nodes_out,
         nullptr, nullptr, stats_out, ST_LOGICAL + 1, 0, workspace};
  return run(a, packed, ws_bytes, stream);
}

// An empty launch of the same block shape: the floor under every launch
// above (`chip_smoke.py --ab nbbs_pool_step` times it beside them).
extern "C" int nbbs_empty_launch(void* stream) {
  empty_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
