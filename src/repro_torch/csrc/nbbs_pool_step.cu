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
// Layouts (template parameter PACKED, uniform over the block):
//   Unpacked     one int32 status word per node (state stride 2^(depth+1));
//   BunchPacked  paper §III-D: B=3 levels per word, four 5-bit leaf slots,
//                bottom-aligned layers stored top layer first
//                (repro/core/layout.py:241-491).  Only the words persist;
//                each round derives any/occ per node into the flag byte
//                (AND of the leaf range's OCC, OR of its bits), and the
//                commit ORs BUSY over each winner's leaf range plus one
//                OCC_LEFT/OCC_RIGHT cross mark per bunch root it climbs
//                through.  merged_writes counts packed words that
//                changed, once per word: the first thread whose atomicOr
//                changes a word claims it in a scratch array.
// Per-node scratch (prefix, owner, descendant/rank map, flags) stays in
// node-index space in both layouts.
//
// Fastpath slab (template parameter SLAB, set when SW > 0, so launches
// without a fastpath compile it out; kernel A only;
// repro/kernels/nbbs_alloc.py:281-290 and :310-318, core/fastpath.py):
// with SW > 0 each shard's row is TW tree
// words followed by SW bitmap words over n_slots fast-octave blocks,
// the nodes 2^fp_level .. 2^fp_level + n_slots - 1 under the carve.
// The release routes each handle by node range before the buddy
// release: a slab leaf clears its bit (valid = bit set, duplicates to
// the minimum lane id), a node inside or on the path to the carve is
// dropped, any other takes the merged release.  Every round starts with
// the slab claim: the lanes pending at fp_level are ranked in lane
// order within their current shard (one block prefix sum per shard,
// never atomic order), and rank r takes the (r+1)-th free slot in
// find-first-zero order (a block prefix popcount over the slab words,
// then a binary search and a bit walk: `searchsorted(csum, rank + 1)`).
// Lanes past the shard's free count fall through to the same round's
// buddy round.  merged_writes counts slab words changed (against a copy
// taken before the phase), logical_rmws and fastpath_hits one per claim.
//
// Phases of a round, separated by __syncthreads():
//   0. (packed) derive any/occ per node from the words;
//   1. allocatable: word bit-free and no OCC on a strict ancestor;
//   2. rank matching (concurrent.py:203-218): a block prefix sum over the
//      allocatable flags gives each free node its index c within its
//      (shard, level) segment, and the c-th pending lane of that segment,
//      counted in lane order, takes it (searchsorted inverted);
//   3. min-id arbitration: each tentative owner atomicMin's its id into
//      own[target] and desc[] of every strict ancestor; a lane wins iff
//      its id is below desc[target] and below own[] of every ancestor;
//   4. commit + merged climb, then pool routing: a lane that exhausted its
//      shard moves to the next one and gives up after probing all S.
// The release (free_round, concurrent.py:402-457) runs once before the
// rounds: validity against the (derived) OCC, min-lane dedup of duplicate
// handles, free_logical_rmws against the pre-round state, then
// apply_frees as one bottom-up sweep (one barrier per level unpacked,
// per layer packed; the packed sweep rebuilds every word canonically).
//
// Memory tiers (template parameter SHARED).  The state words and scratch
// take 4*S*TW + 4*(3*S*SW + 1) + 13*T + 4 + 28*K bytes (T = S *
// 2^(depth+1) nodes, TW tree words and SW slab words per shard).  When that fits one block's 227 KB they live in dynamic
// shared memory; otherwise the wrapper passes a device-memory workspace
// and the same body runs from it (one block, so __syncthreads() still
// orders the phases).  The tier is a template parameter, not a runtime
// pointer choice, so that the shared tier compiles to shared-memory
// loads, stores and atomics rather than generic ones.
//
// What bounds it on an H100: at these sizes (up to 2^19 nodes) a round
// moves a few hundred KB to a few MB through shared memory or L2, so the
// time is launch latency plus the count of barriers per round (about
// depth + 10), not device-memory bytes; in the device-memory tier each
// full-tree pass also pays L2 latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OCC_RIGHT = 0x1;
constexpr int OCC_LEFT = 0x2;
constexpr int COAL_RIGHT = 0x4;
constexpr int COAL_LEFT = 0x8;
constexpr int OCC = 0x10;
constexpr int BUSY = OCC | OCC_LEFT | OCC_RIGHT;
constexpr int INF = 0x7fffffff;
constexpr uint32_t FIB_HASH = 2654435761u;
constexpr int THREADS = 1024;
constexpr int MAX_LEVELS = 32;

// stat slots, in the order of obs/schema.py's POOL_STEP_SLOTS prefix
enum {
  ST_ROUNDS, ST_MERGED, ST_LOGICAL, ST_FREE_MERGED, ST_FREE_LOGICAL,
  ST_FREED, ST_OVERFLOWS, ST_FP_HITS, N_STATS
};

// per-node flag bits
constexpr uint8_t F_ALLOC = 1;   // allocatable this round
constexpr uint8_t F_TOUCH = 2;   // freed / release climb passes through
constexpr uint8_t F_SUBOCC = 4;  // sub-tree (packed: bunch) still reserved
constexpr uint8_t D_ANY = 8;     // packed: some status bit in the leaf range
constexpr uint8_t D_OCC = 16;    // packed: every leaf slot of the range OCC

// per-lane state bits
constexpr int L_PENDING = 1;
constexpr int L_GOT = 2;
constexpr int L_EXH = 4;
constexpr int L_WIN = 8;

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
  int* freed_out;              // may be null
  int* stats_out;
  int n_stats;
  int release;                 // 0: no release phase at all (kernel 4)
  unsigned char* workspace;    // device-memory tier only
};

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

// OR `mask` into a packed word; 1 if this call is the first to change it.
__device__ __forceinline__ int or_word(int* words, int* claimed, int w, int mask) {
  const int old = atomicOr(&words[w], mask);
  return ((old | mask) != old && atomicExch(&claimed[w], -1) != -1) ? 1 : 0;
}

// Exclusive block-wide prefix sum of one int per thread.
__device__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  int base = warp > 0 ? warp_sums[warp - 1] : 0;
  int out = base + x - v;
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

template <bool PACKED, bool SHARED, bool SLAB>
__global__ void __launch_bounds__(THREADS) nbbs_step_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int st[N_STATS];
  __shared__ int warp_sums[32];
  __shared__ Layers ly;

  const int S = a.S, depth = a.depth, max_level = a.max_level, W = a.W;
  const int TW = a.TW, SW = SLAB ? a.SW : 0, NW = a.S * SW;
  const int K = a.K, F = a.F;
  const int N = 1 << (depth + 1);
  const int T = S * N;
  unsigned char* ws = SHARED ? smem_raw : a.workspace;
  int* state = reinterpret_cast<int*>(ws);  // [S*TW] persistent tree words
  int* slab = state + S * TW;  // [S*SW] persistent slab words
  int* sold = slab + NW;       // [S*SW] slab words before a phase
  int* spc = sold + NW;        // [S*SW+1] exclusive prefix of free slots
  int* scan = spc + NW + 1;    // [T+1] exclusive prefix of F_ALLOC
  int* own = scan + T + 1;     // [T]   min owner id / free dedup
  int* desc = own + T;         // [T]   rank map, min descendant id, claims
  int* lv = desc + T;          // [K]   lane level
  int* sh = lv + K;            // [K]   lane's current shard
  int* att = sh + K;           // [K]   overflow attempts
  int* nd = att + K;           // [K]   served node (0 = none)
  int* tg = nd + K;            // [K]   tentative target this round
  int* key = tg + K;           // [K]   (shard, level) segment, -1 = none
  int* lst = key + K;          // [K]   lane state bits
  uint8_t* flags = reinterpret_cast<uint8_t*>(lst + K);  // [T]

  const int tid = threadIdx.x, nt = blockDim.x;

  if (PACKED && tid == 0) build_layers(ly, depth, max_level);
  for (int s = 0; s < S; ++s) {  // row s: TW tree words, then SW slab words
    for (int j = tid; j < TW; j += nt) state[s * TW + j] = a.trees_in[s * W + j];
    for (int j = tid; j < SW; j += nt)  // sold: the release's merged count
      slab[s * SW + j] = sold[s * SW + j] = a.trees_in[s * W + TW + j];
  }
  for (int i = tid; i < T; i += nt) {
    own[i] = INF;
    flags[i] = 0;
  }
  if (tid < N_STATS) st[tid] = 0;
  for (int k = tid; k < K; k += nt) {
    lv[k] = a.levels[k];
    sh[k] = home_of(a.lane_ids, k, S);
    att[k] = 0;
    nd[k] = 0;
    lst[k] = a.active[k] ? L_PENDING : 0;
  }
  __syncthreads();

  // ---------------- merged release (free_round on every shard) -------
  if (a.release) {
    for (int f = tid; f < F; f += nt) {
      const int s = a.free_shard ? a.free_shard[f] : 0, n = a.free_nodes[f];
      if (!a.free_active[f] || s < 0 || s >= S || n <= 0 || n >= N) continue;
      bool occ;
      if (SLAB && in_slab(a, n)) {
        const int slot = n - (1 << a.fp_level);
        occ = ((uint32_t)slab[s * SW + (slot >> 5)] >> (slot & 31)) & 1u;
      } else if (SLAB && in_junk(a, n, N)) {
        continue;
      } else if (PACKED) {
        bool any, busy;
        packed_derive(state + s * TW, ly, n, any, occ, busy);
      } else {
        occ = state[s * TW + n] & OCC;
      }
      if (occ) atomicMin(&own[s * N + n], f);
    }
    __syncthreads();
    int freed_local = 0, flog_local = 0, sfreed_local = 0;
    for (int f = tid; f < F; f += nt) {
      const int s = a.free_shard ? a.free_shard[f] : 0, n = a.free_nodes[f];
      // own[] holds an id only where a handle passed the validity test
      const bool valid = a.free_active[f] && s >= 0 && s < S && n > 0 &&
                         n < N && own[s * N + n] == f;
      if (a.freed_out) a.freed_out[f] = valid;
      if (!valid) continue;
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
      flags[s * N + n] = F_TOUCH;
    }
    __syncthreads();
    int fmerged_local = 0;
    if (PACKED) {
      // canonical rebuild, one layer per barrier, deepest layer first
      for (int j = ly.n - 1; j >= 0; --j) {
        const int L = ly.root[j], Fl = ly.leaf[j], off = ly.off[j];
        const int nroots = 1 << L, nslots = 1 << (Fl - L);
        for (int x = tid; x < S * nroots; x += nt) {
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
    } else {
      fmerged_local = freed_local;
      for (int i = tid; i < T; i += nt) {
        uint8_t fl = flags[i];
        int t = state[i];
        if (fl & F_TOUCH) { t = 0; state[i] = 0; }
        if (t & OCC) fl |= F_SUBOCC;
        flags[i] = fl;
      }
      __syncthreads();
      for (int lev = depth - 1; lev >= max_level; --lev) {
        const int Wl = 1 << lev;
        for (int j = tid; j < S * Wl; j += nt) {
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
    // the slab's AND-NOTs landed before the sweep's barriers
    for (int i = tid; i < NW; i += nt) fmerged_local += slab[i] != sold[i];
    freed_local += sfreed_local;
    flog_local += sfreed_local;
    if (freed_local) atomicAdd(&st[ST_FREED], freed_local);
    if (flog_local) atomicAdd(&st[ST_FREE_LOGICAL], flog_local);
    if (fmerged_local) atomicAdd(&st[ST_FREE_MERGED], fmerged_local);
  }

  // ---------------- lockstep alloc rounds ----------------------------
  int rounds = 0;
  const int D1 = depth + 1;
  const int chunk = (T + nt - 1) / nt;
  while (true) {
    int any = 0;
    for (int k = tid; k < K; k += nt) any |= lst[k] & L_PENDING;
    any = __syncthreads_or(any);
    if (!any || rounds >= a.max_rounds) break;
    ++rounds;

    // C. slab claim of the lanes pending at fp_level, on their shard
    if (SLAB) {
      const int fpl = a.fp_level, fbase = 1 << fpl;
      {  // free slots per word, prefix over all shards' words
        const int cw = (NW + nt - 1) / nt;
        const int lo = min(tid * cw, NW), hi = min(lo + cw, NW);
        int local = 0;
        for (int i = lo; i < hi; ++i) {
          sold[i] = slab[i];
          local += __popc(~(uint32_t)slab[i] & slot_mask(i % SW, a.n_slots));
        }
        int run = block_exclusive_scan(local, warp_sums);
        for (int i = lo; i < hi; ++i) {
          spc[i] = run;
          run += __popc(~(uint32_t)sold[i] & slot_mask(i % SW, a.n_slots));
        }
        if (tid == nt - 1) spc[NW] = run;
      }
      // ranks in lane order within each shard, into tg[] (free until
      // the buddy round's phase 2)
      const int ck = (K + nt - 1) / nt;
      const int klo = min(tid * ck, K), khi = min(klo + ck, K);
      for (int s = 0; s < S; ++s) {
        int local = 0;
        for (int k = klo; k < khi; ++k)
          local += (lst[k] & L_PENDING) && lv[k] == fpl && sh[k] == s;
        if (!__syncthreads_or(local)) continue;
        int run = block_exclusive_scan(local, warp_sums);
        for (int k = klo; k < khi; ++k)
          if ((lst[k] & L_PENDING) && lv[k] == fpl && sh[k] == s) tg[k] = run++;
      }
      __syncthreads();
      int hits_local = 0;
      for (int k = tid; k < K; k += nt) {
        if (!(lst[k] & L_PENDING) || lv[k] != fpl) continue;
        const int s = sh[k], r = tg[k];
        const int first = s * SW, base = spc[first];
        if (r >= spc[first + SW] - base) continue;  // slab exhausted: buddy round
        int lo = first, hi = first + SW - 1;  // last word whose prefix <= r
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (spc[mid] - base <= r) lo = mid; else hi = mid - 1;
        }
        uint32_t bits = ~(uint32_t)sold[lo] & slot_mask(lo - first, a.n_slots);
        for (int j = r - (spc[lo] - base); j > 0; --j) bits &= bits - 1;
        const int bit = __ffs(bits) - 1;
        atomicOr(&slab[lo], (int)(1u << bit));
        nd[k] = fbase + 32 * (lo - first) + bit;
        lst[k] &= ~L_PENDING;
        ++hits_local;
      }
      __syncthreads();
      int cmerged_local = 0;
      for (int i = tid; i < NW; i += nt) cmerged_local += slab[i] != sold[i];
      if (hits_local) {
        atomicAdd(&st[ST_FP_HITS], hits_local);
        atomicAdd(&st[ST_LOGICAL], hits_local);
      }
      if (cmerged_local) atomicAdd(&st[ST_MERGED], cmerged_local);
    }

    // 0. derived node views of the packed words
    if (PACKED) {
      for (int i = tid; i < T; i += nt) {
        const int n = i & (N - 1);
        uint8_t d = 0;
        if (n) {
          bool dany, docc, dbusy;
          packed_derive(state + (i >> (depth + 1)) * TW, ly, n, dany, docc, dbusy);
          d = (dany ? D_ANY : 0) | (docc ? D_OCC : 0);
        }
        flags[i] = d;
      }
      __syncthreads();
    }
    // 1. allocatable predicate
    for (int i = tid; i < T; i += nt) {
      const int n = i & (N - 1), base = i - n;
      bool ok;
      if (PACKED) {
        ok = n >= 1 && !(flags[i] & D_ANY);
        for (int p = n >> 1; ok && p >= 1; p >>= 1)
          if (flags[base + p] & D_OCC) ok = false;
        // keep the D bits: other threads read them in this pass
        flags[i] = (flags[i] & (D_ANY | D_OCC)) | (ok ? F_ALLOC : 0);
      } else {
        ok = n >= 1 && state[i] == 0;
        for (int p = n >> 1; ok && p >= 1; p >>= 1)
          if (state[base + p] & OCC) ok = false;
        flags[i] = ok ? F_ALLOC : 0;
      }
    }
    for (int k = tid; k < K; k += nt) {
      lst[k] &= L_PENDING;
      const int l = lv[k];
      key[k] = ((lst[k] & L_PENDING) && l >= max_level && l <= depth)
                   ? sh[k] * D1 + l : -1;
    }
    __syncthreads();

    // 2. prefix count of allocatable nodes, then the rank map
    {
      const int lo = min(tid * chunk, T), hi = min(lo + chunk, T);
      int local = 0;
      for (int i = lo; i < hi; ++i) local += flags[i] & F_ALLOC;
      int run = block_exclusive_scan(local, warp_sums);
      for (int i = lo; i < hi; ++i) {
        scan[i] = run;
        run += flags[i] & F_ALLOC;
      }
      if (tid == nt - 1) scan[T] = run;
    }
    __syncthreads();
    for (int i = tid; i < T; i += nt) {
      if (!(flags[i] & F_ALLOC)) continue;
      const int n = i & (N - 1);
      const int lev = level_of(n);
      if (lev < max_level) continue;
      const int seg = i - n + (1 << lev);
      desc[seg + (scan[i] - scan[seg])] = n;
    }
    __syncthreads();
    for (int k = tid; k < K; k += nt) {
      const int kk = key[k];
      if (kk < 0) continue;
      int r = 0;
      for (int j = 0; j < k; ++j) r += key[j] == kk;
      const int base = sh[k] * N, l = lv[k];
      const int seg = base + (1 << l), seg_end = base + (2 << l);
      const int cnt = scan[seg_end] - scan[seg];
      if (cnt == 0) {
        lst[k] |= L_EXH;
      } else if (r < cnt) {
        lst[k] |= L_GOT;
        tg[k] = desc[seg + r];
      }
    }
    __syncthreads();

    // 3. min-id arbitration
    for (int i = tid; i < T; i += nt) { own[i] = INF; desc[i] = INF; }
    __syncthreads();
    for (int k = tid; k < K; k += nt) {
      if (!(lst[k] & L_GOT)) continue;
      const int base = sh[k] * N, t = tg[k];
      atomicMin(&own[base + t], k);
      for (int p = t >> 1; p >= 1; p >>= 1) atomicMin(&desc[base + p], k);
    }
    __syncthreads();
    for (int k = tid; k < K; k += nt) {
      if (!(lst[k] & L_GOT)) continue;
      const int base = sh[k] * N, t = tg[k];
      bool w = k < desc[base + t];
      for (int p = t >> 1; w && p >= 1; p >>= 1)
        if (own[base + p] <= k) w = false;
      if (w) lst[k] |= L_WIN;
    }
    __syncthreads();

    // 4. commit + merged climb; routing.  desc[] is free again: the
    // unpacked climb marks the nodes it reached there, the packed
    // commit the words it changed.
    int merged_local = 0, logical_local = 0;
    for (int k = tid; k < K; k += nt) {
      const int s = lst[k];
      if (!(s & L_PENDING)) continue;
      if (s & L_WIN) {
        const int t = tg[k];
        if (PACKED) {
          int* words = state + sh[k] * TW;
          int* claimed = desc + sh[k] * TW;
          int first, cnt, L = ly.lroot[lv[k]];
          const int w = packed_word(ly, t, lv[k], first, cnt);
          int mask = 0;
          for (int q = first; q < first + cnt; ++q) mask |= BUSY << (5 * q);
          merged_local += or_word(words, claimed, w, mask);
          logical_local += 1 + ly.crosses[lv[k]];
          // one cross mark per bunch root above, up to the top layer
          for (int r = t >> (lv[k] - L); L > 0;) {
            const int q = r >> 1, lq = L - 1;
            int qfirst, qcnt;
            const int wq = packed_word(ly, q, lq, qfirst, qcnt);
            merged_local += or_word(words, claimed, wq,
                                    ((r & 1) ? OCC_RIGHT : OCC_LEFT) << (5 * qfirst));
            L = ly.lroot[lq];
            r = q >> (lq - L);
          }
        } else {
          const int base = sh[k] * N;
          state[base + t] = BUSY;
          ++merged_local;
          logical_local += 1 + lv[k] - max_level;
          int cur = t, lev = lv[k];
          while (lev - 1 >= max_level) {
            const int p = cur >> 1;
            const int right = cur & 1;
            atomicOr(&state[base + p], right ? OCC_RIGHT : OCC_LEFT);
            atomicAnd(&state[base + p], ~(right ? COAL_RIGHT : COAL_LEFT));
            if (atomicExch(&desc[base + p], -1) == -1) break;
            ++merged_local;
            cur = p;
            --lev;
          }
        }
        nd[k] = t;
        lst[k] = s & ~L_PENDING;
      } else if (s & L_EXH) {
        const int at = att[k] + 1;
        att[k] = at;
        if (at >= S) lst[k] = s & ~L_PENDING;  // probed every shard: fail
        else sh[k] = (sh[k] + 1) % S;
      }
    }
    if (merged_local) atomicAdd(&st[ST_MERGED], merged_local);
    if (logical_local) atomicAdd(&st[ST_LOGICAL], logical_local);
    __syncthreads();
  }

  // ---------------- outputs ------------------------------------------
  for (int s = 0; s < S; ++s) {
    for (int j = tid; j < TW; j += nt) a.trees_out[s * W + j] = state[s * TW + j];
    for (int j = tid; j < SW; j += nt) a.trees_out[s * W + TW + j] = slab[s * SW + j];
  }
  int over_local = 0;
  for (int k = tid; k < K; k += nt) {
    a.nodes_out[k] = nd[k];
    if (a.shard_out) a.shard_out[k] = sh[k];
    over_local += nd[k] > 0 && sh[k] != home_of(a.lane_ids, k, S);
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
    cudaError_t err = cudaFuncSetAttribute(
        nbbs_step_kernel<PACKED, SHARED, SLAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
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
int run(const Args& a, int packed, int smem_bytes, void* stream) {
  return a.SW > 0 ? run_slab<true>(a, packed, smem_bytes, stream)
                  : run_slab<false>(a, packed, smem_bytes, stream);
}

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
                              unsigned char* workspace, int smem_bytes,
                              void* stream) {
  Args a{trees_in, trees_out, S, depth, max_level, W, W - SW, SW, fp_level,
         slab_level, n_slots, free_nodes, free_shard,
         free_active, F, levels, active, lane_ids, K, max_rounds, nodes_out,
         shard_out, freed_out, stats_out, N_STATS, 1, workspace};
  return run(a, packed, smem_bytes, stream);
}

// Kernel 3: release then alloc rounds on one tree (6 stat slots).
extern "C" int nbbs_wavefront_step(const int* tree_in, int* tree_out,
                                   int depth, int max_level, int packed, int W,
                                   const int* free_nodes,
                                   const int* free_active, int F,
                                   const int* levels, const int* active, int K,
                                   int max_rounds, int* nodes_out,
                                   int* freed_out, int* stats_out,
                                   unsigned char* workspace, int smem_bytes,
                                   void* stream) {
  Args a{tree_in, tree_out, 1, depth, max_level, W, W, 0, 0, 0, 0,
         free_nodes, nullptr,
         free_active, F, levels, active, nullptr, K, max_rounds, nodes_out,
         nullptr, freed_out, stats_out, ST_FREED + 1, 1, workspace};
  return run(a, packed, smem_bytes, stream);
}

// Kernel 4: alloc rounds only on one tree (3 stat slots).
extern "C" int nbbs_wavefront_alloc(const int* tree_in, int* tree_out,
                                    int depth, int max_level, int packed,
                                    int W, const int* levels, const int* active,
                                    int K, int max_rounds, int* nodes_out,
                                    int* stats_out, unsigned char* workspace,
                                    int smem_bytes, void* stream) {
  Args a{tree_in, tree_out, 1, depth, max_level, W, W, 0, 0, 0, 0, nullptr,
         nullptr,
         nullptr, 0, levels, active, nullptr, K, max_rounds, nodes_out,
         nullptr, nullptr, stats_out, ST_LOGICAL + 1, 0, workspace};
  return run(a, packed, smem_bytes, stream);
}
