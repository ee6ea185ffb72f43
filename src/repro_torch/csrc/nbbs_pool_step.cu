// Pooled NBBS step: one merged release, then lockstep alloc rounds with
// overflow re-routing, over S sharded trees, in ONE launch.
//
// Replaces the TPU kernel `repro/kernels/nbbs_alloc.py::_pool_step_kernel`
// (entry `pool_wavefront_step_pallas`).  It computes exactly what the
// lockstep router `pool_wavefront_step` (repro/core/pool.py:478, and the
// port's `repro_torch/core/pool.py`) computes for the Unpacked layout:
// the Pallas dispatcher re-routes overflowed lanes between launches, this
// kernel re-routes them between rounds inside the launch, so it is
// bit-identical to the router even when lanes overflow.
//
// Design.  One thread block owns every shard; the whole stack of trees
// and the per-node scratch live in dynamic shared memory (17 bytes per
// node plus 28 bytes per alloc lane; see `smem_bytes` in
// repro_torch/kernels/nbbs_alloc.py, which refuses larger geometries).
// The round loop and its early exit run inside the kernel, so nothing
// crosses back to the host.  __syncthreads() separates the phases of a
// round:
//   1. allocatable: word == 0 and no OCC on a strict ancestor (each
//      node walks up its own path; layout.py:107-147);
//   2. rank matching (concurrent.py:203-218): a block prefix sum over the
//      allocatable flags gives each free node its index c within its
//      (shard, level) segment, and the c-th pending lane of that segment,
//      counted in lane order, takes it (searchsorted inverted);
//   3. min-id arbitration (concurrent.py:221-224, _min_id_fields): each
//      tentative owner atomicMin's its id into own[target] and into
//      desc[] of every strict ancestor; a lane wins iff its id is below
//      desc[target] and below own[] of every strict ancestor;
//   4. commit + merged climb (Unpacked.commit_allocs, layout.py:153-177):
//      winners write BUSY and walk up OR-ing the branch bit and clearing
//      the coalescing bit of their side; the first walker to reach a node
//      counts its merged write and the others stop there;
//   5. pool routing (pool.py:235-246): a lane that exhausted its shard
//      moves to the next one, and gives up after probing all S.
// The release (free_round, concurrent.py:402-457) runs once before the
// rounds: validity, min-lane dedup of duplicate handles (atomicMin; each
// handle's verdict goes to freed_out), free_logical_rmws against the
// pre-round tree, then apply_frees as one bottom-up sweep, one level per
// barrier.
//
// What bounds it on an H100: at serving sizes (4096 pages) the step does
// a few hundred KB of shared-memory traffic per round, so its time is
// launch latency plus the count of __syncthreads (about depth + 10 per
// round), not device-memory bytes.

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

// stat slots written by the kernel (the wrapper names them)
enum {
  ST_ROUNDS, ST_MERGED, ST_LOGICAL, ST_FREE_MERGED, ST_FREE_LOGICAL,
  ST_FREED, ST_OVERFLOWS, N_STATS
};

// per-node flag bits
constexpr uint8_t F_ALLOC = 1;   // allocatable this round
constexpr uint8_t F_TOUCH = 2;   // release climb passes through
constexpr uint8_t F_SUBOCC = 4;  // sub-tree still holds a reserved node

// per-lane state bits
constexpr int L_PENDING = 1;
constexpr int L_GOT = 2;
constexpr int L_EXH = 4;
constexpr int L_WIN = 8;

__device__ __forceinline__ int level_of(int n) { return 31 - __clz(n); }

__device__ __forceinline__ int home_of(int lane_id, int S) {
  return (int)(((uint32_t)lane_id * FIB_HASH) % (uint32_t)S);
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

__global__ void __launch_bounds__(THREADS)
pool_step_kernel(const int* __restrict__ trees_in, int* __restrict__ trees_out,
                 int S, int depth, int max_level,
                 const int* __restrict__ free_nodes,
                 const int* __restrict__ free_shard,
                 const int* __restrict__ free_active, int F,
                 const int* __restrict__ levels, const int* __restrict__ active,
                 const int* __restrict__ lane_ids, int K, int max_rounds,
                 int* __restrict__ nodes_out, int* __restrict__ shard_out,
                 int* __restrict__ freed_out, int* __restrict__ stats_out) {
  extern __shared__ int smem[];
  __shared__ int st[N_STATS];
  __shared__ int warp_sums[32];

  const int N = 1 << (depth + 1);
  const int T = S * N;
  int* tree = smem;          // [T]   status words of every shard
  int* scan = tree + T;      // [T+1] exclusive prefix of F_ALLOC
  int* own = scan + T + 1;   // [T]   min owner id / free dedup
  int* desc = own + T;       // [T]   rank map, then min descendant id
  int* lv = desc + T;        // [K]   lane level
  int* sh = lv + K;          // [K]   lane's current shard
  int* att = sh + K;         // [K]   overflow attempts
  int* nd = att + K;         // [K]   served node (0 = none)
  int* tg = nd + K;          // [K]   tentative target this round
  int* key = tg + K;         // [K]   (shard, level) segment, -1 = none
  int* lst = key + K;        // [K]   lane state bits
  uint8_t* flags = reinterpret_cast<uint8_t*>(lst + K);  // [T]

  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < T; i += nt) {
    tree[i] = trees_in[i];
    own[i] = INF;
    flags[i] = 0;
  }
  if (tid < N_STATS) st[tid] = 0;
  for (int k = tid; k < K; k += nt) {
    lv[k] = levels[k];
    sh[k] = home_of(lane_ids[k], S);
    att[k] = 0;
    nd[k] = 0;
    lst[k] = active[k] ? L_PENDING : 0;
  }
  __syncthreads();

  // ---------------- merged release (free_round on every shard) -------
  for (int f = tid; f < F; f += nt) {
    const int s = free_shard[f], n = free_nodes[f];
    if (free_active[f] && s >= 0 && s < S && n > 0 && n < N &&
        (tree[s * N + n] & OCC))
      atomicMin(&own[s * N + n], f);
  }
  __syncthreads();
  int freed_local = 0, flog_local = 0;
  for (int f = tid; f < F; f += nt) {
    const int s = free_shard[f], n = free_nodes[f];
    const bool valid = free_active[f] && s >= 0 && s < S && n > 0 && n < N &&
                       (tree[s * N + n] & OCC) && own[s * N + n] == f;
    freed_out[f] = valid;
    if (!valid) continue;
    const int base = s * N;
    // run-alone FREENODE climb length against the pre-round tree
    int cur = n, lev = level_of(n), climb = 0;
    while (lev > max_level) {
      const int parent = cur >> 1;
      ++climb;
      const int buddy = (cur & 1) ? OCC_LEFT : OCC_RIGHT;
      if (tree[base + parent] & buddy) break;
      cur = parent;
      --lev;
    }
    flog_local += 2 * climb + 1;
    ++freed_local;
    flags[base + n] = F_TOUCH;
  }
  __syncthreads();
  for (int i = tid; i < T; i += nt) {
    uint8_t fl = flags[i];
    int t = tree[i];
    if (fl & F_TOUCH) { t = 0; tree[i] = 0; }
    if (t & OCC) fl |= F_SUBOCC;
    flags[i] = fl;
  }
  __syncthreads();
  int fmerged_local = freed_local;
  for (int lev = depth - 1; lev >= max_level; --lev) {
    const int W = 1 << lev;
    for (int j = tid; j < S * W; j += nt) {
      const int base = (j >> lev) * N;
      const int p = W + (j & (W - 1));
      const uint8_t c0 = flags[base + 2 * p], c1 = flags[base + 2 * p + 1];
      const bool any_tch = (c0 | c1) & F_TOUCH;
      const int pv = tree[base + p];
      const bool own_occ = pv & OCC;
      const int derived =
          ((c0 & F_SUBOCC) ? OCC_LEFT : 0) | ((c1 & F_SUBOCC) ? OCC_RIGHT : 0);
      const int nv = (any_tch && !own_occ) ? derived : pv;
      if (nv != pv) { tree[base + p] = nv; ++fmerged_local; }
      uint8_t fl = flags[base + p] & F_TOUCH;
      if (own_occ || ((c0 | c1) & F_SUBOCC)) fl |= F_SUBOCC;
      if (any_tch) fl |= F_TOUCH;
      flags[base + p] = fl;
    }
    __syncthreads();
  }
  if (freed_local) atomicAdd(&st[ST_FREED], freed_local);
  if (flog_local) atomicAdd(&st[ST_FREE_LOGICAL], flog_local);
  if (fmerged_local) atomicAdd(&st[ST_FREE_MERGED], fmerged_local);

  // ---------------- lockstep alloc rounds ----------------------------
  int rounds = 0;
  const int D1 = depth + 1;
  const int chunk = (T + nt - 1) / nt;
  while (true) {
    int any = 0;
    for (int k = tid; k < K; k += nt) any |= lst[k] & L_PENDING;
    any = __syncthreads_or(any);
    if (!any || rounds >= max_rounds) break;
    ++rounds;

    // 1. allocatable predicate
    for (int i = tid; i < T; i += nt) {
      const int n = i & (N - 1), base = i - n;
      bool a = n >= 1 && tree[i] == 0;
      for (int p = n >> 1; a && p >= 1; p >>= 1)
        if (tree[base + p] & OCC) a = false;
      flags[i] = a ? F_ALLOC : 0;
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

    // 4. commit + merged climb; 5. routing
    int merged_local = 0, logical_local = 0;
    for (int k = tid; k < K; k += nt) {
      const int s = lst[k];
      if (!(s & L_PENDING)) continue;
      if (s & L_WIN) {
        const int base = sh[k] * N, t = tg[k];
        tree[base + t] = BUSY;
        ++merged_local;
        logical_local += 1 + lv[k] - max_level;
        int cur = t, lev = lv[k];
        while (lev - 1 >= max_level) {
          const int p = cur >> 1;
          const int right = cur & 1;
          atomicOr(&tree[base + p], right ? OCC_RIGHT : OCC_LEFT);
          atomicAnd(&tree[base + p], ~(right ? COAL_RIGHT : COAL_LEFT));
          if (atomicExch(&desc[base + p], -1) == -1) break;
          ++merged_local;
          cur = p;
          --lev;
        }
        nd[k] = t;
        lst[k] = s & ~L_PENDING;
      } else if (s & L_EXH) {
        const int a = att[k] + 1;
        att[k] = a;
        if (a >= S) lst[k] = s & ~L_PENDING;  // probed every shard: fail
        else sh[k] = (sh[k] + 1) % S;
      }
    }
    if (merged_local) atomicAdd(&st[ST_MERGED], merged_local);
    if (logical_local) atomicAdd(&st[ST_LOGICAL], logical_local);
    __syncthreads();
  }

  // ---------------- outputs ------------------------------------------
  for (int i = tid; i < T; i += nt) trees_out[i] = tree[i];
  int over_local = 0;
  for (int k = tid; k < K; k += nt) {
    nodes_out[k] = nd[k];
    shard_out[k] = sh[k];
    over_local += nd[k] > 0 && sh[k] != home_of(lane_ids[k], S);
  }
  if (over_local) atomicAdd(&st[ST_OVERFLOWS], over_local);
  if (tid == 0) st[ST_ROUNDS] = rounds;
  __syncthreads();
  if (tid < N_STATS) stats_out[tid] = st[tid];
}

}  // namespace

extern "C" int nbbs_pool_step(const int* trees_in, int* trees_out, int S,
                              int depth, int max_level, const int* free_nodes,
                              const int* free_shard, const int* free_active,
                              int F, const int* levels, const int* active,
                              const int* lane_ids, int K, int max_rounds,
                              int* nodes_out, int* shard_out, int* freed_out,
                              int* stats_out, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pool_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  pool_step_kernel<<<1, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      trees_in, trees_out, S, depth, max_level, free_nodes, free_shard,
      free_active, F, levels, active, lane_ids, K, max_rounds, nodes_out,
      shard_out, freed_out, stats_out);
  return (int)cudaGetLastError();
}
