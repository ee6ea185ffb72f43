// Paged decode attention: one query token per sequence attends over a
// page pool through a block table.
//
// Replaces the TPU kernel
// `repro/kernels/paged_attention.py::_paged_decode_kernel` (entry
// `paged_attention`).  Same semantics: GQA (kv head = q head / group),
// default scale 1/sqrt(D), optional logit softcap c * tanh(s / c), fp32
// online softmax, each output element rounded once to the output type;
// pages with id < 0 or starting at or past the context length are
// skipped, positions past the context are masked, and a row with no live
// position gives zeros.  A page id >= P is skipped too (the Pallas kernel
// would read out of bounds there).
//
// What bounds it on an H100: bytes.  It reads each live K/V row once per
// kv head (for a group of at most 4 q heads), 2 * ctx * Hkv * D *
// sizeof(elem) per sequence, against 3.35 TB/s; its 4 * ctx * Hq * D
// FLOPs are nothing for the fp32 CUDA cores, but the instructions around
// them (conversions, shuffles, exponentials) are not, so the design keeps
// them few per byte:
//
// - One CTA per (sequence, tile of HT kv heads with their q heads): the
//   tile's kv heads are adjacent in memory, so one token's K (or V) rows
//   for the tile are one contiguous run of HT * D elements, chosen at
//   >= MIN_RUN bytes where the heads allow it (`make_plan`).  A group of
//   more than 4 q heads is split over ceil(group / 4) CTAs.  A row with
//   ctx <= 0 writes zeros and exits.
// - The block-table row is read once per CTA by warp 0 and compacted into
//   shared memory (live page ids in order, LIST at a time), so no load
//   depends on a table word loaded per page.
// - Work items are TC tokens of one live page (a page of more than TC
//   tokens is several items).  Item i goes to warp i % WARPS.  Each warp
//   streams its items through its own ring of NS stages in shared memory,
//   filled by 16-byte `cp.async.cg` (commit / wait_group): one item in
//   flight per warp while one is consumed, four per CTA.  The constants
//   (two stages, four warps, runs of 512-1024 bytes, the register bound)
//   are the fastest of the variants timed in PERF.md section 6
//   (`chip_smoke.py --ab`): the smaller ring lets more CTAs share an SM,
//   and the warps' dependent chains, not DRAM latency, set the pace.
//   Rows are D * sizeof(elem) >= 16 bytes apart, so every copy is 16-byte
//   aligned; smem rows are padded by 16 bytes against bank conflicts.
// - Lanes own kv slots: CH elements (32 bytes: 16 in bf16 where D % 16 ==
//   0 and GQ <= 2, else 8) of one kv head, in an aligned group of HL lanes
//   per kv head.  A lane reads its elements of each K and V row once
//   (16-byte shared loads, the warp's on consecutive chunks), converts
//   them once, and does the dot products and P V updates of all GQ q
//   heads of the group with them; its fp32 (m, l, acc) are those of the
//   group's q heads.  The GQ * TC partial scores of an item are summed
//   over the HL lanes by a transposing reduction (GQ * TC - 1 shuffles,
//   then log2(HL / (GQ * TC)) more) that leaves each lane one score, so
//   each lane takes one exponential per item and the group's
//   probabilities are shared back by shuffles.  A masked token is never
//   added: its probability is 0, not exp(s - m) of two -1e30s.
// - Each warp keeps its own (m, l, acc) over its share of the items; at
//   the end the warps are merged in shared memory with the usual rescale.
//   A warp with an empty share (l == 0) adds nothing, and a row where
//   every share is empty gives exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The tuning constants.  Each can be set with -D to time a variant beside
// the default (`python3 chip_smoke.py --ab paged_attention ...`).
#ifndef PA_WARPS
#define PA_WARPS 4
#endif
#ifndef PA_STAGES
#define PA_STAGES 2
#endif
#ifndef PA_MIN_RUN
#define PA_MIN_RUN 512
#endif
#ifndef PA_MAX_RUN
#define PA_MAX_RUN 1024
#endif
#ifndef PA_BLOCKS
#define PA_BLOCKS 4
#endif
#ifndef PA_BLOCKS_GQ4
#define PA_BLOCKS_GQ4 3
#endif

constexpr int WARPS = PA_WARPS;      // warps per CTA; a row's items are dealt among them
constexpr int TC = 4;                // tokens per work item
constexpr int NS = PA_STAGES;        // ring stages per warp
constexpr int LIST = 1024;           // table entries compacted per window
constexpr int MIN_RUN = PA_MIN_RUN;  // bytes of one token's K run per CTA, wanted
constexpr int MAX_RUN = PA_MAX_RUN;  // and allowed
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// kv slots per lane for GQ q heads per kv head and CH elements per lane:
// 2 * CH fp32 registers of q and accumulator per (slot, q head), at most 64
__host__ __device__ constexpr int slots_per_lane(int gq, int ch) { return gq * ch <= 8 ? 2 : 1; }

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// One launch's tiling and the byte offsets of a CTA's dynamic shared
// memory: a header and the compacted list, then per warp its ring
// (reused for the merge).
struct Plan {
  int GQ;        // q-head slots per kv head: 1, 2 or 4
  int CH;        // elements of a row per lane: 8, or 16 in bf16 (32 bytes)
  int HT;        // kv heads per CTA
  int HL;        // lanes per kv head: D / CH and GQ * TC, rounded up to a power of two
  int nsplit;    // CTAs sharing one kv head's q heads (group > 4)
  int rs;        // smem bytes between two token rows of a stage
  int rb16;      // 16-byte chunks of one token's run
  int stage;     // bytes of one stage: TC K rows then TC V rows
  int wstride;   // bytes per warp
  int head;      // bytes before warp 0's region
  int list_cap;  // table entries per window
  int total;     // bytes of dynamic shared memory
};

inline int align16(int x) { return (x + 15) & ~15; }

inline int pow2_at_least(int x) {
  int g = 1;
  while (g < x) g *= 2;
  return g;
}

// The tile: the smallest whole number of kv heads whose run reaches
// MIN_RUN bytes and fills the warp's lanes, within MAX_RUN and the lane
// slots; a group of more than 4 q heads takes one kv head per CTA.
inline Plan make_plan(int Hq, int Hkv, int D, int es, int max_pages) {
  Plan p;
  const int G = Hq / Hkv;
  p.GQ = G >= 3 ? 4 : G;
  p.CH = es == 2 && D % 16 == 0 && p.GQ <= 2 ? 16 : 8;
  p.nsplit = (G + p.GQ - 1) / p.GQ;
  p.HL = pow2_at_least(D / p.CH > p.GQ * TC ? D / p.CH : p.GQ * TC);
  p.HT = 1;
  if (p.nsplit == 1) {
    for (int ht = 1; ht <= Hkv; ++ht) {
      if (Hkv % ht) continue;
      if (ht * p.HL > 32 * slots_per_lane(p.GQ, p.CH) || ht * D * es > MAX_RUN) break;
      p.HT = ht;
      if (ht * D * es >= MIN_RUN && ht * p.HL >= 32) break;
    }
  }
  const int run = p.HT * D * es;
  p.rs = run + 16;
  p.rb16 = run / 16;
  p.stage = 2 * TC * p.rs;
  const int ring = NS * p.stage;
  const int merge = p.HT * p.GQ * (2 + D) * 4;
  p.wstride = align16(ring > merge ? ring : merge);
  p.list_cap = max_pages < LIST ? (max_pages > 0 ? max_pages : 1) : LIST;
  p.head = 16 + align16(p.list_cap * 4);
  p.total = p.head + WARPS * p.wstride;
  return p;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 8 elements from 16-byte aligned shared memory, as fp32.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// At least PA_BLOCKS CTAs per SM: at most 128 registers, so that four
// CTAs share an SM; four q heads per kv head need more (they spill at
// 128) and take up to 170, three CTAs.
template <typename T, int GQ, int CH>
__global__ void __launch_bounds__(WARPS * 32, GQ == 4 ? PA_BLOCKS_GQ4 : PA_BLOCKS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int Hq,
                    int Hkv, int D, int P, int page, int max_pages,
                    float scale, float softcap, Plan L) {
  constexpr int KS = slots_per_lane(GQ, CH);  // kv slots per lane
  constexpr int V = GQ * TC;              // scores of one item per kv slot
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tile = blockIdx.y / L.nsplit, split = blockIdx.y - tile * L.nsplit;
  const int G = Hq / Hkv, kv0 = tile * L.HT;
  const int gq = min(GQ, G - split * GQ);     // live q-head slots per kv head
  const int q_first = kv0 * G + split * GQ;   // q head of (kv head 0, slot 0)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HL = L.HL, DC = D / CH, nks = L.HT * HL;
  // a lane's CH elements of a row: 8 from element c * 8 and, with CH = 16,
  // 8 more from D / 2 + c * 8, so that each 16-byte shared load of the
  // warp reads consecutive chunks (no bank conflict)
  const int half_row = D / 2 * (int)sizeof(T);
  auto elem = [&](int c, int e) { return e < 8 ? c * 8 + e : D / 2 + c * 8 + e - 8; };
  auto load_ch = [&](const unsigned char* p, float* o) {
    load8(reinterpret_cast<const T*>(p), o);
    if (CH == 16) load8(reinterpret_cast<const T*>(p + half_row), o + 8);
  };
  const int ctx = lens[b];
  if (ctx <= 0) {
    for (int x = threadIdx.x; x < L.HT * gq * D; x += WARPS * 32) {
      const int hk = x / (gq * D), g = x / D - hk * gq;
      store(out + ((size_t)b * Hq + q_first + hk * G + g) * D + x % D, 0.f);
    }
    return;
  }
  int* hdr = reinterpret_cast<int*>(smem);  // [0] live pages, [1] list index of page nscan - 1
  int* list = hdr + 4;
  unsigned char* ring = smem + L.head + warp * L.wstride;

  // kv slot ks = lane + 32 r: chunk c = ks % HL (live if c < D / CH) of
  // kv head ks / HL; q and accumulator chunks of its GQ q heads.  Scores
  // are kept in log2 units (exp2f): q carries scale * log2(e), or scale
  // alone when the softcap, which needs natural units, comes after.
  const float q_scale = softcap > 0.f ? scale : scale * LOG2E;
  float qv[KS][GQ][CH], acc[KS][GQ][CH], m[KS][GQ], l[KS][GQ];
  int koff[KS];
  bool on[KS];
#pragma unroll
  for (int r = 0; r < KS; ++r) {
    const int ks = lane + 32 * r, hk = ks / HL, c = ks - hk * HL;
    on[r] = ks < nks && c < DC;
    koff[r] = (hk * D + c * 8) * (int)sizeof(T);  // its first 8 elements
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      m[r][g] = NEG_INF;
      l[r][g] = 0.f;
      const T* qr = q + ((size_t)b * Hq + q_first + hk * G + g) * D;
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        qv[r][g][e] = on[r] && g < gq ? to_f(qr[elem(c, e)]) * q_scale : 0.f;
        acc[r][g][e] = 0.f;
      }
    }
  }
  const int gbase = lane & ~(HL - 1);   // first lane of this lane's group
  const int vstep = HL / V;             // neighbouring lanes holding one score

  const int nscan = min(max_pages, (ctx - 1) / page + 1);
  const int tail = min(page, ctx - (nscan - 1) * page);  // tokens of page nscan - 1
  const int subs = (page + TC - 1) / TC;
  const int gs = Hkv * D * (int)sizeof(T);  // bytes from one token's row to the next
  // a lane copies 16-byte pieces x = lane, lane + 32, ... of an item's
  // token runs (piece x is chunk x % rb16 of token x / rb16), stepping
  // its offsets instead of dividing
  const int rb16 = L.rb16, t_first = lane / rb16, c_first = lane - t_first * rb16;
  const int t_step = 32 / rb16, c_step = 32 - t_step * rb16;
  const int s_first = t_first * L.rs + c_first * 16, s_step = t_step * L.rs + c_step * 16;
  const int g_first = t_first * gs + c_first * 16, g_step = t_step * gs + c_step * 16;
  const int s_wrap = L.rs - rb16 * 16, g_wrap = gs - rb16 * 16;

  for (int ws = 0; ws < nscan; ws += L.list_cap) {
    const int we = min(nscan, ws + L.list_cap);
    if (warp == 0) {  // compact this window's live page ids, in order
      int n = 0, last = -1;
      for (int j0 = ws; j0 < we; j0 += 32) {
        const int j = j0 + lane;
        const int pid = j < we ? tables[(size_t)b * max_pages + j] : -1;
        const bool live = pid >= 0 && pid < P;
        const unsigned mask = __ballot_sync(FULL, live);
        const int pos = n + __popc(mask & ((1u << lane) - 1u));
        if (live) {
          list[pos] = pid;
          if (j == nscan - 1) last = pos;
        }
        n += __popc(mask);
      }
      last = __reduce_max_sync(FULL, last);
      if (lane == 0) {
        hdr[0] = n;
        hdr[1] = last;
      }
    }
    __syncthreads();
    const int n_items = hdr[0] * subs, last = hdr[1];
    const int n_mine = warp < n_items ? (n_items - warp + WARPS - 1) / WARPS : 0;

    // item k of this warp: its first token row in the pool and its tokens
    auto item = [&](int k, size_t& row0, int& nt) {
      const int i = warp + k * WARPS;
      const int pi = subs == 1 ? i : i / subs, t0 = (i - pi * subs) * TC;
      nt = min(TC, (pi == last ? tail : page) - t0);
      row0 = (size_t)list[pi] * page + t0;
    };
    auto issue = [&](int k) {
      if (k < n_mine) {
        size_t row0;
        int nt;
        item(k, row0, nt);
        unsigned char* st = ring + (k % NS) * L.stage;
        const size_t g0 = (row0 * Hkv + kv0) * D * sizeof(T);
        const char* gk = reinterpret_cast<const char*>(k_pages) + g0;
        const char* gv = reinterpret_cast<const char*>(v_pages) + g0;
        int t = t_first, c = c_first, so = s_first, go = g_first;
        while (t < nt) {
          cp_async16(st + so, gk + go);
          cp_async16(st + TC * L.rs + so, gv + go);
          t += t_step;
          c += c_step;
          so += s_step;
          go += g_step;
          if (c >= rb16) {
            c -= rb16;
            ++t;
            so += s_wrap;
            go += g_wrap;
          }
        }
      }
      cp_async_commit();  // empty groups keep the count in step
    };

#pragma unroll
    for (int k = 0; k < NS - 1; ++k) issue(k);
    for (int k = 0; k < n_mine; ++k) {
      issue(k + NS - 1);
      cp_async_wait<NS - 1>();
      __syncwarp();
      size_t row0;
      int nt;
      item(k, row0, nt);
      const unsigned char* st = ring + (k % NS) * L.stage;
#pragma unroll
      for (int r = 0; r < KS; ++r) {
        if (32 * r >= nks || nt <= 0) break;
        // this lane's partial scores s[g * TC + t]
        float s[V];
#pragma unroll
        for (int t = 0; t < TC; ++t) {
          float kk[CH];
          const bool ld = on[r] && t < nt;
#pragma unroll
          for (int e = 0; e < CH; ++e) kk[e] = 0.f;
          if (ld) load_ch(st + t * L.rs + koff[r], kk);
#pragma unroll
          for (int g = 0; g < GQ; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < CH; ++e) dot += qv[r][g][e] * kk[e];
            s[g * TC + t] = dot;
          }
        }
        // transposing sum over the group's HL lanes: each halving step
        // keeps half of the scores and adds the partner's other half; the
        // lane ends with the full score s[own] (own = its top log2(V)
        // bits in the group), the same on vstep neighbouring lanes
        int own = 0;
#pragma unroll
        for (int h = 0; h < log2i(V); ++h) {
          const int half = V >> (h + 1), o = HL >> (h + 1);
          const bool up = (lane & o) != 0;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = up ? s[i] : s[i + half];
            const float keep = up ? s[i + half] : s[i];
            s[i] = keep + __shfl_xor_sync(FULL, send, o);
          }
          if (up) own += half;
        }
        for (int o = vstep >> 1; o > 0; o >>= 1) s[0] += __shfl_xor_sync(FULL, s[0], o);
        const int g_own = own / TC, t_own = own - g_own * TC;
        float sv = s[0];
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap) * LOG2E;
        // the item's max per q head over its live tokens
        float mt = t_own < nt ? sv : NEG_INF;
#pragma unroll
        for (int j = 0; j < log2i(TC); ++j)
          mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, vstep << j));
        float m_own = m[r][0];
#pragma unroll
        for (int g = 1; g < GQ; ++g) m_own = g == g_own ? m[r][g] : m_own;
        const float mn = fmaxf(m_own, mt);
        const float p_own = t_own < nt ? exp2f(sv - mn) : 0.f;
        float pv[V];
#pragma unroll
        for (int i = 0; i < V; ++i) pv[i] = __shfl_sync(FULL, p_own, gbase + i * vstep);
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const float m_new = __shfl_sync(FULL, mn, gbase + g * TC * vstep);
          const float alpha = exp2f(m[r][g] - m_new);
          m[r][g] = m_new;
          float add = 0.f;
#pragma unroll
          for (int t = 0; t < TC; ++t) add += pv[g * TC + t];
          l[r][g] = l[r][g] * alpha + add;
#pragma unroll
          for (int e = 0; e < CH; ++e) acc[r][g][e] *= alpha;
        }
        if (!on[r]) continue;
#pragma unroll
        for (int t = 0; t < TC; ++t) {
          if (t >= nt) break;
          float vv[CH];
          load_ch(st + (TC + t) * L.rs + koff[r], vv);
#pragma unroll
          for (int g = 0; g < GQ; ++g) {
#pragma unroll
            for (int e = 0; e < CH; ++e) acc[r][g][e] += pv[g * TC + t] * vv[e];
          }
        }
      }
      __syncwarp();  // the stage is free for the next item
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // the list is rewritten by the next window
  }

  // merge the warps' shares: each warp writes (m, l, acc) of its
  // (kv head, q slot) pairs into its ring
  const int NH = L.HT * GQ;
  float* mg = reinterpret_cast<float*>(ring);  // [NH] m, [NH] l, [NH][D] acc
#pragma unroll
  for (int r = 0; r < KS; ++r) {
    if (!on[r]) continue;
    const int ks = lane + 32 * r, hk = ks / HL, c = ks - hk * HL;
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      const int hg = hk * GQ + g;
      if (c == 0) {
        mg[hg] = m[r][g];
        mg[NH + hg] = l[r][g];
      }
#pragma unroll
      for (int e = 0; e < CH; ++e) mg[2 * NH + hg * D + elem(c, e)] = acc[r][g][e];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < L.HT * gq * D; x += WARPS * 32) {
    const int hk = x / (gq * D), g = x / D - hk * gq, d = x % D;
    const int hg = hk * GQ + g;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* f = reinterpret_cast<const float*>(smem + L.head + w * L.wstride);
      if (f[NH + hg] > 0.f) M = fmaxf(M, f[hg]);
    }
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* f = reinterpret_cast<const float*>(smem + L.head + w * L.wstride);
      if (f[NH + hg] > 0.f) {
        const float a = exp2f(f[hg] - M);
        sum += f[NH + hg] * a;
        o += f[2 * NH + hg * D + d] * a;
      }
    }
    store(out + ((size_t)b * Hq + q_first + hk * G + g) * D + d, sum > 0.f ? o / sum : 0.f);
  }
}

template <typename T, int GQ, int CH>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* lens, void* out, int B, int Hq,
           int Hkv, int D, int P, int page, int max_pages, float scale,
           float softcap, const Plan& p, cudaStream_t st) {
  static int allowed[64];  // dynamic shared memory allowed so far, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (p.total > 48 * 1024 && dev < 64 && p.total > allowed[dev]) {
    err = cudaFuncSetAttribute(paged_decode_kernel<T, GQ, CH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.total);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = p.total;
  }
  const dim3 grid(B, Hkv / p.HT * p.nsplit);
  paged_decode_kernel<T, GQ, CH><<<grid, WARPS * 32, p.total, st>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, tables, lens, (T*)out,
      Hq, Hkv, D, P, page, max_pages, scale, softcap, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gq(const void* q, const void* k_pages, const void* v_pages,
              const int* tables, const int* lens, void* out, int B, int Hq,
              int Hkv, int D, int P, int page, int max_pages, float scale,
              float softcap, cudaStream_t st) {
  const Plan p = make_plan(Hq, Hkv, D, (int)sizeof(T), max_pages);
#define PA_LAUNCH(gq, ch)                                                       \
  return launch<T, gq, ch>(q, k_pages, v_pages, tables, lens, out, B, Hq, Hkv, D, \
                           P, page, max_pages, scale, softcap, p, st)
  if (p.GQ == 4) PA_LAUNCH(4, 8);
  if constexpr (sizeof(T) == 2) {
    if (p.CH == 16 && p.GQ == 1) PA_LAUNCH(1, 16);
    if (p.CH == 16) PA_LAUNCH(2, 16);
  }
  if (p.GQ == 1) PA_LAUNCH(1, 8);
  PA_LAUNCH(2, 8);
#undef PA_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means none.  k_pages and
// v_pages must be 16-byte aligned.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const int* tables,
                                   const int* lens, void* out, int B, int Hq,
                                   int Hkv, int D, int P, int page,
                                   int max_pages, float scale, float softcap,
                                   int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0) return 0;
  if (dtype == 0)
    return launch_gq<float>(q, k_pages, v_pages, tables, lens, out, B, Hq, Hkv, D,
                            P, page, max_pages, scale, softcap, st);
  return launch_gq<__nv_bfloat16>(q, k_pages, v_pages, tables, lens, out, B, Hq,
                                  Hkv, D, P, page, max_pages, scale, softcap, st);
}

// The tiling `paged_attention_fwd` launches with, for reports: plan[0]
// q-head slots per kv head, plan[1] kv heads per CTA, plan[2] elements of
// a row per lane, plan[3] CTAs per sequence, plan[4] bytes of dynamic
// shared memory per CTA.
extern "C" void paged_attention_plan(int Hq, int Hkv, int D, int max_pages,
                                     int dtype, int* plan) {
  const Plan p = make_plan(Hq, Hkv, D, dtype == 0 ? 4 : 2, max_pages);
  plan[0] = p.GQ;
  plan[1] = p.HT;
  plan[2] = p.CH;
  plan[3] = Hkv / p.HT * p.nsplit;
  plan[4] = p.total;
}
