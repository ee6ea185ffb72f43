// Paged decode attention: one query token per sequence attends over a
// page pool through a block table.
//
// Replaces the TPU kernel
// `repro/kernels/paged_attention.py::_paged_decode_kernel` (entry
// `paged_attention`).  Same semantics: GQA (kv head = q head / group),
// default scale 1/sqrt(D), optional logit softcap, fp32 online softmax;
// pages with id < 0 or starting at or past the context length are
// skipped, positions past the context are masked, and a row with no live
// page gives zeros.  A page id >= P is skipped too (the Pallas kernel
// would read out of bounds there).
//
// Layout.  One warp per (sequence, q head), four warps per block; grid
// (B, ceil(Hq / 4)).  The TPU kernel's sequential grid axis over pages
// is a loop inside the warp, and each warp reads its own block-table row
// and context length (no scalar prefetch).  Lane i holds head-dim
// elements i, i+32, i+64, i+96, so any D up to 128 works (D a multiple of
// 8; the rest is masked).  Tokens go four at a time: four dot products
// are reduced across the warp together and folded into the running
// max / sum / accumulator in fp32.
//
// What bounds it on an H100: bytes.  Each live K/V row is read once per
// q head (once per kv head when group == 1), about 2 * ctx * Hkv * D *
// sizeof(elem) per sequence, against 3.35 TB/s.  This first version
// reads 2- or 4-byte elements per lane and keeps no K/V in shared memory;
// wider loads, a shared K/V tile across the group, and splitting long
// contexts across blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int TOK = 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int Hq,
                    int Hkv, int D, int P, int page, int max_pages,
                    float scale, float softcap) {
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y * WARPS + warp;
  if (h >= Hq) return;
  const int hk = h / (Hq / Hkv);
  const int ctx = lens[b];

  float qv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? to_f(q[((size_t)b * Hq + h) * D + d]) : 0.f;
  }
  float m = NEG_INF, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int j = 0; j < max_pages; ++j) {
    const int pid = tables[(size_t)b * max_pages + j];
    if (pid < 0 || pid >= P || j * page >= ctx) continue;
    for (int t0 = 0; t0 < page && j * page + t0 < ctx; t0 += TOK) {
      float s[TOK];
      bool ok[TOK];
#pragma unroll
      for (int u = 0; u < TOK; ++u) {
        const int t = t0 + u;
        ok[u] = t < page && j * page + t < ctx;
        float part = 0.f;
        if (ok[u]) {
          const T* kr = k_pages + (((size_t)pid * page + t) * Hkv + hk) * D;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = lane + 32 * i;
            if (d < D) part += qv[i] * to_f(kr[d]);
          }
        }
        s[u] = part;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < TOK; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < TOK; ++u) {
        float x = s[u] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[u] = ok[u] ? x : NEG_INF;
        m_new = fmaxf(m_new, s[u]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < TOK; ++u) {
        if (!ok[u]) continue;
        const float p = expf(s[u] - m_new);
        l += p;
        const T* vr =
            v_pages + (((size_t)pid * page + t0 + u) * Hkv + hk) * D;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[i] += p * to_f(vr[d]);
        }
      }
      m = m_new;
    }
  }
  const float norm = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    if (d < D) store(out + ((size_t)b * Hq + h) * D + d, acc[i] / norm);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means none.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const int* tables,
                                   const int* lens, void* out, int B, int Hq,
                                   int Hkv, int D, int P, int page,
                                   int max_pages, float scale, float softcap,
                                   int dtype, void* stream) {
  const dim3 grid(B, (Hq + WARPS - 1) / WARPS);
  const dim3 block(WARPS * 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    paged_decode_kernel<float><<<grid, block, 0, st>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages, tables,
        lens, (float*)out, Hq, Hkv, D, P, page, max_pages, scale, softcap);
  } else {
    paged_decode_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, tables, lens, (__nv_bfloat16*)out, Hq,
        Hkv, D, P, page, max_pages, scale, softcap);
  }
  return (int)cudaGetLastError();
}
