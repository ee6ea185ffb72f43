// Flash attention, forward: q [B, Hq, S, D] over k, v [B, Hkv, Sk, D].
//
// Replaces the TPU kernel
// `repro/kernels/flash_attention.py::_flash_fwd_kernel` (entry
// `flash_attention_fwd`).  Same semantics: GQA (kv head = q head /
// (Hq / Hkv)), logits scaled (default 1/sqrt(D)), an optional softcap
// c * tanh(s / c) before the masks, the element masks col < Sk, causal
// col <= row and window col > row - window (rows and cols both counted
// from 0), the finite -1e30 for a masked logit, an fp32 online softmax
// whose state stays neutral while a row has seen nothing live, and 0 for
// a row whose denominator is 0.  Inputs float32 or bfloat16, arithmetic
// fp32 on the CUDA cores (as the Pallas kernel casts to fp32), output in
// q's type (bf16 rounded to nearest even by __float2bfloat16).
//
// Layout.  One block per (q tile of BQ = 64 rows, q head, batch); a loop
// over kv tiles of BK = 32 columns inside the block takes the place of
// the TPU's sequential fourth grid axis, and the running max, denominator
// and output accumulator live in registers instead of VMEM scratch.  The
// loop visits only live kv tiles (the Pallas kernel's block skipping):
// with `causal` it ends at the tile holding column row0 + BQ - 1, with a
// window it starts at the tile holding row0 - window + 1, so a sliding
// window costs O(S * window), not O(S^2).  Causal q tiles are launched
// heaviest first.
//
// Threads.  Eight threads share a row group: thread (tr, tx) holds rows
// tr + G * i (G row groups, i < RPT) and, for the logits, columns tx + 8j
// of the kv tile, for the output, float4 chunks tx + 8j of the head
// dimension.  Q, K and V tiles are staged in shared memory as fp32 (rows
// padded to D + 4 so that the float4 reads of one warp hit distinct
// banks), the probabilities of a tile as well; the row max and sum go
// through three warp shuffles.  D is any multiple of 8 up to 256:
// D <= 64 and D <= 128 take 4 rows a thread and 128 threads, D <= 256
// takes 2 rows a thread and 256 threads.  Shared memory (fp32): 64 x
// (D+4) for Q, 32 x (D+4) for K, 32 x D for V, 64 x 40 for P: 76 KB at
// D = 128, so set above 48 KB with cudaFuncSetAttribute.
//
// What bounds it on an H100: operations.  4 * B * Hq * pairs * D
// multiply-adds counted as two (pairs = the unmasked (row, col) pairs)
// against 989 TFLOP/s for bf16 on the tensor cores; gemma2-27b's global
// layer (S = 8192, causal) is 5.5e11 operations, 0.56 ms.  This kernel
// runs them on the CUDA cores in fp32 (67 TFLOP/s at best, 8.2 ms), with
// two blocks of 4 warps resident per SM at D = 128 (shared memory allows
// no third), no overlap of the K/V loads with the arithmetic, and the diagonal
// tiles of a causal mask computed in full.  Tensor cores (mma.sync or
// wgmma on bf16 tiles), TMA loads into a ring of K/V tiles, and more
// warps per SM are what it leaves on the table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int PST = BK + 8;  // row stride of the P tile (conflict-free)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  p[0] = __float2bfloat16(v.x);
  p[1] = __float2bfloat16(v.y);
  p[2] = __float2bfloat16(v.z);
  p[3] = __float2bfloat16(v.w);
}

// Copy `rows` rows of D elements (starting at global row r0 of an
// [n_rows, D] matrix) into shared memory at row stride `st`, as fp32;
// rows at or past n_rows are zero.
template <typename T, int NT>
__device__ __forceinline__ void stage(float* dst, int st, const T* src,
                                      int r0, int rows, int n_rows, int D) {
  const int nc = D / 4;
  for (int e = threadIdx.x; e < rows * nc; e += NT) {
    const int r = e / nc, c = e - r * nc;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) v = load4(src + (size_t)(r0 + r) * D + 4 * c);
    store4(dst + r * st + 4 * c, v);
  }
}

template <typename T, int RPT, int NJ4>
__global__ void __launch_bounds__(BQ / RPT * 8)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Hq,
                 int Hkv, int S, int Sk, int D, float scale, float softcap,
                 int has_softcap, int causal, int has_window, int window) {
  constexpr int G = BQ / RPT;   // row groups
  constexpr int NT = G * 8;     // threads
  constexpr int NJ = BK / 8;    // kv columns a thread holds
  extern __shared__ float smem[];
  const int QST = D + 4;
  float* Qs = smem;                 // [BQ][D+4]
  float* Ks = Qs + BQ * QST;        // [BK][D+4]
  float* Vs = Ks + BK * QST;        // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][PST]

  const int nq = gridDim.x;
  const int qt = causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int row0 = qt * BQ;
  const T* qh = q + ((size_t)b * Hq + h) * S * D;
  const T* kh = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * Sk * D;

  const int tx = threadIdx.x & 7, tr = threadIdx.x >> 3;
  const int nc = D / 4;

  stage<T, NT>(Qs, QST, qh, row0, BQ, S, D);

  float m[RPT], l[RPT], acc[RPT][NJ4][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // live kv columns of this q tile: [begin, end)
  const int end = causal ? min(Sk, row0 + BQ) : Sk;
  const int begin = has_window ? max(0, row0 - window + 1) : 0;
  const int t_end = (end + BK - 1) / BK;

  for (int t = begin / BK; t < t_end; ++t) {
    const int col0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, NT>(Ks, QST, kh, col0, BK, Sk, D);
    stage<T, NT>(Vs, D, vh, col0, BK, Sk, D);
    __syncthreads();

    // logits of RPT rows x NJ columns
    float s[RPT][NJ];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qf[RPT], kf[NJ];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qf[i] = load4(Qs + (tr + G * i) * QST + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) kf[j] = load4(Ks + (tx + 8 * j) * QST + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float x = s[i][j];
          x = fmaf(qf[i].x, kf[j].x, x);
          x = fmaf(qf[i].y, kf[j].y, x);
          x = fmaf(qf[i].z, kf[j].z, x);
          x = fmaf(qf[i].w, kf[j].w, x);
          s[i][j] = x;
        }
    }

    // online softmax: mask, row max and sum over the 8 threads of a row
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = row0 + tr + G * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = col0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        bool live = col < Sk;
        if (causal) live = live && col <= row;
        if (has_window) live = live && col > row - window;
        s[i][j] = live ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_cur = fmaxf(m[i], mx);
      const bool dead = m_cur == NEG_INF;  // nothing live in the row yet
      const float alpha = dead ? 1.f : expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = dead ? 0.f : expf(s[i][j] - m_cur);
        Ps[(tr + G * i) * PST + tx + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < NJ4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
    }
    __syncthreads();

    // acc += P V
    for (int c = 0; c < BK; c += 4) {
      float4 pf[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pf[i] = load4(Ps + (tr + G * i) * PST + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < NJ4; ++j) {
          const int ch = tx + 8 * j;
          if (ch < nc) {
            const float4 vf = load4(Vs + (c + cc) * D + 4 * ch);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float p = cc == 0 ? pf[i].x
                            : cc == 1 ? pf[i].y
                            : cc == 2 ? pf[i].z : pf[i].w;
              acc[i][j][0] = fmaf(p, vf.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(p, vf.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(p, vf.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(p, vf.w, acc[i][j][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + tr + G * i;
    if (row >= S) continue;
    const float norm = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (((size_t)b * Hq + h) * S + row) * D;
#pragma unroll
    for (int j = 0; j < NJ4; ++j) {
      const int ch = tx + 8 * j;
      if (ch < nc)
        store4(orow + 4 * ch,
               make_float4(acc[i][j][0] / norm, acc[i][j][1] / norm,
                           acc[i][j][2] / norm, acc[i][j][3] / norm));
    }
  }
}

template <typename T, int RPT, int NJ4>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int Sk, int D, float scale, float softcap,
           int has_softcap, int causal, int has_window, int window,
           cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (D + 4) + (size_t)BK * D +
                       (size_t)BQ * PST);
  auto kern = flash_fwd_kernel<T, RPT, NJ4>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, BQ / RPT * 8, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, S, Sk, D,
      scale, softcap, has_softcap, causal, has_window, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int S, int Sk, int D, float scale,
             float softcap, int has_softcap, int causal, int has_window,
             int window, cudaStream_t st) {
  if (D <= 64)
    return launch<T, 4, 2>(q, k, v, out, B, Hq, Hkv, S, Sk, D, scale,
                           softcap, has_softcap, causal, has_window, window,
                           st);
  if (D <= 128)
    return launch<T, 4, 4>(q, k, v, out, B, Hq, Hkv, S, Sk, D, scale,
                           softcap, has_softcap, causal, has_window, window,
                           st);
  return launch<T, 2, 8>(q, k, v, out, B, Hq, Hkv, S, Sk, D, scale, softcap,
                         has_softcap, causal, has_window, window, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D a multiple of 8, at most 256;
// q, k, v, out contiguous and 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Hq,
                                   int Hkv, int S, int Sk, int D, float scale,
                                   float softcap, int has_softcap, int causal,
                                   int has_window, int window, int dtype,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, Hq, Hkv, S, Sk, D, scale,
                           softcap, has_softcap, causal, has_window, window,
                           st);
  return dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, Sk, D, scale,
                                 softcap, has_softcap, causal, has_window,
                                 window, st);
}
