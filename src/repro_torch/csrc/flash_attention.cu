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
// a row whose denominator is 0.  Output in q's type, rounded once (bf16
// to nearest even by __float2bfloat16).
//
// Every body: one block per (q tile, q head, batch) loops over the live
// kv tiles, which takes the place of the TPU's sequential fourth grid
// axis; the running max, denominator and output accumulator live in
// registers instead of VMEM scratch.  With `causal` the loop ends at the
// tile holding column row0 + BQ - 1, with a window it starts at the tile
// holding row0 - window + 1 (the Pallas kernel's block skipping), so a
// sliding window costs O(S * window), not O(S^2).  Causal q tiles are
// launched heaviest first.
//
// bfloat16: the tensor cores.  What bounds it on an H100 is operations:
// 4 * B * Hq * pairs * D multiply-adds counted as two (pairs = the
// unmasked (row, col) pairs) against 989 TFLOP/s; gemma2-27b's global
// layer (S = 8192, causal) is 5.5e11 operations, 0.56 ms.  A block holds
// 128 q rows: two consumer warpgroups of 64 rows each and a producer
// warpgroup, one thread of which issues every load (the others exit; the
// warpgroup gives its registers to the consumers by setmaxnreg).  Q comes
// once, K and V tiles of 64 rows (32 at D > 192) through a ring of up to
// three stages, all by TMA with the 128-byte swizzle, each stage with a
// full and an empty mbarrier; TMA's zero fill past the last row and past
// D gives the ragged S and Sk edges and the contraction's padding to 16.
// S = Q K^T is a wgmma with both operands K-major in shared memory, O +=
// P V a wgmma with P from registers and V read MN-major (transposed), all
// into fp32 accumulators.  The softmax runs in the accumulator's register
// layout (a row is spread over 4 threads: two shuffles), in base 2 with
// log2(e) folded into the scale; the softcap uses the fp32-accurate
// tanhf.  Only tiles that cross the causal diagonal, the window's edge or
// Sk test each element; the others take a body with no mask, and a tile
// that is masked wholly for one warpgroup's rows is not computed there.
// Each warpgroup issues S of tile t + 1 and P V of tile t before it runs
// the softmax of tile t + 1, so the tensor cores work while it does.
// The grid runs the q heads of one q tile next to each other, so the Hq
// / Hkv heads that share a kv head read its tiles from L2.  What is left
// on the table: the two consumer warpgroups are not scheduled in turns
// (ping-pong), and P V is done twice (below).
//
// Numerics.  Q K^T from bf16 inputs is exact in its products, as the
// fp32 version was.  P is not rounded once to bf16 (a relative error of
// up to 2^-9 on each p, enough over S = 4096 to put some outputs two
// bf16 ulps and more from the plain version): it goes to the tensor
// cores as a pair P_hi = bf16(P), P_lo = bf16(P - P_hi), both products
// into the same fp32 accumulator, about 2^-17 relative.  That costs a
// second P V product, 1.5x the minimal tensor-core work, and keeps every
// output within one rounding of the plain version.
//
// float32, D <= 128: 3xTF32 on the tensor cores.  Each fp32 operand x
// goes in as hi = tf32(x) and lo = tf32(x - hi), where tf32() rounds to
// nearest with ties away from zero (`cvt.rna.tf32.f32`: the low 13 bits
// of the word are zero, nothing is left for the tensor core to cut), and
// a product is lo_a hi_b + hi_a lo_b + hi_a hi_b into the fp32
// accumulator, the small terms first (CUTLASS's 3xTF32); the dropped
// lo_a lo_b and the roundings of lo leave about 2^-21 of each product,
// where one TF32 product leaves 2^-11.  What bounds it is operations: 3
// x 4 * B * Hq * pairs * D against 495 TFLOP/s of dense TF32, which is
// below the 67 TFLOP/s of the fp32 CUDA cores for the plain product.
// `wgmma` takes tf32 operands in shared memory K-major only, so a first
// kernel (`split_kv_tf32_kernel`) writes K_hi, K_lo [heads, Sk, D] and
// V^T_hi, V^T_lo [heads, D, SkP] (Sk rounded up to 8) into scratch that
// the caller allocates, V^T with the kv columns of each group of 8 in
// the order in which a thread's accumulator holds P (below): a second
// launch, about 3 x the bytes of K and V moved.  The
// attention kernel is the bf16 body's design for 4-byte elements: 128 q
// rows a block in two consumer warpgroups and a producer warpgroup, one
// thread of which keeps a ring of K_hi, K_lo, V^T_hi and V^T_lo tiles of
// 32 kv rows full by TMA (128-byte swizzle: 32 fp32 values a row; zeros
// past D, Sk and the head's last row); two stages at D > 96, three
// below.  Each consumer thread reads its Q fragment once and keeps Q_hi
// in registers as the A operand of hi_q K_hi and hi_q K_lo; Q_lo goes to
// shared memory in the 128-byte swizzle for lo_q K_hi.  S = Q K^T is
// three m64n32k8 wgmma per 8 columns of D; the softmax is the bf16
// body's; P is split in registers, and P V is three m64nNk8 wgmma per 8
// kv columns with P from registers.  A thread's accumulator holds
// columns 2tq and 2tq + 1 of each group of 8 where the tf32 A fragment
// wants columns tq and tq + 4, so the split kernel stores V^T's group
// in the order 0, 2, 4, 6, 1, 3, 5, 7 and P needs no shuffle.  As in the
// bf16 body, each warpgroup issues S of tile t + 1 and P V of tile t
// before it runs the softmax of tile t + 1.  Registers at D = 128: O 64,
// Q_hi 64, S 16, P_hi and P_lo 32.
//
// float32, 128 < D <= 256: the CUDA cores (fp32 FMAs), chosen by D in
// `flash_attention_fwd`: O alone would take 128 registers a thread and
// Q_hi as many again, and Q_lo with a K/V stage would not fit the 227 KB
// of shared memory.  No model of the repository has D > 128.  Eight
// threads share a row group: thread (tr, tx) holds rows tr + G * i (G =
// 32 row groups, i < 2) and, for the logits, columns tx + 8j of a
// 32-column kv tile, for the output, float4 chunks tx + 8j of the head
// dimension.  Q, K and V tiles are staged in shared memory as fp32 (rows
// padded to D + 4), the probabilities of a tile as well; the row max and
// sum go through three warp shuffles; loads and arithmetic do not
// overlap.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>


namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int PST = BK + 8;  // row stride of the P tile (conflict-free)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

// ---------------------------------------------------------------------------
// bfloat16 body: wgmma on the tensor cores, K and V through a TMA ring

constexpr int WG_CONSUMERS = 2;                       // warpgroups of 64 q rows
constexpr int WG_BQ = 64 * WG_CONSUMERS;              // q rows per block
constexpr int WG_THREADS = 128 * (WG_CONSUMERS + 1);  // + the producer's
constexpr int PANEL_BYTES = 64 * 128;  // 64 rows of a 128-byte panel
constexpr int RING = 3;                // stages of the K/V ring, at most
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// One box (64 columns, the map's box rows) of a [heads, rows, D] bf16
// tensor into shared memory, 128-byte swizzled, counted on `bar`; zeros
// past rows and D.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address
// `addr`: 8-row groups 1024 bytes apart (both offset fields; the other
// one is unused by every instruction here).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64, fp32) = / += A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, fp32) = / += A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// o[J0 .. J0 + 8) (64 x 64, fp32) += A (registers) * B (smem, MN-major)
template <int J0, int NO>
__device__ __forceinline__ void wgmma_rs_n64(float (&o)[NO][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(o[J0 + 0][0]), "+f"(o[J0 + 0][1]), "+f"(o[J0 + 0][2]), "+f"(o[J0 + 0][3]),
        "+f"(o[J0 + 1][0]), "+f"(o[J0 + 1][1]), "+f"(o[J0 + 1][2]), "+f"(o[J0 + 1][3]),
        "+f"(o[J0 + 2][0]), "+f"(o[J0 + 2][1]), "+f"(o[J0 + 2][2]), "+f"(o[J0 + 2][3]),
        "+f"(o[J0 + 3][0]), "+f"(o[J0 + 3][1]), "+f"(o[J0 + 3][2]), "+f"(o[J0 + 3][3]),
        "+f"(o[J0 + 4][0]), "+f"(o[J0 + 4][1]), "+f"(o[J0 + 4][2]), "+f"(o[J0 + 4][3]),
        "+f"(o[J0 + 5][0]), "+f"(o[J0 + 5][1]), "+f"(o[J0 + 5][2]), "+f"(o[J0 + 5][3]),
        "+f"(o[J0 + 6][0]), "+f"(o[J0 + 6][1]), "+f"(o[J0 + 6][2]), "+f"(o[J0 + 6][3]),
        "+f"(o[J0 + 7][0]), "+f"(o[J0 + 7][1]), "+f"(o[J0 + 7][2]), "+f"(o[J0 + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o[J0 .. J0 + 4) (64 x 32, fp32) += A (registers) * B (smem, MN-major)
template <int J0, int NO>
__device__ __forceinline__ void wgmma_rs_n32(float (&o)[NO][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(o[J0 + 0][0]), "+f"(o[J0 + 0][1]), "+f"(o[J0 + 0][2]), "+f"(o[J0 + 0][3]),
        "+f"(o[J0 + 1][0]), "+f"(o[J0 + 1][1]), "+f"(o[J0 + 1][2]), "+f"(o[J0 + 1][3]),
        "+f"(o[J0 + 2][0]), "+f"(o[J0 + 2][1]), "+f"(o[J0 + 2][2]), "+f"(o[J0 + 2][3]),
        "+f"(o[J0 + 3][0]), "+f"(o[J0 + 3][1]), "+f"(o[J0 + 3][2]), "+f"(o[J0 + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o[J0 .. J0 + 2) (64 x 16, fp32) += A (registers) * B (smem, MN-major)
template <int J0, int NO>
__device__ __forceinline__ void wgmma_rs_n16(float (&o)[NO][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(o[J0 + 0][0]), "+f"(o[J0 + 0][1]), "+f"(o[J0 + 0][2]), "+f"(o[J0 + 0][3]),
        "+f"(o[J0 + 1][0]), "+f"(o[J0 + 1][1]), "+f"(o[J0 + 1][2]), "+f"(o[J0 + 1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Split (x, y) into bf16 pairs hi = bf16(x, y) and lo = bf16(residuals).
__device__ __forceinline__ void split_hi_lo(float x, float y, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - __low2float(h),
                                         y - __high2float(h)));
}

struct TcArgs {
  int S, Sk, D;
  float scale2;     // scale * log2(e) (no softcap)
  float scale;      // the logits' scale
  float inv_cap;    // 1 / softcap
  float cap2;       // softcap * log2(e)
  int has_softcap, causal, has_window, window;
};

// Logits of one kv tile to base-2 log-probabilities, the row max, the
// rescale of the running state and the probabilities, in place.  Rows
// ra and ra + 8 of the thread; `s[j][e]` is column col0 + 8j + 2tq + (e
// & 1) of row ra (e < 2) or ra + 8 (e >= 2).  MASK: the tile crosses
// the causal diagonal, the window's edge or Sk.
template <bool MASK, int NS>
__device__ __forceinline__ void tc_softmax(float (&s)[NS][4], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2],
                                           const TcArgs& a, int ra, int col0,
                                           int tq) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y;
      if (a.has_softcap)
        y = a.cap2 * tanhf(s[j][e] * a.scale * a.inv_cap);
      else
        y = s[j][e] * a.scale2;
      if (MASK) {
        const int row = ra + (e >> 1) * 8;
        const int col = col0 + 8 * j + 2 * tq + (e & 1);
        bool live = col < a.Sk;
        if (a.causal) live = live && col <= row;
        if (a.has_window) live = live && col > row - a.window;
        y = live ? y : NEG_INF;
      }
      s[j][e] = y;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_cur = fmaxf(m[i], mx);
    // MASK: a row may have seen nothing live yet; its state stays neutral
    const bool dead = MASK && m_cur == NEG_INF;
    alpha[i] = dead ? 1.f : exp2f(m[i] - m_cur);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const float p = dead ? 0.f : exp2f(s[j][e] - m_cur);
        s[j][e] = p;
        sum += p;
      }
    l[i] = l[i] * alpha[i] + sum;  // this thread's columns; summed at the end
    m[i] = m_cur;
  }
}

// O[:, 64p .. 64p + width) += P V for one 16-row k step of V (panel p
// of the stage at `v`, MN-major); width 64, or the tail of D.
template <int P, int DP, int KPANEL, int NO>
__device__ __forceinline__ void pv_panel(float (&o)[NO][4], const uint32_t (&a)[4],
                                         uint32_t v, int kk) {
  const uint64_t d = wg_desc(v + P * KPANEL + kk * 16 * 128);
  constexpr int W = DP - 64 * P < 64 ? DP - 64 * P : 64;
  if constexpr (W == 64) wgmma_rs_n64<8 * P>(o, a, d);
  else if constexpr (W == 32) wgmma_rs_n32<8 * P>(o, a, d);
  else wgmma_rs_n16<8 * P>(o, a, d);
}

template <int DP, int KPANEL, int NO, int... Ps>
__device__ __forceinline__ void pv_all(float (&o)[NO][4], const uint32_t (&a)[4],
                                       uint32_t v, int kk,
                                       std::integer_sequence<int, Ps...>) {
  (pv_panel<Ps, DP, KPANEL>(o, a, v, kk), ...);
}

// S (64 x BK) = Q K^T over D: NKS k16 steps, Q and K K-major
template <int BK, int NKS>
__device__ __forceinline__ void qk(float (&s)[BK / 8][4], uint32_t q_s,
                                   uint32_t k_s) {
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int q_off = (ks / 4) * PANEL_BYTES + (ks % 4) * 32;
    const int k_off = (ks / 4) * (BK * 128) + (ks % 4) * 32;
    if constexpr (BK == 64)
      wgmma_ss_n64(s, wg_desc(q_s + q_off), wg_desc(k_s + k_off), ks > 0);
    else
      wgmma_ss_n32(s, wg_desc(q_s + q_off), wg_desc(k_s + k_off), ks > 0);
  }
}

// DP: D rounded up to 16 (64, 80, 96, 128, 192, 256; 32 for D <= 32);
// BK: kv tile rows; NST: stages of the K/V ring.
template <int DP, int BK, int NST>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                      TcArgs a) {
  constexpr int NPAN = (DP + 63) / 64;       // 64-column panels
  constexpr int QTILE = NPAN * PANEL_BYTES;  // 64 rows of Q
  constexpr int KPANEL = BK * 128;           // BK rows of one panel
  constexpr int KTILE = NPAN * KPANEL;       // BK rows of K or V
  constexpr int NKS = DP / 16;               // k16 steps over D
  constexpr int NO = DP / 8;                 // n8 tiles of the output
  constexpr int NS = BK / 8;                 // n8 tiles of the logits
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST], qbar;
  // panels of the 128-byte swizzle start on 1024-byte boundaries
  const uint32_t raw = smem_u32(wg_smem);
  unsigned char* Qs = wg_smem + (((raw + 1023) & ~1023u) - raw);
  unsigned char* Ks = Qs + WG_CONSUMERS * QTILE;  // [NST][KTILE]
  unsigned char* Vs = Ks + NST * KTILE;           // [NST][KTILE]

  const int S = a.S, Sk = a.Sk;
  // heads of one q tile next to each other; causal: heaviest tile first
  const int nq = gridDim.x / Hq;
  const int h = blockIdx.x % Hq;
  const int qi = blockIdx.x / Hq;
  const int qt = a.causal ? nq - 1 - qi : qi;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int row0 = qt * WG_BQ;
  // live kv tiles of this q tile: [t0, t1)
  const int end = a.causal ? min(Sk, row0 + WG_BQ) : Sk;
  const int begin = a.has_window ? max(0, row0 - a.window + 1) : 0;
  const int t0 = begin / BK, t1 = (end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128 * WG_CONSUMERS);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler, so that the roles' paths do not count
  // as divergent (it would serialize the wgmma instructions)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == WG_CONSUMERS) {
    // producer: one thread keeps the ring full; its warpgroup gives its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * WG_CONSUMERS) {
      mbar_expect_tx(&qbar, WG_CONSUMERS * QTILE);
      for (int w = 0; w < WG_CONSUMERS; ++w)
        for (int p = 0; p < NPAN; ++p)
          tma_load(Qs + w * QTILE + p * PANEL_BYTES, &tmq, 64 * p,
                   row0 + 64 * w, b * Hq + h, &qbar);
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int st = i % NST;
        mbar_wait(&empty[st], ((i / NST) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * KTILE);
        for (int p = 0; p < NPAN; ++p) {
          tma_load(Ks + st * KTILE + p * KPANEL, &tmk, 64 * p, t * BK,
                   b * Hkv + hk, &full[st]);
          tma_load(Vs + st * KTILE + p * KPANEL, &tmv, 64 * p, t * BK,
                   b * Hkv + hk, &full[st]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows wrow0 .. wrow0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow0 = row0 + 64 * wg;
  const int ra = wrow0 + warp * 16 + g;  // rows ra and ra + 8 of the thread
  const uint32_t q_s = smem_u32(Qs + wg * QTILE);
  // this warpgroup's live tiles [w0, w1) within the block's; the others
  // are wholly masked for its rows and change nothing
  const int w1 = max(t0, min(t1, a.causal ? (min(Sk, wrow0 + 64) + BK - 1) / BK : t1));
  const int w0 = min(w1, max(t0, a.has_window ? max(0, wrow0 - a.window + 1) / BK : t0));

  float o[NO][4], s[NS][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];  // P of the tile in flight
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // online softmax of tile t in s; per element masks only where the
  // tile crosses the causal diagonal, the window's edge or Sk
  auto softmax = [&](int t) {
    const int col0 = t * BK;
    const bool edge = col0 + BK > Sk || (a.causal && col0 + BK - 1 > wrow0) ||
                      (a.has_window && col0 <= wrow0 + 63 - a.window);
    if (edge)
      tc_softmax<true>(s, m, l, alpha, a, ra, col0, tq);
    else
      tc_softmax<false>(s, m, l, alpha, a, ra, col0, tq);
  };
  // O *= alpha, and P as bf16 pairs hi and lo for the P V products
  auto rescale_split = [&]() {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      split_hi_lo(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_hi_lo(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_hi_lo(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_hi_lo(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
  };
  // O += P_hi V + P_lo V, P from registers, V (stage at v_s) MN-major
  auto pv = [&](uint32_t v_s) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pv_all<DP, KPANEL>(o, ph[kk], v_s, kk, std::make_integer_sequence<int, NPAN>{});
      pv_all<DP, KPANEL>(o, pl[kk], v_s, kk, std::make_integer_sequence<int, NPAN>{});
    }
  };

  mbar_wait(&qbar, 0);
  int i = 0;  // position in the ring
  for (int t = t0; t < w0; ++t, ++i) {
    mbar_wait(&full[i % NST], (i / NST) & 1);
    mbar_arrive(&empty[i % NST]);
  }
  if (w0 < w1) {
    mbar_wait(&full[i % NST], (i / NST) & 1);
    wg_fence();
    qk<BK, NKS>(s, q_s, smem_u32(Ks + (i % NST) * KTILE));
    wg_commit();
    wg_wait_all();
    softmax(w0);
    rescale_split();
    // S of tile t + 1 and P V of tile t on the tensor cores while the
    // softmax of tile t + 1 runs on the CUDA cores
    for (int t = w0; t + 1 < w1; ++t, ++i) {
      const int st = i % NST, sn = (i + 1) % NST;
      mbar_wait(&full[sn], ((i + 1) / NST) & 1);
      wg_fence();
      qk<BK, NKS>(s, q_s, smem_u32(Ks + sn * KTILE));
      wg_commit();
      pv(smem_u32(Vs + st * KTILE));
      wg_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S
      softmax(t + 1);
      wg_wait_all();  // P V of tile t: its stage is free
      mbar_arrive(&empty[st]);
      rescale_split();
    }
    wg_fence();
    pv(smem_u32(Vs + (i % NST) * KTILE));
    wg_commit();
    wg_wait_all();
    mbar_arrive(&empty[i % NST]);
    ++i;
  }
  for (int t = w1; t < t1; ++t, ++i) {
    mbar_wait(&full[i % NST], (i / NST) & 1);
    mbar_arrive(&empty[i % NST]);
  }

  // the row sums over the 4 threads of a row, then one rounding
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int D = a.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= S) continue;
    const float norm = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = out + (((size_t)b * Hq + h) * S + row) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[j][2 * r] / norm, o[j][2 * r + 1] / norm);
    }
  }
}

// cuTensorMapEncodeTiled, a driver API, through the runtime's entry point
// (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [heads, rows, cols] of bf16 (or fp32) in boxes of 128 bytes of columns
// (64 bf16 or 32 fp32 values) x box_rows rows with the 128-byte swizzle;
// a box reads zeros past rows and cols
bool tensor_map(CUtensorMap* map, const void* ptr, int heads, int rows,
                int cols, int box_rows, bool fp32 = false) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t elem_bytes = fp32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem_bytes,
                                 (cuuint64_t)rows * cols * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Hq, int Hkv, const TcArgs& a, cudaStream_t st) {
  constexpr int BK = DP > 192 ? 32 : 64;  // D > 192: the registers of O
  constexpr int QTILE = (DP + 63) / 64 * PANEL_BYTES;
  constexpr int KTILE = (DP + 63) / 64 * BK * 128;
  // 227 KB a block, less the alignment slack and the barriers
  constexpr int FIT = (232448 - 1024 - 64 - WG_CONSUMERS * QTILE) / (2 * KTILE);
  constexpr int NST = FIT < RING ? FIT : RING;
  const size_t smem = 1024 + (size_t)WG_CONSUMERS * QTILE + (size_t)2 * NST * KTILE;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B * Hq, a.S, a.D, 64) ||
      !tensor_map(&tk, k, B * Hkv, a.Sk, a.D, BK) ||
      !tensor_map(&tv, v, B * Hkv, a.Sk, a.D, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_bf16_kernel<DP, BK, NST>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.S + WG_BQ - 1) / WG_BQ) * Hq, 1, B);
  kern<<<grid, WG_THREADS, smem, st>>>(tq, tk, tv, (__nv_bfloat16*)out, Hq,
                                       Hkv, a);
  return (int)cudaGetLastError();
}

TcArgs tc_args(int S, int Sk, int D, float scale, float softcap,
               int has_softcap, int causal, int has_window, int window) {
  TcArgs a;
  a.S = S;
  a.Sk = Sk;
  a.D = D;
  a.scale = scale;
  a.scale2 = scale * LOG2E;
  a.inv_cap = has_softcap ? 1.f / softcap : 0.f;
  a.cap2 = softcap * LOG2E;
  a.has_softcap = has_softcap;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  return a;
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out,
                  int B, int Hq, int Hkv, const TcArgs& a, cudaStream_t st) {
  const int D = a.D;
  if (D <= 32) return launch_bf16<32>(q, k, v, out, B, Hq, Hkv, a, st);
  if (D <= 64) return launch_bf16<64>(q, k, v, out, B, Hq, Hkv, a, st);
  if (D <= 80) return launch_bf16<80>(q, k, v, out, B, Hq, Hkv, a, st);
  if (D <= 96) return launch_bf16<96>(q, k, v, out, B, Hq, Hkv, a, st);
  if (D <= 128) return launch_bf16<128>(q, k, v, out, B, Hq, Hkv, a, st);
  if (D <= 192) return launch_bf16<192>(q, k, v, out, B, Hq, Hkv, a, st);
  return launch_bf16<256>(q, k, v, out, B, Hq, Hkv, a, st);
}

// ---------------------------------------------------------------------------
// float32 body (D <= 128): 3xTF32 wgmma, K and V^T as hi/lo tiles through
// a TMA ring

constexpr int TF_BK = 32;           // kv rows a tile: 128 bytes of V^T
constexpr int TF_PANEL = 64 * 128;  // 64 rows of a 32-column fp32 panel
constexpr int TF_MAX_D = 128;       // above: the CUDA-core body

// tf32(x), rounded to nearest with ties away from zero: the low 13 bits
// of the word are 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// K_hi, K_lo [heads, Sk, D] and V^T_hi, V^T_lo [heads, D, SkP] for TF_BK
// kv rows a block.  V^T's column 8u + kp holds kv row 8u + 2 (kp & 3) +
// (kp >> 2); its columns from Sk to SkP are 0.
__global__ void __launch_bounds__(256)
split_kv_tf32_kernel(const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ khi, float* __restrict__ klo,
                     float* __restrict__ vhi, float* __restrict__ vlo, int Hkv,
                     int Sk, int SkP, int D) {
  __shared__ float vs[TF_BK][TF_MAX_D + 1];
  const int c0 = blockIdx.x * TF_BK;
  const size_t head = (size_t)blockIdx.z * Hkv + blockIdx.y;
  const int rows = min(TF_BK, Sk - c0);
  for (int e = threadIdx.x; e < TF_BK * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D;
    float x = 0.f;
    if (r < rows) {
      const size_t i = (head * Sk + c0 + r) * D + c;
      uint32_t hi, lo;
      split_tf32(k[i], hi, lo);
      khi[i] = __uint_as_float(hi);
      klo[i] = __uint_as_float(lo);
      x = v[i];
    }
    vs[r][c] = x;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < D * TF_BK; e += blockDim.x) {
    const int d = e / TF_BK, kp = e - d * TF_BK;
    if (c0 + kp >= SkP) continue;
    uint32_t hi, lo;
    split_tf32(vs[(kp & ~7) + 2 * (kp & 3) + ((kp >> 2) & 1)][d], hi, lo);
    const size_t i = (head * D + d) * SkP + c0 + kp;
    vhi[i] = __uint_as_float(hi);
    vlo[i] = __uint_as_float(lo);
  }
}

// s (64 x 32, fp32) = / += A (smem, K-major) * B (smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[4][4], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// o[J0 .. J0 + 4) (64 x 32, fp32) += A (registers) * B (smem, K-major), tf32
template <int J0, int NO>
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&o)[NO][4],
                                                  const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(o[J0 + 0][0]), "+f"(o[J0 + 0][1]), "+f"(o[J0 + 0][2]), "+f"(o[J0 + 0][3]),
        "+f"(o[J0 + 1][0]), "+f"(o[J0 + 1][1]), "+f"(o[J0 + 1][2]), "+f"(o[J0 + 1][3]),
        "+f"(o[J0 + 2][0]), "+f"(o[J0 + 2][1]), "+f"(o[J0 + 2][2]), "+f"(o[J0 + 2][3]),
        "+f"(o[J0 + 3][0]), "+f"(o[J0 + 3][1]), "+f"(o[J0 + 3][2]), "+f"(o[J0 + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o[J0 .. J0 + 2) (64 x 16, fp32) += A (registers) * B (smem, K-major), tf32
template <int J0, int NO>
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&o)[NO][4],
                                                  const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(o[J0 + 0][0]), "+f"(o[J0 + 0][1]), "+f"(o[J0 + 0][2]), "+f"(o[J0 + 0][3]),
        "+f"(o[J0 + 1][0]), "+f"(o[J0 + 1][1]), "+f"(o[J0 + 1][2]), "+f"(o[J0 + 1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[:, N0 .. DP) += A (registers) * V^T rows N0 .. DP (K-major at `v`,
// 128 bytes a row) for the k8 step kk: n32 products, an n16 for the tail
template <int N0, int DP, int NO>
__device__ __forceinline__ void pv_tf32(float (&o)[NO][4], const uint32_t (&a)[4],
                                        uint32_t v, int kk) {
  if constexpr (N0 < DP) {
    const uint64_t d = wg_desc(v + N0 * 128 + kk * 32);
    if constexpr (DP - N0 >= 32) {
      wgmma_tf32_rs_n32<N0 / 8>(o, a, d);
      pv_tf32<N0 + 32, DP>(o, a, v, kk);
    } else {
      wgmma_tf32_rs_n16<N0 / 8>(o, a, d);
    }
  }
}

// DP: D rounded up to 32, 64, 80, 96 or 128; NST: stages of the ring.
// tkh, tkl, tvh, tvl: the split kernel's K_hi, K_lo, V^T_hi, V^T_lo.
template <int DP, int NST>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const __grid_constant__ CUtensorMap tkh,
                      const __grid_constant__ CUtensorMap tkl,
                      const __grid_constant__ CUtensorMap tvh,
                      const __grid_constant__ CUtensorMap tvl,
                      float* __restrict__ out, int Hq, int Hkv, TcArgs a) {
  static_assert(DP % 16 == 0 && DP <= TF_MAX_D, "DP");
  constexpr int BK = TF_BK;
  constexpr int NPAN = (DP + 31) / 32;     // 32-column panels of Q and K
  constexpr int QTILE = NPAN * TF_PANEL;   // Q_lo of one warpgroup
  constexpr int KTILE = NPAN * BK * 128;   // BK rows of K_hi or K_lo
  constexpr int VTILE = DP * 128;          // DP rows of V^T_hi or V^T_lo
  constexpr int STAGE = 2 * KTILE + 2 * VTILE;
  constexpr int NKS = DP / 8;              // k8 steps over D, n8 tiles of O
  constexpr int NS = BK / 8;               // n8 tiles of S, k8 steps of P V
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  // panels of the 128-byte swizzle start on 1024-byte boundaries
  const uint32_t raw = smem_u32(wg_smem);
  unsigned char* Qs = wg_smem + (((raw + 1023) & ~1023u) - raw);
  unsigned char* ring = Qs + WG_CONSUMERS * QTILE;  // [NST][STAGE]

  const int S = a.S, Sk = a.Sk, D = a.D;
  // heads of one q tile next to each other; causal: heaviest tile first
  const int nq = gridDim.x / Hq;
  const int h = blockIdx.x % Hq;
  const int qi = blockIdx.x / Hq;
  const int qt = a.causal ? nq - 1 - qi : qi;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int row0 = qt * WG_BQ;
  // live kv tiles of this q tile: [t0, t1)
  const int end = a.causal ? min(Sk, row0 + WG_BQ) : Sk;
  const int begin = a.has_window ? max(0, row0 - a.window + 1) : 0;
  const int t0 = begin / BK, t1 = (end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128 * WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == WG_CONSUMERS) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * WG_CONSUMERS) {
      const int head = b * Hkv + hk;
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int st = i % NST;
        unsigned char* stage = ring + st * STAGE;
        mbar_wait(&empty[st], ((i / NST) & 1) ^ 1);
        mbar_expect_tx(&full[st], STAGE);
        for (int p = 0; p < NPAN; ++p) {
          tma_load(stage + p * BK * 128, &tkh, 32 * p, t * BK, head, &full[st]);
          tma_load(stage + KTILE + p * BK * 128, &tkl, 32 * p, t * BK, head, &full[st]);
        }
        tma_load(stage + 2 * KTILE, &tvh, t * BK, 0, head, &full[st]);
        tma_load(stage + 2 * KTILE + VTILE, &tvl, t * BK, 0, head, &full[st]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows wrow0 .. wrow0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow0 = row0 + 64 * wg;
  const int ra = wrow0 + warp * 16 + g;  // rows ra and ra + 8 of the thread
  const int w1 = max(t0, min(t1, a.causal ? (min(Sk, wrow0 + 64) + BK - 1) / BK : t1));
  const int w0 = min(w1, max(t0, a.has_window ? max(0, wrow0 - a.window + 1) / BK : t0));

  // Q once: Q_hi in registers as the A fragment of each k8 step (rows
  // ra, ra + 8 x columns tq, tq + 4 of the step), Q_lo into shared
  // memory in the 128-byte swizzle; zeros past S and D
  unsigned char* qlo = Qs + wg * QTILE;
  const float* qh_ptr = q + ((size_t)b * Hq + h) * S * D;
  uint32_t qh[NKS][4];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + g + (e & 1) * 8;
      const int c = 8 * ks + tq + (e >> 1) * 4;
      const float x = wrow0 + r < S && c < D ? qh_ptr[(size_t)(wrow0 + r) * D + c] : 0.f;
      uint32_t lo;
      split_tf32(x, qh[ks][e], lo);
      const int cc = c % 32;
      *reinterpret_cast<uint32_t*>(qlo + (c / 32) * TF_PANEL + r * 128 +
                                   (((cc >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4) = lo;
    }
  // Q_lo is read by wgmma (the async proxy), once the warpgroup wrote it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const uint32_t qlo_s = smem_u32(qlo);

  float o[NKS][4], s[NS][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t ph[NS][4], pl[NS][4];  // P of the tile in flight, as A fragments
#pragma unroll
  for (int j = 0; j < NKS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  auto stage_at = [&](int i) { return smem_u32(ring + (i % NST) * STAGE); };
  // S = Q K^T: per k8 step lo_q hi_k, hi_q lo_k, hi_q hi_k
  auto qk = [&](uint32_t st) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const int k_off = (ks / 4) * (BK * 128) + (ks % 4) * 32;
      const uint64_t khi = wg_desc(st + k_off), klo = wg_desc(st + KTILE + k_off);
      wgmma_tf32_ss_n32(s, wg_desc(qlo_s + (ks / 4) * TF_PANEL + (ks % 4) * 32), khi,
                        ks > 0);
      wgmma_tf32_rs_n32<0>(s, qh[ks], klo);
      wgmma_tf32_rs_n32<0>(s, qh[ks], khi);
    }
  };
  auto softmax = [&](int t) {
    const int col0 = t * BK;
    const bool edge = col0 + BK > Sk || (a.causal && col0 + BK - 1 > wrow0) ||
                      (a.has_window && col0 <= wrow0 + 63 - a.window);
    if (edge)
      tc_softmax<true>(s, m, l, alpha, a, ra, col0, tq);
    else
      tc_softmax<false>(s, m, l, alpha, a, ra, col0, tq);
  };
  // O *= alpha, and P as tf32 hi and lo A fragments: k step j takes
  // columns 2tq, 2tq + 1 of the thread as its k = tq, tq + 4 (V^T's
  // order within each group of 8)
  auto rescale_split = [&]() {
#pragma unroll
    for (int j = 0; j < NKS; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      split_tf32(s[j][0], ph[j][0], pl[j][0]);
      split_tf32(s[j][2], ph[j][1], pl[j][1]);
      split_tf32(s[j][1], ph[j][2], pl[j][2]);
      split_tf32(s[j][3], ph[j][3], pl[j][3]);
    }
  };
  // O += P V: per k8 step lo_p hi_v, hi_p lo_v, hi_p hi_v
  auto pv = [&](uint32_t st) {
    const uint32_t vh = st + 2 * KTILE, vl = vh + VTILE;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      pv_tf32<0, DP>(o, pl[kk], vh, kk);
      pv_tf32<0, DP>(o, ph[kk], vl, kk);
      pv_tf32<0, DP>(o, ph[kk], vh, kk);
    }
  };

  int i = 0;  // position in the ring
  for (int t = t0; t < w0; ++t, ++i) {
    mbar_wait(&full[i % NST], (i / NST) & 1);
    mbar_arrive(&empty[i % NST]);
  }
  if (w0 < w1) {
    mbar_wait(&full[i % NST], (i / NST) & 1);
    wg_fence();
    qk(stage_at(i));
    wg_commit();
    wg_wait_all();
    softmax(w0);
    rescale_split();
    // S of tile t + 1 and P V of tile t on the tensor cores while the
    // softmax of tile t + 1 runs on the CUDA cores
    for (int t = w0; t + 1 < w1; ++t, ++i) {
      const int st = i % NST;
      mbar_wait(&full[(i + 1) % NST], ((i + 1) / NST) & 1);
      wg_fence();
      qk(stage_at(i + 1));
      wg_commit();
      pv(stage_at(i));
      wg_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S
      softmax(t + 1);
      wg_wait_all();  // P V of tile t: its stage is free
      mbar_arrive(&empty[st]);
      rescale_split();
    }
    wg_fence();
    pv(stage_at(i));
    wg_commit();
    wg_wait_all();
    mbar_arrive(&empty[i % NST]);
    ++i;
  }
  for (int t = w1; t < t1; ++t, ++i) {
    mbar_wait(&full[i % NST], (i / NST) & 1);
    mbar_arrive(&empty[i % NST]);
  }

  // the row sums over the 4 threads of a row, then the fp32 output
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= S) continue;
    const float norm = l[r] == 0.f ? 1.f : l[r];
    float* orow = out + (((size_t)b * Hq + h) * S + row) * D;
#pragma unroll
    for (int j = 0; j < NKS; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[j][2 * r] / norm, o[j][2 * r + 1] / norm);
    }
  }
}

// Floats of scratch the fp32 body takes: K_hi, K_lo, V^T_hi, V^T_lo.
size_t tf32_scratch_floats(int B, int Hkv, int Sk, int D) {
  const size_t SkP = (size_t)(Sk + 7) / 8 * 8;
  return 2 * (size_t)B * Hkv * D * ((size_t)Sk + SkP);
}

template <int DP>
int launch_tf32(const void* q, const void* k, const void* v, void* out,
                void* scratch, int B, int Hq, int Hkv, const TcArgs& a,
                cudaStream_t st) {
  constexpr int NPAN = (DP + 31) / 32;
  constexpr int QTILE = NPAN * TF_PANEL;
  constexpr int STAGE = 2 * NPAN * TF_BK * 128 + 2 * DP * 128;
  // 227 KB a block, less the alignment slack and the barriers
  constexpr int FIT = (232448 - 1024 - 64 - WG_CONSUMERS * QTILE) / STAGE;
  constexpr int NST = FIT < RING ? FIT : RING;
  const int SkP = (a.Sk + 7) / 8 * 8;
  const size_t kn = (size_t)B * Hkv * a.Sk * a.D, vn = (size_t)B * Hkv * a.D * SkP;
  float* khi = static_cast<float*>(scratch);
  float* klo = khi + kn;
  float* vhi = klo + kn;
  float* vlo = vhi + vn;
  split_kv_tf32_kernel<<<dim3((SkP + TF_BK - 1) / TF_BK, Hkv, B), 256, 0, st>>>(
      (const float*)k, (const float*)v, khi, klo, vhi, vlo, Hkv, a.Sk, SkP, a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tkh, tkl, tvh, tvl;
  if (!tensor_map(&tkh, khi, B * Hkv, a.Sk, a.D, TF_BK, true) ||
      !tensor_map(&tkl, klo, B * Hkv, a.Sk, a.D, TF_BK, true) ||
      !tensor_map(&tvh, vhi, B * Hkv, a.D, SkP, DP, true) ||
      !tensor_map(&tvl, vlo, B * Hkv, a.D, SkP, DP, true))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_tf32_kernel<DP, NST>;
  const size_t smem = 1024 + (size_t)WG_CONSUMERS * QTILE + (size_t)NST * STAGE;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.S + WG_BQ - 1) / WG_BQ) * Hq, 1, B);
  kern<<<grid, WG_THREADS, smem, st>>>((const float*)q, tkh, tkl, tvh, tvl,
                                       (float*)out, Hq, Hkv, a);
  return (int)cudaGetLastError();
}

int dispatch_tf32(const void* q, const void* k, const void* v, void* out,
                  void* scratch, int B, int Hq, int Hkv, const TcArgs& a,
                  cudaStream_t st) {
  const int D = a.D;
  if (D <= 32) return launch_tf32<32>(q, k, v, out, scratch, B, Hq, Hkv, a, st);
  if (D <= 64) return launch_tf32<64>(q, k, v, out, scratch, B, Hq, Hkv, a, st);
  if (D <= 80) return launch_tf32<80>(q, k, v, out, scratch, B, Hq, Hkv, a, st);
  if (D <= 96) return launch_tf32<96>(q, k, v, out, scratch, B, Hq, Hkv, a, st);
  return launch_tf32<128>(q, k, v, out, scratch, B, Hq, Hkv, a, st);
}

}  // namespace

// Bytes of scratch that `flash_attention_fwd` needs for these shapes: the
// fp32 body's K_hi, K_lo, V^T_hi and V^T_lo at D <= 128, else 0.
extern "C" long long flash_attention_scratch_bytes(int B, int Hkv, int Sk, int D,
                                                   int dtype) {
  if (dtype != 0 || D > TF_MAX_D) return 0;
  return (long long)(sizeof(float) * tf32_scratch_floats(B, Hkv, Sk, D));
}

// dtype: 0 = float32, 1 = bfloat16.  D a multiple of 8, at most 256;
// q, k, v, out contiguous and 16-byte aligned (the wrapper checks);
// scratch: `flash_attention_scratch_bytes` bytes, 16-byte aligned.
// float32 takes the 3xTF32 body at D <= 128 and the CUDA-core body above.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Hq,
                                   int Hkv, int S, int Sk, int D, float scale,
                                   float softcap, int has_softcap, int causal,
                                   int has_window, int window, int dtype,
                                   void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D > TF_MAX_D)
    return launch<float, 2, 8>(q, k, v, out, B, Hq, Hkv, S, Sk, D, scale,
                               softcap, has_softcap, causal, has_window,
                               window, st);
  const TcArgs a = tc_args(S, Sk, D, scale, softcap, has_softcap, causal,
                           has_window, window);
  if (dtype == 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return dispatch_tf32(q, k, v, out, scratch, B, Hq, Hkv, a, st);
  }
  return dispatch_bf16(q, k, v, out, B, Hq, Hkv, a, st);
}
