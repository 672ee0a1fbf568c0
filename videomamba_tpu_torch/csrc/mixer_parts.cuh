// Pieces shared by the fused mixer (mixer_fused.cu, K3) and the whole-block
// kernel (block_fused.cu, K4): the causal depthwise conv + SiLU and the two
// NT product tiles, C[m, n] = sum_k A[m, k] * W[n, k], where both operands
// are contraction-contiguous, the layout of a torch Linear weight (out, in).
//
// - gemm_nt: fp32 FMA tile, for the fp32 ("highest") path.
// - gemm_nt_bf16: bf16 tensor-core tile (mma.sync m16n8k16, fp32
//   accumulate). A is read as fp32 or bf16 and rounded to bf16 while it is
//   staged, which is where the TPU kernel casts each product's input to the
//   weight dtype (block_fused.py:393, 410, 415, 467); C is written as fp32 or
//   bf16. The products of bf16 values are exact in fp32, so the tile computes
//   what preferred_element_type=f32 computes, up to the order of the sums.
//
// The fp32 tile is single-stage (load a K slice to shared memory, sync,
// multiply); K14's long products take gemm_nt_wide's outer-product tile,
// its K slices double-buffered through registers. The bf16 tile (mma_tile,
// which the backward's NN and TN products in mixer_bwd.cuh and the SSD
// slab product in ssd_core.cuh share through mma_frag_a / mma_frag_b, with
// their own operand layouts) double-buffers shared memory: each thread
// loads the next K slice into registers (16-byte loads where the operands
// are aligned) while the warps multiply the current one, so the loads'
// latency is hidden behind the mma. A TMA / wgmma design is later work.
#pragma once

#include <stdint.h>

#include "add_norm.cuh"

namespace vmt {

// conv_out[b, t, d] = silu(bias[d] + sum_k w[d, k] * ctx[b, t + k, d]) where
// ctx is x preceded by the last W - 1 raw inputs held in conv_state (fp32).
// x is fp32 or bf16 (TX), the taps and bias fp32 or bf16 (TW); the sum and
// the result are fp32. out_pre, when not null, also gets the sum before the
// SiLU (the backward needs silu').
template <typename TX, typename TW>
__global__ void conv_silu_kernel(const TX* __restrict__ x, long long ld_x,
                                 const float* __restrict__ conv_state,
                                 const TW* __restrict__ w,
                                 const TW* __restrict__ bias,
                                 float* __restrict__ out,
                                 float* __restrict__ out_pre, int L, int D,
                                 int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)L * D) return;
  const long long b = blockIdx.y;
  const int d = (int)(i % D);
  const long long t = i / D;
  const TX* xb = x + b * L * ld_x;
  const float* st = conv_state + (b * D + d) * W;
  float acc = 0.f;
  for (int k = 0; k < W; ++k) {
    const long long s = t + k - (W - 1);
    const float v = s >= 0 ? to_f32(xb[s * ld_x + d]) : st[W + s];
    acc += to_f32(w[(long long)d * W + k]) * v;
  }
  acc += to_f32(bias[d]);
  if (out_pre) out_pre[(b * L + t) * D + d] = acc;
  out[(b * L + t) * D + d] = acc * (1.f / (1.f + expf(-acc)));
}

template <typename TX, typename TW>
cudaError_t conv_silu(const TX* x, long long ld_x, const float* conv_state,
                      const TW* w, const TW* bias, float* out, int batch, int L,
                      int D, int W, cudaStream_t stream, float* out_pre = nullptr) {
  const long long per_batch = (long long)L * D;
  const dim3 grid((unsigned)((per_batch + 255) / 256), batch);
  conv_silu_kernel<TX, TW><<<grid, 256, 0, stream>>>(x, ld_x, conv_state, w, bias,
                                                     out, out_pre, L, D, W);
  return cudaGetLastError();
}

constexpr int kTile = 64;   // output tile edge
constexpr int kTileK = 16;  // contraction depth per shared-memory stage

// fp32 tile: 256 threads, each 4 x 4 outputs of a 64 x 64 tile, fp32 FMA in
// contraction order. static: each source that includes this has its own.
static __global__ void __launch_bounds__(256)
    gemm_nt_kernel(const float* __restrict__ A, long long lda,
                   const float* __restrict__ Wt, long long ldw,
                   float* __restrict__ C, long long ldc, int M, int N, int K) {
  __shared__ float As[kTileK][kTile + 4];
  __shared__ float Ws[kTileK][kTile + 4];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.y * kTile;
  const long long n0 = (long long)blockIdx.x * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTile * kTileK; i += 256) {
      const int r = i / kTileK;
      const int kk = i % kTileK;
      const long long gk = k0 + kk;
      const long long gm = m0 + r;
      const long long gn = n0 + r;
      As[kk][r] = (gm < M && gk < K) ? A[gm * lda + gk] : 0.f;
      Ws[kk][r] = (gn < N && gk < K) ? Wt[gn * ldw + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float av[4];
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx * 4 + j;
      if (n < N) C[m * ldc + n] = acc[i][j];
    }
  }
}

inline cudaError_t gemm_nt(const float* A, long long lda, const float* Wt,
                           long long ldw, float* C, long long ldc, int M, int N,
                           int K, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  gemm_nt_kernel<<<grid, 256, 0, stream>>>(A, lda, Wt, ldw, C, ldc, M, N, K);
  return cudaGetLastError();
}

// The wide fp32 NT tile, for the long products gemm_nt's 64 x 64
// single-stage tile runs at about a third of the FMA rate (K14's in_proj
// and out_proj): a 64 x 64 block tile of 128 threads as 8 x 16, each 8 x 4
// outputs, rows 4 ty + [0, 4) and 32 + 4 ty + [0, 4), columns 4 tx + [0, 4).
// K slices of kWideBK are staged contraction-major (As[k][m], Ws[k][n],
// rows padded by 4 floats), double-buffered through registers: each
// thread's 16-byte loads of the next slice are in flight while the block
// multiplies the current one (cp.async cannot transpose a row-major operand
// into this layout). A step of k is an outer product: three float4 shared
// loads (A's a broadcast, W's conflict-free) for 32 independent FMAs, where
// gemm_nt issues eight scalar loads for 16. Four blocks an SM (at most 128
// registers a thread); at VideoMamba-Base-m2, B = 1, in_proj launches 25 x
// 50 blocks and out_proj 25 x 12. Every output sums over k in order, as
// gemm_nt's do, so the two tiles give bit-identical results.
constexpr int kWideBM = 64;
constexpr int kWideBN = 64;
constexpr int kWideBK = 16;
constexpr int kWideThreads = 128;

static __global__ void __launch_bounds__(kWideThreads, 4)
    gemm_nt_wide_kernel(const float* __restrict__ A, long long lda,
                        const float* __restrict__ Wt, long long ldw,
                        float* __restrict__ C, long long ldc, int M, int N, int K) {
  constexpr int LA = kWideBM + 4, LW = kWideBN + 4;
  __shared__ __align__(16) float As[2][kWideBK * LA];  // [k][m]
  __shared__ __align__(16) float Ws[2][kWideBK * LW];  // [k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.y * kWideBM;
  const long long n0 = (long long)blockIdx.x * kWideBN;
  // Each thread loads 4 consecutive k of rows r0 and r0 + 32 of A and of Wt
  // a slice; rows past M or N, and k past K, are zero.
  const int r0 = threadIdx.x / 4, kc = (threadIdx.x % 4) * 4;
  const float* pa[2];
  const float* pw[2];
  bool oka[2], okw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = m0 + r0 + 32 * h, n = n0 + r0 + 32 * h;
    oka[h] = m < M;
    okw[h] = n < N;
    pa[h] = A + (oka[h] ? m : 0) * lda + kc;
    pw[h] = Wt + (okw[h] ? n : 0) * ldw + kc;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra[2], rw[2];
  auto load = [&](int k0) {
    const bool kin = k0 + kc < K;  // K % 4 == 0: a float4 is all in or all out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ra[h] = oka[h] && kin ? __ldg(reinterpret_cast<const float4*>(pa[h] + k0)) : zero;
      rw[h] = okw[h] && kin ? __ldg(reinterpret_cast<const float4*>(pw[h] + k0)) : zero;
    }
  };
  auto store = [&](int buf) {
    float* as = As[buf] + kc * LA + r0;
    float* ws = Ws[buf] + kc * LW + r0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      as[32 * h] = ra[h].x;
      as[LA + 32 * h] = ra[h].y;
      as[2 * LA + 32 * h] = ra[h].z;
      as[3 * LA + 32 * h] = ra[h].w;
      ws[32 * h] = rw[h].x;
      ws[LW + 32 * h] = rw[h].y;
      ws[2 * LW + 32 * h] = rw[h].z;
      ws[3 * LW + 32 * h] = rw[h].w;
    }
  };
  float acc[8][4] = {};
  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kWideBK) {
    const bool more = k0 + kWideBK < K;
    if (more) load(k0 + kWideBK);  // in flight while this slice is multiplied
    const float* as = As[buf];
    const float* ws = Ws[buf];
#pragma unroll
    for (int kk = 0; kk < kWideBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LA + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * LA + 32 + 4 * ty);
      const float4 w4 = *reinterpret_cast<const float4*>(ws + kk * LW + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
    // The other buffer was last read before the previous barrier.
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  const long long n = n0 + 4 * tx;
  const bool vec = ldc % 4 == 0 && ((uintptr_t)C & 15u) == 0 && n + 3 < N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i / 4) * 32 + 4 * ty + i % 4;
    if (m >= M) continue;
    float* c = C + m * ldc + n;
    if (vec) {
      *reinterpret_cast<float4*>(c) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) c[j] = acc[i][j];
    }
  }
}

// C = A Wt^T: on the wide tile where its 16-byte loads can run (A and Wt
// 16-byte aligned, lda, ldw and K multiples of 4), else on gemm_nt.
inline cudaError_t gemm_nt_wide(const float* A, long long lda, const float* Wt, long long ldw,
                                float* C, long long ldc, int M, int N, int K,
                                cudaStream_t stream) {
  if (lda % 4 || ldw % 4 || K % 4 || ((uintptr_t)A & 15u) || ((uintptr_t)Wt & 15u))
    return gemm_nt(A, lda, Wt, ldw, C, ldc, M, N, K, stream);
  const dim3 grid((N + kWideBN - 1) / kWideBN, (M + kWideBM - 1) / kWideBM);
  gemm_nt_wide_kernel<<<grid, kWideThreads, 0, stream>>>(A, lda, Wt, ldw, C, ldc, M, N, K);
  return cudaGetLastError();
}

constexpr int kMmaBM = 64;   // block tile rows (M)
constexpr int kMmaBN = 64;   // block tile columns (N)
constexpr int kMmaBK = 32;   // contraction depth per shared-memory stage
constexpr int kMmaPad = 8;   // row padding: fragment loads hit 32 banks
constexpr int kMmaThreads = 128;  // 4 warps in 2 x 2, each a 32 x 32 tile

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Eight contraction-consecutive elements of row `row`, from column k, as
// bf16 packed in a uint4. kVec: one or two 16-byte loads (the caller has
// checked alignment and that K is a multiple of 8); else element by element
// with the ragged edge zeroed.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ P, long long ld,
                                            long long row, long long rows,
                                            long long k, int K) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || k >= K) return out;
  const T* p = P + row * ld + k;
  if constexpr (kVec) {
    if constexpr (sizeof(T) == 2) {
      out = *reinterpret_cast<const uint4*>(p);
    } else {
      const float4 lo = *reinterpret_cast<const float4*>(p);
      const float4 hi = *reinterpret_cast<const float4*>(p + 4);
      out = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                       pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    }
  } else {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16 a = k + 2 * j < K ? to_bf16(p[2 * j]) : __float2bfloat16_rn(0.f);
      const bf16 b = k + 2 * j + 1 < K ? to_bf16(p[2 * j + 1]) : __float2bfloat16_rn(0.f);
      w[j] = pack_bf16(a, b);
    }
    out = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return out;
}

// D = A * B + D for one 16 x 8 x 16 tile: A row-major 16 x 16, B given as
// columns (k-contiguous), fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 tile: each block a 64 x 64 output tile of 4 warps; each warp 32 x 32
// of it as 2 x 4 mma tiles of 16 x 8, over 32-deep contraction slices
// double-buffered through registers. Fragment layouts are those of the PTX
// ISA for m16n8k16 (.bf16): with g = lane / 4 and t = lane % 4, A's
// registers hold rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9;
// B's hold column g, rows 2t, 2t + 1 and 2t + 8, 2t + 9; C's rows g and
// g + 8, columns 2t, 2t + 1. An operand is staged in one of two shared
// layouts:
// - "k-major" (kT false): rows of the tile's output axis, contraction
//   contiguous, read by 32-bit fragment loads (both operands of the
//   forward's NT product);
// - "transposed" (kT true): rows of the contraction, output axis
//   contiguous, as it lies in memory for the backward's NN W and both of
//   its TN operands; its fragments come from ldmatrix .trans, so no element
//   is transposed by hand.
// Each thread stages two 8-element chunks of each operand a slice, rounded
// to bf16 (load_chunk): k-major chunk c covers output row c / 4,
// contraction 8 (c % 4) + [0, 8); transposed chunk c covers contraction row
// c / 8, output 8 (c % 8) + [0, 8).
constexpr int kMmaRowK = kMmaBK + kMmaPad;  // bf16 a k-major row
constexpr int kMmaRowT = kMmaBM + kMmaPad;  // bf16 a transposed row (16-byte multiple)

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// A's fragment of the 16 x 16 tile at rows [m, m + 16), contraction [ks, ks +
// 16), from shared memory staged with rows of ld bf16: transposed (kAT,
// rows of the contraction) through ldmatrix .trans, else k-major.
template <bool kAT>
__device__ __forceinline__ void mma_frag_a(uint32_t (&a)[4], const bf16* S, int ld, int ks,
                                           int m) {
  const int lane = threadIdx.x % 32;
  if constexpr (kAT) {
    // Matrices (rows m, columns k): [0, 8) x [0, 8), [8, 16) x [0, 8),
    // [0, 8) x [8, 16), [8, 16) x [8, 16); lane l addresses row l % 8
    // of matrix l / 8.
    ldsm_x4_trans(a, S + (ks + (lane / 16) * 8 + lane % 8) * ld + m + ((lane / 8) % 2) * 8);
  } else {
    const bf16* r0 = S + (m + lane / 4) * ld + ks + 2 * (lane % 4);
    a[0] = ld_pair(r0);
    a[1] = ld_pair(r0 + 8 * ld);
    a[2] = ld_pair(r0 + 8);
    a[3] = ld_pair(r0 + 8 * ld + 8);
  }
}

// B's fragments of the two 16 x 8 tiles at columns [n, n + 8) and [n + 8,
// n + 16), contraction [ks, ks + 16), staged as kBT says (as mma_frag_a).
template <bool kBT>
__device__ __forceinline__ void mma_frag_b(uint32_t (&b0)[2], uint32_t (&b1)[2], const bf16* S,
                                           int ld, int ks, int n) {
  const int lane = threadIdx.x % 32;
  if constexpr (kBT) {
    // Matrices (rows k, columns n): [0, 8) and [8, 16) of tile n, then of
    // tile n + 8.
    uint32_t r[4];
    ldsm_x4_trans(r, S + (ks + ((lane / 8) % 2) * 8 + lane % 8) * ld + n + (lane / 16) * 8);
    b0[0] = r[0];
    b0[1] = r[1];
    b1[0] = r[2];
    b1[1] = r[3];
  } else {
    const bf16* c0 = S + (n + lane / 4) * ld + ks + 2 * (lane % 4);
    b0[0] = ld_pair(c0);
    b0[1] = ld_pair(c0 + 8);
    b1[0] = ld_pair(c0 + 8 * ld);
    b1[1] = ld_pair(c0 + 8 * ld + 8);
  }
}

template <typename T, bool kT, bool kVec>
__device__ __forceinline__ void mma_load(uint4 (&r)[2], const T* __restrict__ P, long long ld,
                                         long long o0, int O, long long k0, int kend) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    if constexpr (kT) {
      r[i] = load_chunk<T, kVec>(P, ld, k0 + c / 8, kend, o0 + (c % 8) * 8, O);
    } else {
      r[i] = load_chunk<T, kVec>(P, ld, o0 + c / 4, O, k0 + (c % 4) * 8, kend);
    }
  }
}

template <bool kT>
__device__ __forceinline__ void mma_store(bf16* S, const uint4 (&r)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    bf16* p = kT ? S + (c / 8) * kMmaRowT + (c % 8) * 8 : S + (c / 4) * kMmaRowK + (c % 4) * 8;
    *reinterpret_cast<uint4*>(p) = r[i];
  }
}

// acc (2 x 4 mma tiles of 16 x 8 a warp) += A B over contraction rows
// [kbeg, kend) for the block tile at (m0, n0): A (M x K) and B (K x N) as
// kAT / kBT say (rows of lda / ldb).
template <typename TA, typename TB, bool kAT, bool kBT, bool kVec>
__device__ __forceinline__ void mma_tile(const TA* __restrict__ A, long long lda,
                                         const TB* __restrict__ B, long long ldb, int M, int N,
                                         long long kbeg, int kend, long long m0, long long n0,
                                         float (&acc)[2][4][4]) {
  constexpr int kARows = kAT ? kMmaBK : kMmaBM;
  constexpr int kBRows = kBT ? kMmaBK : kMmaBN;
  constexpr int kARow = kAT ? kMmaRowT : kMmaRowK;
  constexpr int kBRow = kBT ? kMmaRowT : kMmaRowK;
  __shared__ __align__(16) bf16 As[2][kARows * kARow];
  __shared__ __align__(16) bf16 Bs[2][kBRows * kBRow];
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  uint4 ra[2];
  uint4 rb[2];
  auto load = [&](long long k0) {
    mma_load<TA, kAT, kVec>(ra, A, lda, m0, M, k0, kend);
    mma_load<TB, kBT, kVec>(rb, B, ldb, n0, N, k0, kend);
  };
  auto store = [&](int buf) {
    mma_store<kAT>(As[buf], ra);
    mma_store<kBT>(Bs[buf], rb);
  };

  load(kbeg);
  store(0);
  __syncthreads();
  int buf = 0;
  for (long long k0 = kbeg; k0 < kend; k0 += kMmaBK) {
    const bool more = k0 + kMmaBK < kend;
    if (more) load(k0 + kMmaBK);  // in flight while this slice is multiplied
#pragma unroll
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      uint32_t a[2][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_frag_a<kAT>(a[mi], As[buf], kARow, ks, wm + mi * 16);
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2)
        mma_frag_b<kBT>(b[ni], b[ni + 1], Bs[buf], kBRow, ks, wn + ni * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    // The other buffer was last read before the previous barrier.
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
}

// Calls f(row, col, value) for each of this thread's accumulators of the
// block tile at (m0, n0).
template <typename F>
__device__ __forceinline__ void mma_each(const float (&acc)[2][4][4], long long m0,
                                         long long n0, F f) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(m0 + (warp / 2) * 32 + mi * 16 + lane / 4 + (e / 2) * 8,
          n0 + (warp % 2) * 32 + ni * 8 + 2 * (lane % 4) + e % 2, acc[mi][ni][e]);
}

// NT on tensor cores: C = A Wt^T, A and Wt rounded to bf16.
template <typename TA, typename TC, bool kVec>
__global__ void __launch_bounds__(kMmaThreads)
    gemm_nt_bf16_kernel(const TA* __restrict__ A, long long lda,
                        const bf16* __restrict__ Wt, long long ldw,
                        TC* __restrict__ C, long long ldc, int M, int N, int K) {
  const long long m0 = (long long)blockIdx.y * kMmaBM;
  const long long n0 = (long long)blockIdx.x * kMmaBN;
  float acc[2][4][4] = {};
  mma_tile<TA, bf16, false, false, kVec>(A, lda, Wt, ldw, M, N, 0, K, m0, n0, acc);
  mma_each(acc, m0, n0, [&](long long row, long long col, float v) {
    if (row < M && col < N) C[row * ldc + col] = from_f32<TC>(v);
  });
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The 16-byte path needs 16-byte aligned bases and rows (lda, ldw multiples
// of 8 elements) and K a multiple of 8; other shapes (dt_proj at some
// widths) take the element-wise path.
template <typename TA, typename TC>
cudaError_t gemm_nt_bf16(const TA* A, long long lda, const bf16* Wt,
                         long long ldw, TC* C, long long ldc, int M, int N,
                         int K, cudaStream_t stream) {
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
  const bool vec = aligned16(A) && aligned16(Wt) && lda % 8 == 0 &&
                   ldw % 8 == 0 && K % 8 == 0;
  if (vec) {
    gemm_nt_bf16_kernel<TA, TC, true><<<grid, kMmaThreads, 0, stream>>>(
        A, lda, Wt, ldw, C, ldc, M, N, K);
  } else {
    gemm_nt_bf16_kernel<TA, TC, false><<<grid, kMmaThreads, 0, stream>>>(
        A, lda, Wt, ldw, C, ldc, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace vmt
