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
// multiply). The bf16 tile (mma_tile, which the backward's NN and TN
// products in mixer_bwd.cuh share, with their own operand layouts) double-
// buffers shared memory: each thread loads the next K slice into registers
// (16-byte loads where the operands are aligned) while the warps multiply
// the current one, so the loads' latency is hidden behind the mma. A TMA /
// wgmma design is later work.
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
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int g = lane / 4;
  const int t = lane % 4;

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
      for (int mi = 0; mi < 2; ++mi) {
        if constexpr (kAT) {
          // Matrices (rows m, columns k): [0, 8) x [0, 8), [8, 16) x [0, 8),
          // [0, 8) x [8, 16), [8, 16) x [8, 16); lane l addresses row l % 8
          // of matrix l / 8.
          ldsm_x4_trans(a[mi], &As[buf][(ks + (lane / 16) * 8 + lane % 8) * kARow + wm +
                                         mi * 16 + ((lane / 8) % 2) * 8]);
        } else {
          const bf16* r0 = &As[buf][(wm + mi * 16 + g) * kARow + ks + 2 * t];
          a[mi][0] = ld_pair(r0);
          a[mi][1] = ld_pair(r0 + 8 * kARow);
          a[mi][2] = ld_pair(r0 + 8);
          a[mi][3] = ld_pair(r0 + 8 * kARow + 8);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        if constexpr (kBT) {
          // Matrices (rows k, columns n): [0, 8) and [8, 16) of tile ni, then
          // of tile ni + 1.
          uint32_t r[4];
          ldsm_x4_trans(r, &Bs[buf][(ks + ((lane / 8) % 2) * 8 + lane % 8) * kBRow + wn +
                                    (ni + lane / 16) * 8]);
          b[ni][0] = r[0];
          b[ni][1] = r[1];
          b[ni + 1][0] = r[2];
          b[ni + 1][1] = r[3];
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const bf16* c0 = &Bs[buf][(wn + (ni + j) * 8 + g) * kBRow + ks + 2 * t];
            b[ni + j][0] = ld_pair(c0);
            b[ni + j][1] = ld_pair(c0 + 8);
          }
        }
      }
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
