// The body of the fused Mamba-1 mixer backward (K6), shared by K6
// (mixer_bwd.cu) and the whole-block backward K7 (block_bwd.cu), with the
// product tiles both use. The math and the design are in mixer_bwd.cu's
// header note; this file holds the device pieces:
//
// - gemm_nn / gemm_tn: fp32 FMA tiles, the fp32 path. NN: C = A W with W
//   row-major (K, N); its epilogue can form (add + acc) silu'(pre) (K6's
//   dcpre). TN: P^T Q over contraction slices of kSplitRows rows, both
//   operands read along their rows (coalesced); slices summed in order by a
//   second launch.
// - mma_nn / mma_tn: the same two products on bf16 tensor cores, the
//   bf16-weight path, on mixer_parts.cuh's mma_tile (the tile of the
//   forward's NT product, with W and the TN operands staged transposed):
//   each operand is rounded to bf16 while staged, where the TPU kernels
//   round each product's inputs, so only the order of the fp32 sums differs
//   from the FMA tiles.
// - the conv backward (dx, dconv_state, dconv_w / dconv_b in ordered slices).
// - mixer_bwd_t: the whole K6 span, with row strides for x, z, g, dx and dz
//   so K7 can read x and z from its in_proj output and write dx and dz into
//   its dxz buffer, and (kY) the reverse walk's y output. Its reverse walk
//   is the time-split walk of scan_walk_split_bwd.cuh.
//
// No floating-point atomics anywhere: repeated runs are bit-identical.
#pragma once

#include "mixer_parts.cuh"
#include "scan_walk_split_bwd.cuh"

namespace {

using vmt::bf16;

constexpr int kSplitRows = 256;  // contraction rows per weight-gradient slice

__device__ __forceinline__ float dsilu(float pre) {
  const float sig = 1.f / (1.f + expf(-pre));
  return sig * (1.f + pre * (1.f - sig));
}

// NN tile: C[m, n] = sum_k A[m, k] W[k, n], A (M, K) rows of lda, W (K, N)
// rows of ldw. With `add` and `pre` (both (M, N), ld ldc) the epilogue
// writes (add + acc) silu'(pre).
template <typename TA, typename TW>
__global__ void __launch_bounds__(256)
    gemm_nn_kernel(const TA* __restrict__ A, long long lda,
                   const TW* __restrict__ W, long long ldw,
                   float* __restrict__ C, long long ldc,
                   const float* __restrict__ add, const float* __restrict__ pre,
                   int M, int N, int K) {
  __shared__ float As[vmt::kTileK][vmt::kTile + 4];
  __shared__ float Ws[vmt::kTileK][vmt::kTile + 4];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.y * vmt::kTile;
  const long long n0 = (long long)blockIdx.x * vmt::kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += vmt::kTileK) {
    for (int i = threadIdx.x; i < vmt::kTile * vmt::kTileK; i += 256) {
      const int r = i / vmt::kTileK;
      const int kk = i % vmt::kTileK;
      const long long gm = m0 + r;
      const long long gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? vmt::to_f32(A[gm * lda + gk]) : 0.f;
      const int c = i % vmt::kTile;
      const int kw = i / vmt::kTile;
      const long long gn = n0 + c;
      const long long gkw = k0 + kw;
      Ws[kw][c] = (gn < N && gkw < K) ? vmt::to_f32(W[gkw * ldw + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < vmt::kTileK; ++kk) {
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
      if (n >= N) continue;
      const long long o = m * ldc + n;
      C[o] = add ? (add[o] + acc[i][j]) * dsilu(pre[o]) : acc[i][j];
    }
  }
}

template <typename TA, typename TW>
cudaError_t gemm_nn(const TA* A, long long lda, const TW* W, long long ldw,
                    float* C, long long ldc, const float* add, const float* pre,
                    int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + vmt::kTile - 1) / vmt::kTile, (M + vmt::kTile - 1) / vmt::kTile);
  gemm_nn_kernel<TA, TW><<<grid, 256, 0, s>>>(A, lda, W, ldw, C, ldc, add, pre, M, N, K);
  return cudaGetLastError();
}

// TN tile over one contraction slice: part[z][i, j] = sum over rows m of
// slice z of P[m, i] Q[m, j]; P (K, I) rows of ldp, Q (K, J) rows of ldq.
// Both operands are read along their rows, so every staging load is
// coalesced.
template <typename TP, typename TQ>
__global__ void __launch_bounds__(256)
    gemm_tn_kernel(const TP* __restrict__ P, long long ldp,
                   const TQ* __restrict__ Q, long long ldq,
                   float* __restrict__ part, int I, int J, int K) {
  __shared__ float Ps[vmt::kTileK][vmt::kTile + 4];
  __shared__ float Qs[vmt::kTileK][vmt::kTile + 4];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long i0 = (long long)blockIdx.y * vmt::kTile;
  const long long j0 = (long long)blockIdx.x * vmt::kTile;
  const long long kbeg = (long long)blockIdx.z * kSplitRows;
  const long long kend = min((long long)K, kbeg + kSplitRows);
  float acc[4][4] = {};
  for (long long k0 = kbeg; k0 < kend; k0 += vmt::kTileK) {
    for (int e = threadIdx.x; e < vmt::kTile * vmt::kTileK; e += 256) {
      const int c = e % vmt::kTile;
      const int kk = e / vmt::kTile;
      const long long gk = k0 + kk;
      const bool in_k = gk < kend;
      Ps[kk][c] = (in_k && i0 + c < I) ? vmt::to_f32(P[gk * ldp + i0 + c]) : 0.f;
      Qs[kk][c] = (in_k && j0 + c < J) ? vmt::to_f32(Q[gk * ldq + j0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < vmt::kTileK; ++kk) {
      float pv[4];
      float qv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = Ps[kk][ty * 4 + a];
#pragma unroll
      for (int b = 0; b < 4; ++b) qv[b] = Qs[kk][tx * 4 + b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += pv[a] * qv[b];
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.z * I * J;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long i = i0 + ty * 4 + a;
    if (i >= I) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long j = j0 + tx * 4 + b;
      if (j < J) out[i * J + j] = acc[a][b];
    }
  }
}

// out[e] = sum over s of part[s][e], in order.
__global__ void sum_slices_kernel(const float* __restrict__ part, int slices,
                                  long long count, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += part[s * count + e];
  out[e] = acc;
}

inline int tn_slices(long long K) { return (int)((K + kSplitRows - 1) / kSplitRows); }

// out (I, J) = P^T Q over K rows; part holds tn_slices(K) * I * J floats.
template <typename TP, typename TQ>
cudaError_t gemm_tn(const TP* P, long long ldp, const TQ* Q, long long ldq,
                    float* out, float* part, int I, int J, int K, cudaStream_t s) {
  const int slices = tn_slices(K);
  const dim3 grid((J + vmt::kTile - 1) / vmt::kTile, (I + vmt::kTile - 1) / vmt::kTile,
                  slices);
  gemm_tn_kernel<TP, TQ><<<grid, 256, 0, s>>>(P, ldp, Q, ldq, part, I, J, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = (long long)I * J;
  sum_slices_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(part, slices,
                                                                    count, out);
  return cudaGetLastError();
}

// NN on tensor cores: gemm_nn's contract, A and W rounded to bf16.
template <typename TA, typename TW, bool kVec>
__global__ void __launch_bounds__(vmt::kMmaThreads)
    mma_nn_kernel(const TA* __restrict__ A, long long lda, const TW* __restrict__ W,
                  long long ldw, float* __restrict__ C, long long ldc,
                  const float* __restrict__ add, const float* __restrict__ pre, int M, int N,
                  int K) {
  const long long m0 = (long long)blockIdx.y * vmt::kMmaBM;
  const long long n0 = (long long)blockIdx.x * vmt::kMmaBN;
  float acc[2][4][4] = {};
  vmt::mma_tile<TA, TW, false, true, kVec>(A, lda, W, ldw, M, N, 0, K, m0, n0, acc);
  vmt::mma_each(acc, m0, n0, [&](long long m, long long n, float v) {
    if (m >= M || n >= N) return;
    const long long o = m * ldc + n;
    C[o] = add ? (add[o] + v) * dsilu(pre[o]) : v;
  });
}

// TN on tensor cores over one contraction slice: gemm_tn_kernel's contract,
// P and Q rounded to bf16.
template <typename TP, typename TQ, bool kVec>
__global__ void __launch_bounds__(vmt::kMmaThreads)
    mma_tn_kernel(const TP* __restrict__ P, long long ldp, const TQ* __restrict__ Q,
                  long long ldq, float* __restrict__ part, int I, int J, int K) {
  const long long i0 = (long long)blockIdx.y * vmt::kMmaBM;
  const long long j0 = (long long)blockIdx.x * vmt::kMmaBN;
  const long long kbeg = (long long)blockIdx.z * kSplitRows;
  const int kend = (int)min((long long)K, kbeg + kSplitRows);
  float acc[2][4][4] = {};
  vmt::mma_tile<TP, TQ, true, true, kVec>(P, ldp, Q, ldq, I, J, kbeg, kend, i0, j0, acc);
  float* out = part + (long long)blockIdx.z * I * J;
  vmt::mma_each(acc, i0, j0, [&](long long i, long long j, float v) {
    if (i < I && j < J) out[i * J + j] = v;
  });
}

// The 16-byte staging path needs 16-byte aligned bases and rows and each
// contiguous extent a multiple of 8 elements; other shapes (dt_proj at some
// widths) stage element by element.
template <typename TA, typename TW>
cudaError_t mma_nn(const TA* A, long long lda, const TW* W, long long ldw, float* C,
                   long long ldc, const float* add, const float* pre, int M, int N, int K,
                   cudaStream_t s) {
  const dim3 grid((N + vmt::kMmaBN - 1) / vmt::kMmaBN, (M + vmt::kMmaBM - 1) / vmt::kMmaBM);
  if (vmt::aligned16(A) && vmt::aligned16(W) && lda % 8 == 0 && ldw % 8 == 0 && K % 8 == 0 &&
      N % 8 == 0) {
    mma_nn_kernel<TA, TW, true><<<grid, vmt::kMmaThreads, 0, s>>>(A, lda, W, ldw, C, ldc, add,
                                                                  pre, M, N, K);
  } else {
    mma_nn_kernel<TA, TW, false><<<grid, vmt::kMmaThreads, 0, s>>>(A, lda, W, ldw, C, ldc, add,
                                                                   pre, M, N, K);
  }
  return cudaGetLastError();
}

template <typename TP, typename TQ>
cudaError_t mma_tn(const TP* P, long long ldp, const TQ* Q, long long ldq, float* out,
                   float* part, int I, int J, int K, cudaStream_t s) {
  const int slices = tn_slices(K);
  const dim3 grid((J + vmt::kMmaBN - 1) / vmt::kMmaBN, (I + vmt::kMmaBM - 1) / vmt::kMmaBM,
                  slices);
  if (vmt::aligned16(P) && vmt::aligned16(Q) && ldp % 8 == 0 && ldq % 8 == 0 && I % 8 == 0 &&
      J % 8 == 0) {
    mma_tn_kernel<TP, TQ, true><<<grid, vmt::kMmaThreads, 0, s>>>(P, ldp, Q, ldq, part, I, J, K);
  } else {
    mma_tn_kernel<TP, TQ, false><<<grid, vmt::kMmaThreads, 0, s>>>(P, ldp, Q, ldq, part, I, J, K);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = (long long)I * J;
  sum_slices_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(part, slices, count, out);
  return cudaGetLastError();
}

// The backward spans' NN and TN products: tensor-core tiles at bf16
// weights, fp32 FMA tiles otherwise.
template <bool kBf16, typename TA, typename TW>
cudaError_t product_nn(const TA* A, long long lda, const TW* W, long long ldw, float* C,
                       long long ldc, const float* add, const float* pre, int M, int N, int K,
                       cudaStream_t s) {
  if constexpr (kBf16) {
    return mma_nn(A, lda, W, ldw, C, ldc, add, pre, M, N, K, s);
  } else {
    return gemm_nn(A, lda, W, ldw, C, ldc, add, pre, M, N, K, s);
  }
}

template <bool kBf16, typename TP, typename TQ>
cudaError_t product_tn(const TP* P, long long ldp, const TQ* Q, long long ldq, float* out,
                       float* part, int I, int J, int K, cudaStream_t s) {
  if constexpr (kBf16) {
    return mma_tn(P, ldp, Q, ldq, out, part, I, J, K, s);
  } else {
    return gemm_tn(P, ldp, Q, ldq, out, part, I, J, K, s);
  }
}

// dx[b, t, d] = sum_m w[d, W-1-m] dcpre[b, t+m, d] over t + m < L; dx rows
// of ld_dx.
template <typename TX, typename TW>
__global__ void conv_dx_kernel(const float* __restrict__ dcpre,
                               const TW* __restrict__ w, TX* __restrict__ dx,
                               long long ld_dx, int L, int D, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)L * D) return;
  const long long b = blockIdx.y;
  const int d = (int)(i % D);
  const long long t = i / D;
  const float* g = dcpre + b * L * D;
  float acc = 0.f;
  for (int m = 0; m < W && t + m < L; ++m)
    acc += vmt::to_f32(w[(long long)d * W + W - 1 - m]) * g[(t + m) * D + d];
  dx[(b * L + t) * ld_dx + d] = vmt::from_f32<TX>(acc);
}

// dconv_state[b, d, 0] = 0; dconv_state[b, d, r + 1] = sum_k w[d, k]
// dcpre[b, r - k, d] over 0 <= r - k < L (context rows 0 .. W-2 are
// conv_state rows 1 .. W-1).
template <typename TW>
__global__ void conv_dstate_kernel(const float* __restrict__ dcpre,
                                   const TW* __restrict__ w,
                                   float* __restrict__ dcst, int batch, int L,
                                   int D, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)batch * D) return;
  const long long b = i / D;
  const int d = (int)(i % D);
  float* o = dcst + i * W;
  o[0] = 0.f;
  for (int r = 0; r < W - 1; ++r) {
    float acc = 0.f;
    for (int k = 0; k <= r; ++k) {
      const int t = r - k;
      if (t < L) acc += vmt::to_f32(w[(long long)d * W + k]) * dcpre[(b * L + t) * D + d];
    }
    o[r + 1] = acc;
  }
}

constexpr int kDwTaps = 8;  // taps a block of the general conv_dw_kernel sums in registers

// Per slice of kSplitRows rows (b, t flattened): part[y][k][d] = sum of
// dcpre[m, d] ctx(m, k, d) for the W taps, part[y][W][d] = sum of dcpre
// (the bias), with ctx the forward conv's input window. kW is the conv width
// where it is fixed at compile time (4, every preset's); kW = 0 takes any
// width, kDwTaps taps a block from tap blockIdx.z * kDwTaps, so the sums
// stay in registers at any W. Each tap's sum runs over the rows in order in
// both forms, so repeats are bit-identical.
template <typename TX, int kW>
__global__ void conv_dw_kernel(const float* __restrict__ dcpre,
                               const TX* __restrict__ x, long long ld_x,
                               const float* __restrict__ conv_state,
                               float* __restrict__ part, int batch, int L,
                               int D, int W) {
  constexpr int kSlots = kW > 0 ? kW : kDwTaps;
  const int width = kW > 0 ? kW : W;
  const int k0 = kW > 0 ? 0 : blockIdx.z * kDwTaps;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const long long rows = (long long)batch * L;
  const long long mbeg = (long long)blockIdx.y * kSplitRows;
  const long long mend = min(rows, mbeg + kSplitRows);
  float acc[kSlots + 1] = {};  // the taps k0 .. k0 + kSlots - 1, then the bias
  for (long long m = mbeg; m < mend; ++m) {
    const long long b = m / L;
    const long long t = m - b * L;
    const float g = dcpre[m * D + d];
    const TX* xb = x + b * L * ld_x;
    const float* st = conv_state + (b * D + d) * width;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int k = k0 + j;
      if (kW > 0 || k < width) {
        const long long s = t + k - (width - 1);
        const float v = s >= 0 ? vmt::to_f32(xb[s * ld_x + d]) : st[width + s];
        acc[j] += g * v;
      }
    }
    acc[kSlots] += g;
  }
  float* out = part + (long long)blockIdx.y * (width + 1) * D + d;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (kW > 0 || k0 + j < width) out[(long long)(k0 + j) * D] = acc[j];
  }
  if (k0 == 0) out[(long long)width * D] = acc[kSlots];
}

// Sums the conv slices in order into dconv_w (D, W) and dconv_b (D,).
__global__ void conv_dw_sum_kernel(const float* __restrict__ part, int slices,
                                   int D, int W, float* __restrict__ dw,
                                   float* __restrict__ db) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)(W + 1) * D) return;
  const int k = (int)(e / D);
  const int d = (int)(e % D);
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += part[((long long)s * (W + 1) + k) * D + d];
  if (k < W) {
    dw[(long long)d * W + k] = acc;
  } else {
    db[d] = acc;
  }
}

// dconv_w (D, W) and dconv_b (D,) from dcpre (batch * L rows of D fp32), the
// conv's input x (rows of ld_x) and conv_state (batch, D, W) fp32; part holds
// tn_slices(batch * L) * (W + 1) * D floats. Any W >= 1.
template <typename TX>
cudaError_t launch_conv_dw(const float* dcpre, const TX* x, long long ld_x,
                           const float* conv_state, float* part, int batch, int L, int D,
                           int W, int threads, float* dw, float* db, cudaStream_t s) {
  const int slices = tn_slices((long long)batch * L);
  const unsigned cols = (unsigned)((D + threads - 1) / threads);
  if (W == 4) {
    conv_dw_kernel<TX, 4><<<dim3(cols, slices), threads, 0, s>>>(dcpre, x, ld_x, conv_state,
                                                                 part, batch, L, D, W);
  } else {
    conv_dw_kernel<TX, 0><<<dim3(cols, slices, (W + kDwTaps - 1) / kDwTaps), threads, 0, s>>>(
        dcpre, x, ld_x, conv_state, part, batch, L, D, W);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  conv_dw_sum_kernel<<<(unsigned)(((long long)(W + 1) * D + 255) / 256), 256, 0, s>>>(
      part, slices, D, W, dw, db);
  return cudaGetLastError();
}

// The span's operands; each (batch, L, .) operand is rows with the stride
// given (batch stride L times it).
struct MixerBwdIO {
  const void* x;
  long long ld_x;
  const void* z;
  long long ld_z;
  const float* conv_state;
  const void* conv_w;
  const void* conv_b;
  const void* x_proj_w;
  const void* dt_proj_w;
  const float* dt_bias;
  const float* A;
  const float* Dskip;
  const float* ckpt;
  const void* g;
  long long ld_g;
  const float* g_hlast;
  void* dx;
  long long ld_dx;
  void* dz;
  long long ld_dz;
  float* y;  // with kY: the forward's gated output (batch, L, Di), fp32
  float* dconv_w;
  float* dconv_b;
  float* dx_proj_w;
  float* ddt_proj_w;
  float* ddt_bias;
  float* dA;
  float* dD;
  float* dh0;
  float* dconv_state;
  float* scratch;  // mixer_bwd_scratch(...).total floats
  int batch, L, Di, W, R, N;
  int chunk;  // steps per chunk of the split reverse walk
};

inline long long align64(long long n) { return (n + 63) / 64 * 64; }

// Where mixer_bwd_t's fp32 scratch regions start (in floats, each 64-float
// aligned), and the total; chunk is the split reverse walk's.
struct MixerBwdScratch {
  long long carry, dtsum, act, x_dbl, dxdbl, bc_part, dA_part, dD_part, db_part, wpart, total;
};

inline MixerBwdScratch mixer_bwd_scratch(int batch, int L, int Di, int W, int R, int N,
                                         int chunk) {
  const long long rows = (long long)batch * L;
  const long long P = R + 2 * N;
  const long long ncb = (Di + vmt::kBwdThreads - 1) / vmt::kBwdThreads;
  const long long slices = tn_slices(rows);
  const long long nchunks = (L + chunk - 1) / chunk;
  MixerBwdScratch s;
  long long at = 0;
  auto take = [&](long long floats) {
    const long long o = at;
    at += align64(floats);
    return o;
  };
  s.carry = take(batch * (nchunks - 1) * Di * N);
  s.dtsum = take(batch * (nchunks - 1) * Di);
  s.act = take(6 * rows * Di);  // cy_pre, cy, delta, du, ddelta, dcpre
  s.x_dbl = take(rows * P);
  s.dxdbl = take(rows * P);
  s.bc_part = take(batch * ncb * L * 2 * N);
  s.dA_part = take(batch * nchunks * Di * N);
  s.dD_part = take(batch * nchunks * Di);
  s.db_part = take(batch * nchunks * Di);
  s.wpart = take(slices * Di * (P > W + 1 ? P : W + 1));  // weight-gradient slices
  s.total = at;
  return s;
}

// The K6 span. TX: x and z (and dx, dz, g); TW: the conv and projection
// weights; kY: also store the forward's gated output y (K7).
template <typename TX, typename TW, bool kY>
cudaError_t mixer_bwd_t(const MixerBwdIO& io, cudaStream_t s) {
  constexpr bool kBf16W = sizeof(TW) == 2;
  const int batch = io.batch, L = io.L, Di = io.Di, W = io.W, R = io.R, N = io.N;
  const int P = R + 2 * N;
  const long long rows = (long long)batch * L;
  const long long rd = rows * Di;
  const MixerBwdScratch at = mixer_bwd_scratch(batch, L, Di, W, R, N, io.chunk);
  float* cy_pre = io.scratch + at.act;
  float* cy = cy_pre + rd;
  float* delta = cy + rd;
  float* du = delta + rd;
  float* ddelta = du + rd;
  float* dcpre = ddelta + rd;
  float* x_dbl = io.scratch + at.x_dbl;
  float* dxdbl = io.scratch + at.dxdbl;
  float* bc_part = io.scratch + at.bc_part;
  float* wpart = io.scratch + at.wpart;

  cudaError_t err = vmt::conv_silu<TX, TW>((const TX*)io.x, io.ld_x, io.conv_state,
                                           (const TW*)io.conv_w, (const TW*)io.conv_b,
                                           cy, batch, L, Di, W, s, cy_pre);
  if (err != cudaSuccess) return err;
  if constexpr (kBf16W) {
    err = vmt::gemm_nt_bf16<float, float>(cy, Di, (const TW*)io.x_proj_w, Di, x_dbl,
                                          P, (int)rows, P, Di, s);
    if (err != cudaSuccess) return err;
    err = vmt::gemm_nt_bf16<float, float>(x_dbl, P, (const TW*)io.dt_proj_w, R, delta,
                                          Di, (int)rows, Di, R, s);
  } else {
    err = vmt::gemm_nt(cy, Di, (const float*)io.x_proj_w, Di, x_dbl, P, (int)rows,
                       P, Di, s);
    if (err != cudaSuccess) return err;
    err = vmt::gemm_nt(x_dbl, P, (const float*)io.dt_proj_w, R, delta, Di,
                       (int)rows, Di, R, s);
  }
  if (err != cudaSuccess) return err;

  vmt::ScanBwdArgs a;
  a.u = cy;
  a.ld_u = Di;
  a.delta = delta;
  a.ld_delta = Di;
  a.z = io.z;
  a.ld_z = io.ld_z;
  a.B = x_dbl + R;
  a.ld_B = P;
  a.C = x_dbl + R + N;
  a.ld_C = P;
  a.g = io.g;
  a.ld_g = io.ld_g;
  a.A = io.A;
  a.Dskip = io.Dskip;
  a.delta_bias = io.dt_bias;
  a.ckpt = io.ckpt;
  a.g_hlast = io.g_hlast;
  a.du = du;
  a.ld_du = Di;
  a.ddelta = ddelta;
  a.ld_ddelta = Di;
  a.dz = io.dz;
  a.ld_dz = io.ld_dz;
  a.bc_part = bc_part;
  a.dA_part = io.scratch + at.dA_part;
  a.dD_part = io.scratch + at.dD_part;
  a.dbias_part = io.scratch + at.db_part;
  a.dh0 = io.dh0;
  a.y = io.y;
  a.ld_y = Di;
  a.L = L;
  a.D = Di;
  a.softplus = 1;
  const vmt::SplitBwdArgs sp{io.scratch + at.carry, io.scratch + at.dtsum, io.chunk};
  err = vmt::launch_scan_bwd_split<float, TX, float, kY>(a, sp, batch, N, io.dA, io.dD,
                                                         io.ddt_bias, s);
  if (err != cudaSuccess) return err;
  err = vmt::launch_reduce_bc<float>(bc_part, batch, Di, L, N, dxdbl + R, P,
                                     dxdbl + R + N, P, s);
  if (err != cudaSuccess) return err;

  // dxdbl[:, :R] = ddelta_raw Wdt;  dcpre = (du + dxdbl Wx) silu'(cy_pre).
  err = product_nn<kBf16W>(ddelta, Di, (const TW*)io.dt_proj_w, R, dxdbl, P, nullptr,
                           nullptr, (int)rows, R, Di, s);
  if (err != cudaSuccess) return err;
  err = product_nn<kBf16W>(dxdbl, P, (const TW*)io.x_proj_w, Di, dcpre, Di, du, cy_pre,
                           (int)rows, Di, P, s);
  if (err != cudaSuccess) return err;

  const dim3 grid_rows((unsigned)(((long long)L * Di + 255) / 256), batch);
  conv_dx_kernel<TX, TW><<<grid_rows, 256, 0, s>>>(dcpre, (const TW*)io.conv_w,
                                                   (TX*)io.dx, io.ld_dx, L, Di, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_dstate_kernel<TW><<<(unsigned)(((long long)batch * Di + 255) / 256), 256, 0, s>>>(
      dcpre, (const TW*)io.conv_w, io.dconv_state, batch, L, Di, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_conv_dw<TX>(dcpre, (const TX*)io.x, io.ld_x, io.conv_state, wpart, batch, L,
                           Di, W, 128, io.dconv_w, io.dconv_b, s);
  if (err != cudaSuccess) return err;

  // dWx (P, Di) = dxdbl^T cy;  dWdt (Di, R) = ddelta_raw^T x_dbl[:, :R].
  err = product_tn<kBf16W>(dxdbl, P, cy, Di, io.dx_proj_w, wpart, P, Di, (int)rows, s);
  if (err != cudaSuccess) return err;
  return product_tn<kBf16W>(ddelta, Di, x_dbl, P, io.ddt_proj_w, wpart, Di, R, (int)rows, s);
}

}  // namespace
