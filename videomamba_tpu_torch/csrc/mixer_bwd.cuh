// The body of the fused Mamba-1 mixer backward (K6), shared by K6
// (mixer_bwd.cu) and the whole-block backward K7 (block_bwd.cu), with the
// product tiles both use. The math and the design are in mixer_bwd.cu's
// header note; this file holds the device pieces:
//
// - gemm_nn: NN FMA tile, C = A W with W row-major (K, N), A fp32 or bf16,
//   A rounded to bf16 while staged when kRound; its epilogue can form
//   (add + acc) silu'(pre) (K6's dcpre).
// - gemm_tn: TN FMA tile over contraction slices of kSplitRows rows, P^T Q
//   with both operands read along their rows (coalesced), each rounded to
//   bf16 while staged when kRound; slices summed in order by a second launch.
// - the conv backward (dx, dconv_state, dconv_w / dconv_b in ordered slices).
// - mixer_bwd_t: the whole K6 span, with row strides for x, z, g, dx and dz
//   so K7 can read x and z from its in_proj output and write dx and dz into
//   its dxz buffer, and (kY) the reverse walk's y output.
//
// No floating-point atomics anywhere: repeated runs are bit-identical.
#pragma once

#include "mixer_parts.cuh"
#include "scan_walk_bwd.cuh"

namespace {

using vmt::bf16;

constexpr int kSplitRows = 256;  // contraction rows per weight-gradient slice

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kRound>
__device__ __forceinline__ float stage(float v) {
  if constexpr (kRound) return round_bf16(v);
  return v;
}

__device__ __forceinline__ float dsilu(float pre) {
  const float sig = 1.f / (1.f + expf(-pre));
  return sig * (1.f + pre * (1.f - sig));
}

// NN tile: C[m, n] = sum_k A[m, k] W[k, n], A (M, K) rows of lda, W (K, N)
// rows of ldw; A rounded to bf16 while staged when kRound. With `add` and
// `pre` (both (M, N), ld ldc) the epilogue writes (add + acc) silu'(pre).
template <typename TA, typename TW, bool kRound>
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
      As[kk][r] = (gm < M && gk < K) ? stage<kRound>(vmt::to_f32(A[gm * lda + gk])) : 0.f;
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

template <typename TA, typename TW, bool kRound>
cudaError_t gemm_nn(const TA* A, long long lda, const TW* W, long long ldw,
                    float* C, long long ldc, const float* add, const float* pre,
                    int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + vmt::kTile - 1) / vmt::kTile, (M + vmt::kTile - 1) / vmt::kTile);
  gemm_nn_kernel<TA, TW, kRound><<<grid, 256, 0, s>>>(A, lda, W, ldw, C, ldc, add,
                                                      pre, M, N, K);
  return cudaGetLastError();
}

// TN tile over one contraction slice: part[z][i, j] = sum over rows m of
// slice z of P[m, i] Q[m, j]; P (K, I) rows of ldp, Q (K, J) rows of ldq,
// both rounded to bf16 while staged when kRound. Both operands are read
// along their rows, so every staging load is coalesced.
template <typename TP, typename TQ, bool kRound>
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
      Ps[kk][c] = (in_k && i0 + c < I) ? stage<kRound>(vmt::to_f32(P[gk * ldp + i0 + c])) : 0.f;
      Qs[kk][c] = (in_k && j0 + c < J) ? stage<kRound>(vmt::to_f32(Q[gk * ldq + j0 + c])) : 0.f;
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
template <typename TP, typename TQ, bool kRound>
cudaError_t gemm_tn(const TP* P, long long ldp, const TQ* Q, long long ldq,
                    float* out, float* part, int I, int J, int K, cudaStream_t s) {
  const int slices = tn_slices(K);
  const dim3 grid((J + vmt::kTile - 1) / vmt::kTile, (I + vmt::kTile - 1) / vmt::kTile,
                  slices);
  gemm_tn_kernel<TP, TQ, kRound><<<grid, 256, 0, s>>>(P, ldp, Q, ldq, part, I, J, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = (long long)I * J;
  sum_slices_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(part, slices,
                                                                    count, out);
  return cudaGetLastError();
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

// Per slice of kSplitRows rows (b, t flattened): part[z][k][d] = sum of
// dcpre[m, d] ctx(m, k, d) for the W taps, part[z][W][d] = sum of dcpre
// (the bias), with ctx the forward conv's input window.
template <typename TX>
__global__ void conv_dw_kernel(const float* __restrict__ dcpre,
                               const TX* __restrict__ x, long long ld_x,
                               const float* __restrict__ conv_state,
                               float* __restrict__ part, int batch, int L,
                               int D, int W) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const long long rows = (long long)batch * L;
  const long long mbeg = (long long)blockIdx.y * kSplitRows;
  const long long mend = min(rows, mbeg + kSplitRows);
  float acc[9] = {};  // W <= 8 taps + bias
  for (long long m = mbeg; m < mend; ++m) {
    const long long b = m / L;
    const long long t = m - b * L;
    const float g = dcpre[m * D + d];
    const TX* xb = x + b * L * ld_x;
    const float* st = conv_state + (b * D + d) * W;
    for (int k = 0; k < W; ++k) {
      const long long s = t + k - (W - 1);
      const float v = s >= 0 ? vmt::to_f32(xb[s * ld_x + d]) : st[W + s];
      acc[k] += g * v;
    }
    acc[W] += g;
  }
  for (int k = 0; k <= W; ++k) part[((long long)blockIdx.y * (W + 1) + k) * D + d] = acc[k];
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
  float* scratch;  // mixer_bwd_scratch_floats
  int batch, L, Di, W, R, N;
};

// fp32 scratch one call of mixer_bwd_t takes (in floats).
inline long long mixer_bwd_scratch_floats(int batch, int L, int Di, int W, int R, int N) {
  const long long rows = (long long)batch * L;
  const int P = R + 2 * N;
  const long long ncb = (Di + vmt::kBwdThreads - 1) / vmt::kBwdThreads;
  const long long slices = tn_slices(rows);
  long long wpart = slices * (long long)P * Di;
  wpart = wpart > slices * (long long)(W + 1) * Di ? wpart : slices * (long long)(W + 1) * Di;
  return 6 * rows * Di + 2 * rows * P + batch * ncb * L * 2LL * N +
         (long long)batch * Di * N + 2LL * batch * Di + wpart;
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
  const int ncb = (Di + vmt::kBwdThreads - 1) / vmt::kBwdThreads;
  const int slices = tn_slices(rows);
  float* cy_pre = io.scratch;
  float* cy = cy_pre + rd;
  float* delta = cy + rd;
  float* du = delta + rd;
  float* ddelta = du + rd;
  float* dcpre = ddelta + rd;
  float* x_dbl = dcpre + rd;
  float* dxdbl = x_dbl + rows * P;
  float* bc_part = dxdbl + rows * P;
  float* dA_part = bc_part + (long long)batch * ncb * L * 2 * N;
  float* dD_part = dA_part + (long long)batch * Di * N;
  float* db_part = dD_part + (long long)batch * Di;
  float* wpart = db_part + (long long)batch * Di;  // weight-gradient slices

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
  a.dA_part = dA_part;
  a.dD_part = dD_part;
  a.dbias_part = db_part;
  a.dh0 = io.dh0;
  a.y = io.y;
  a.ld_y = Di;
  a.L = L;
  a.D = Di;
  a.softplus = 1;
  err = vmt::launch_scan_bwd<float, TX, float, kY>(a, batch, N, io.dA, io.dD,
                                                   io.ddt_bias, s);
  if (err != cudaSuccess) return err;
  err = vmt::launch_reduce_bc<float>(bc_part, batch, Di, L, N, dxdbl + R, P,
                                     dxdbl + R + N, P, s);
  if (err != cudaSuccess) return err;

  // dxdbl[:, :R] = ddelta_raw Wdt;  dcpre = (du + dxdbl Wx) silu'(cy_pre).
  err = gemm_nn<float, TW, kBf16W>(ddelta, Di, (const TW*)io.dt_proj_w, R, dxdbl, P,
                                   nullptr, nullptr, (int)rows, R, Di, s);
  if (err != cudaSuccess) return err;
  err = gemm_nn<float, TW, kBf16W>(dxdbl, P, (const TW*)io.x_proj_w, Di, dcpre, Di, du,
                                   cy_pre, (int)rows, Di, P, s);
  if (err != cudaSuccess) return err;

  const dim3 grid_rows((unsigned)(((long long)L * Di + 255) / 256), batch);
  conv_dx_kernel<TX, TW><<<grid_rows, 256, 0, s>>>(dcpre, (const TW*)io.conv_w,
                                                   (TX*)io.dx, io.ld_dx, L, Di, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_dstate_kernel<TW><<<(unsigned)(((long long)batch * Di + 255) / 256), 256, 0, s>>>(
      dcpre, (const TW*)io.conv_w, io.dconv_state, batch, L, Di, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_dw_kernel<TX><<<dim3((Di + 127) / 128, slices), 128, 0, s>>>(
      dcpre, (const TX*)io.x, io.ld_x, io.conv_state, wpart, batch, L, Di, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_dw_sum_kernel<<<(unsigned)(((long long)(W + 1) * Di + 255) / 256), 256, 0, s>>>(
      wpart, slices, Di, W, io.dconv_w, io.dconv_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // dWx (P, Di) = dxdbl^T cy;  dWdt (Di, R) = ddelta_raw^T x_dbl[:, :R].
  err = gemm_tn<float, float, kBf16W>(dxdbl, P, cy, Di, io.dx_proj_w, wpart, P, Di,
                                      (int)rows, s);
  if (err != cudaSuccess) return err;
  return gemm_tn<float, float, kBf16W>(ddelta, Di, x_dbl, P, io.ddt_proj_w, wpart, Di,
                                       R, (int)rows, s);
}

}  // namespace
