// Fused Mamba-1 mixer core for Hopper: everything between in_proj and
// out_proj.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/mixer_fused.py
// (mixer_fused_pallas -> _mixer_fused_jit -> _mixer_kernel /
// _mixer_kernel_pipelined):
//   conv_out = silu(causal depthwise conv over [conv_state[..., 1:] || x] + b)
//   x_dbl    = conv_out @ W_x^T                     (dt | B | C columns)
//   delta    = x_dbl[:, :R] @ W_dt^T
//   y, h     = selective scan walk (softplus(delta + dt_bias), D-skip,
//              silu(z) gate), the walk of scan_walk.cuh
//
// On the TPU one kernel holds all of this, because the x_proj contraction
// crosses every channel while the walk is parallel over channels and VMEM
// holds a whole time block of both. On Hopper a block sees 227 KB of shared
// memory, so the span runs as four launches on one stream: conv, two
// products, walk. conv_out, x_dbl and delta make one round trip through
// device memory each (about 20 MB at VideoMamba-Base, batch 1).
//
// What bounds it on the H100: the walk, which is latency-bound at batch 1
// (see selective_scan.cu). The products are small (0.2 GFLOP each at Base)
// and run as plain fp32 FMA tiles; the conv is one memory pass.
#include "scan_walk.cuh"

namespace {

// conv_out[b, t, d] = silu(bias[d] + sum_k w[d, k] * ctx[b, t + k, d]) where
// ctx is x preceded by the last W - 1 raw inputs held in conv_state.
__global__ void conv_silu_kernel(const float* __restrict__ x, long long ld_x,
                                 const float* __restrict__ conv_state,
                                 const float* __restrict__ w,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, int L, int D, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)L * D) return;
  const long long b = blockIdx.y;
  const int d = (int)(i % D);
  const long long t = i / D;
  const float* xb = x + b * L * ld_x;
  const float* st = conv_state + (b * D + d) * W;
  float acc = 0.f;
  for (int k = 0; k < W; ++k) {
    const long long s = t + k - (W - 1);
    const float v = s >= 0 ? xb[s * ld_x + d] : st[W + s];
    acc += w[(long long)d * W + k] * v;
  }
  acc += bias[d];
  out[(b * L + t) * D + d] = acc * (1.f / (1.f + expf(-acc)));
}

constexpr int kTile = 64;   // output tile edge
constexpr int kTileK = 16;  // contraction depth per shared-memory stage

// C[m, n] = sum_k A[m, k] * W[n, k]: both operands contraction-contiguous,
// the layout of a torch Linear weight (out, in). 256 threads, each 4 x 4
// outputs of a 64 x 64 tile, fp32 FMA in contraction order.
__global__ void __launch_bounds__(256)
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

cudaError_t gemm_nt(const float* A, long long lda, const float* Wt,
                    long long ldw, float* C, long long ldc, int M, int N,
                    int K, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  gemm_nt_kernel<<<grid, 256, 0, stream>>>(A, lda, Wt, ldw, C, ldc, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x, z: (batch, L, Di) rows of stride ld_x / ld_z; conv_state (batch, Di, W),
// conv_w (Di, W), conv_b (Di,), x_proj_w (R + 2N, Di), dt_proj_w (Di, R),
// dt_bias, Dskip (Di,), A (Di, N), h0 / h_last (batch, Di, N), y (batch, L,
// Di): all fp32 and contiguous. conv_out and delta (batch * L * Di) and x_dbl
// (batch * L * (R + 2N)) are fp32 scratch the caller allocates.
extern "C" int vmt_mixer_fused(
    const float* x, long long ld_x, const float* z, long long ld_z,
    const float* conv_state, const float* conv_w, const float* conv_b,
    const float* x_proj_w, const float* dt_proj_w, const float* dt_bias,
    const float* A, const float* Dskip, const float* h0, float* y,
    float* h_last, float* conv_out, float* x_dbl, float* delta, int batch,
    int L, int Di, int W, int R, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)batch * L;
  const int P = R + 2 * N;

  const long long per_batch = (long long)L * Di;
  const dim3 conv_grid((unsigned)((per_batch + 255) / 256), batch);
  conv_silu_kernel<<<conv_grid, 256, 0, s>>>(x, ld_x, conv_state, conv_w,
                                             conv_b, conv_out, L, Di, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = gemm_nt(conv_out, Di, x_proj_w, Di, x_dbl, P, (int)rows, P, Di, s);
  if (err != cudaSuccess) return (int)err;
  err = gemm_nt(x_dbl, P, dt_proj_w, R, delta, Di, (int)rows, Di, R, s);
  if (err != cudaSuccess) return (int)err;

  vmt::ScanArgs a;
  a.u = conv_out;
  a.ld_u = Di;
  a.delta = delta;
  a.ld_delta = Di;
  a.z = z;
  a.ld_z = ld_z;
  a.B = x_dbl + R;
  a.ld_B = P;
  a.C = x_dbl + R + N;
  a.ld_C = P;
  a.A = A;
  a.Dskip = Dskip;
  a.delta_bias = dt_bias;
  a.h0 = h0;
  a.y = y;
  a.ld_y = Di;
  a.h_last = h_last;
  a.L = L;
  a.D = Di;
  a.softplus = 1;
  return (int)vmt::launch_scan_walk(a, batch, N, s);
}
