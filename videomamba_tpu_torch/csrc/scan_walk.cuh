// Selective-scan time walk shared by the selective-scan kernel
// (selective_scan.cu) and the last stage of the fused mixer (mixer_fused.cu).
//
// Recurrence per (batch b, channel d, state n), all in fp32:
//   dt     = softplus(delta[t, d] + delta_bias[d])     (softplus optional)
//   h[n]   = exp(dt * A[d, n]) * h[n] + dt * u[t, d] * B[t, n]
//   y[t,d] = (sum_n C[t, n] * h[n] + Dskip[d] * u[t, d]) * silu(z[t, d])
// z may be rounded to bf16 first (round_z), as the whole-block kernel's bf16
// path stores the gate input (videomamba_tpu/ops/pallas/block_fused.py:427).
//
// One thread owns one channel and keeps its N states in registers for the
// whole walk, so the state never touches device memory between steps. A
// block of kScanThreads channels stages a tile of kScanTile time steps in
// shared memory before walking it: B_t and C_t are shared by every channel of
// the batch row and are read once per block; u, delta and z are staged so
// that the tile's loads are all in flight together instead of one step's
// load latency per step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace vmt {

constexpr int kScanThreads = 128;  // channels per block
constexpr int kScanTile = 16;      // time steps staged per tile

// Every (B, L, F) operand is a set of rows with unit element stride: row t of
// batch b starts at ptr + (b * L + t) * ld.
struct ScanArgs {
  const float* u;
  long long ld_u;
  const float* delta;
  long long ld_delta;
  const float* z;  // may be null: no gate
  long long ld_z;
  const float* B;
  long long ld_B;
  const float* C;
  long long ld_C;
  const float* A;           // (D, N)
  const float* Dskip;       // (D,), may be null
  const float* delta_bias;  // (D,), may be null
  const float* h0;          // (batch, D, N)
  float* y;
  long long ld_y;
  float* h_last;  // (batch, D, N)
  int L;
  int D;
  int softplus;
  int round_z = 0;  // round z to bf16 before the gate
};

// log(1 + exp(x)) in the overflow-safe form of jax.nn.softplus
// (logaddexp(x, 0)).
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Walks batch row blockIdx.y, channels blockIdx.x * kScanThreads + [0, 128).
// Must be called by all kScanThreads threads of the block (it synchronises).
// kRoundZ is a template argument, and z is rounded where it is used, not
// where the tile is staged: a runtime test in the staging loop slowed the
// fp32 walk by 29% at VideoMamba-Base (H100).
template <int N, bool kRoundZ>
__device__ __forceinline__ void scan_walk(const ScanArgs& a) {
  __shared__ float sU[kScanTile][kScanThreads];
  __shared__ float sDt[kScanTile][kScanThreads];
  __shared__ float sZ[kScanTile][kScanThreads];
  __shared__ float sB[kScanTile][N];
  __shared__ float sC[kScanTile][N];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kScanThreads + tid;
  const bool active = d < a.D;
  const long long b = blockIdx.y;
  const long long L = a.L;
  const bool has_z = a.z != nullptr;

  float h[N];
  float A[N];
  float dskip = 0.f;
  float dbias = 0.f;
  if (active) {
    const float* h0 = a.h0 + (b * a.D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = h0[n];
      A[n] = a.A[(long long)d * N + n];
    }
    if (a.Dskip) dskip = a.Dskip[d];
    if (a.delta_bias) dbias = a.delta_bias[d];
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = 0.f;
      A[n] = 0.f;
    }
  }

  const float* u_b = a.u + b * L * a.ld_u;
  const float* dt_b = a.delta + b * L * a.ld_delta;
  const float* z_b = has_z ? a.z + b * L * a.ld_z : nullptr;
  const float* B_b = a.B + b * L * a.ld_B;
  const float* C_b = a.C + b * L * a.ld_C;
  float* y_b = a.y + b * L * a.ld_y;

  for (long long t0 = 0; t0 < L; t0 += kScanTile) {
    const int steps = (int)min((long long)kScanTile, L - t0);
    __syncthreads();  // the previous tile has been consumed
    if (active) {
      for (int k = 0; k < steps; ++k) {
        const long long t = t0 + k;
        sU[k][tid] = u_b[t * a.ld_u + d];
        sDt[k][tid] = dt_b[t * a.ld_delta + d];
        if (has_z) sZ[k][tid] = z_b[t * a.ld_z + d];
      }
    }
    for (int i = tid; i < steps * N; i += kScanThreads) {
      const int k = i / N;
      const int n = i - k * N;
      sB[k][n] = B_b[(t0 + k) * a.ld_B + n];
      sC[k][n] = C_b[(t0 + k) * a.ld_C + n];
    }
    __syncthreads();

    for (int k = 0; k < steps; ++k) {
      float dt = sDt[k][tid] + dbias;
      if (a.softplus) dt = softplus_f(dt);
      const float uu = sU[k][tid];
      const float du = dt * uu;
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dt * A[n]) * h[n] + du * sB[k][n];
        yv += sC[k][n] * h[n];
      }
      yv += uu * dskip;
      if (has_z) {
        float zz = sZ[k][tid];
        if constexpr (kRoundZ) zz = __bfloat162float(__float2bfloat16_rn(zz));
        yv *= zz * (1.f / (1.f + expf(-zz)));
      }
      if (active) y_b[(t0 + k) * a.ld_y + d] = yv;
    }
  }

  if (active) {
    float* hl = a.h_last + (b * a.D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hl[n] = h[n];
  }
}

template <int N, bool kRoundZ>
__global__ void __launch_bounds__(kScanThreads) scan_walk_kernel(ScanArgs a) {
  scan_walk<N, kRoundZ>(a);
}

template <int N>
void launch_walk_n(const ScanArgs& a, dim3 grid, cudaStream_t stream) {
  if (a.round_z) {
    scan_walk_kernel<N, true><<<grid, kScanThreads, 0, stream>>>(a);
  } else {
    scan_walk_kernel<N, false><<<grid, kScanThreads, 0, stream>>>(a);
  }
}

// Launches the walk over grid (ceil(D / kScanThreads), batch) for the state
// sizes the library is built for (N in {8, 16, 32, 64}).
inline cudaError_t launch_scan_walk(const ScanArgs& a, int batch, int n,
                                    cudaStream_t stream) {
  const dim3 grid((a.D + kScanThreads - 1) / kScanThreads, batch);
  switch (n) {
    case 8:
      launch_walk_n<8>(a, grid, stream);
      break;
    case 16:
      launch_walk_n<16>(a, grid, stream);
      break;
    case 32:
      launch_walk_n<32>(a, grid, stream);
      break;
    case 64:
      launch_walk_n<64>(a, grid, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace vmt
