// Selective-scan time walk shared by the selective-scan kernel
// (selective_scan.cu), the last stage of the fused mixer (mixer_fused.cu) and
// the whole-block kernel (block_fused.cu).
//
// Recurrence per (batch b, channel d, state n), all in fp32:
//   dt     = softplus(delta[t, d] + delta_bias[d])     (softplus optional)
//   h[n]   = exp(dt * A[d, n]) * h[n] + dt * u[t, d] * B[t, n]
//   y[t,d] = (sum_n C[t, n] * h[n] + Dskip[d] * u[t, d]) * silu(z[t, d])
// z may be rounded to bf16 first (round_z), as the whole-block kernel's bf16
// path stores the gate input (videomamba_tpu/ops/pallas/block_fused.py:427).
//
// Operand types are template arguments: TU for u, delta, B and C (fp32 or
// bf16, widened on load), TZ for z and TY for y. With kCkpt the walk also
// stores the state at the start of every kScanTile-step segment, in fp32, as
// ckpt[b][t / kScanTile][d][n]: the residual the reverse walk
// (scan_walk_bwd.cuh) rebuilds each segment from (K1, K3 and K4's training
// forward, whose backward is K7). The store sits at the tile
// boundary, outside the step loop, and is compile-time, like kRoundZ.
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

using bf16 = __nv_bfloat16;  // also declared (identically) in add_norm.cuh

constexpr int kScanThreads = 128;  // channels per block
constexpr int kScanTile = 16;      // time steps staged per tile = checkpoint segment

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Every (B, L, F) operand is a set of rows with unit element stride: row t of
// batch b starts at ptr + (b * L + t) * ld. Element types are fixed by the
// launcher's template arguments.
struct ScanArgs {
  const void* u;
  long long ld_u;
  const void* delta;
  long long ld_delta;
  const void* z;  // may be null: no gate
  long long ld_z;
  const void* B;
  long long ld_B;
  const void* C;
  long long ld_C;
  const float* A;           // (D, N)
  const float* Dskip;       // (D,), may be null
  const float* delta_bias;  // (D,), may be null
  const float* h0;          // (batch, D, N)
  void* y;
  long long ld_y;
  float* h_last;  // (batch, D, N)
  float* ckpt = nullptr;  // (batch, ceil(L / kScanTile), D, N) or null
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
template <int N, typename TU, typename TZ, typename TY, bool kRoundZ, bool kCkpt>
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
  const long long nseg = (L + kScanTile - 1) / kScanTile;

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

  const TU* u_b = (const TU*)a.u + b * L * a.ld_u;
  const TU* dt_b = (const TU*)a.delta + b * L * a.ld_delta;
  const TZ* z_b = has_z ? (const TZ*)a.z + b * L * a.ld_z : nullptr;
  const TU* B_b = (const TU*)a.B + b * L * a.ld_B;
  const TU* C_b = (const TU*)a.C + b * L * a.ld_C;
  TY* y_b = (TY*)a.y + b * L * a.ld_y;

  for (long long t0 = 0; t0 < L; t0 += kScanTile) {
    const int steps = (int)min((long long)kScanTile, L - t0);
    if constexpr (kCkpt) {
      if (active) {
        float* ck = a.ckpt + ((b * nseg + t0 / kScanTile) * a.D + d) * N;
#pragma unroll
        for (int n = 0; n < N; ++n) ck[n] = h[n];
      }
    }
    __syncthreads();  // the previous tile has been consumed
    if (active) {
      for (int k = 0; k < steps; ++k) {
        const long long t = t0 + k;
        sU[k][tid] = load_f32(u_b + t * a.ld_u + d);
        sDt[k][tid] = load_f32(dt_b + t * a.ld_delta + d);
        if (has_z) sZ[k][tid] = load_f32(z_b + t * a.ld_z + d);
      }
    }
    for (int i = tid; i < steps * N; i += kScanThreads) {
      const int k = i / N;
      const int n = i - k * N;
      sB[k][n] = load_f32(B_b + (t0 + k) * a.ld_B + n);
      sC[k][n] = load_f32(C_b + (t0 + k) * a.ld_C + n);
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
      if (active) store_as(y_b + (t0 + k) * a.ld_y + d, yv);
    }
  }

  if (active) {
    float* hl = a.h_last + (b * a.D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hl[n] = h[n];
  }
}

template <int N, typename TU, typename TZ, typename TY, bool kRoundZ, bool kCkpt>
__global__ void __launch_bounds__(kScanThreads) scan_walk_kernel(ScanArgs a) {
  scan_walk<N, TU, TZ, TY, kRoundZ, kCkpt>(a);
}

// kRoundZOk: whether the caller may round z (K4 only), so K1 and K3 compile
// no rounding variants.
template <int N, typename TU, typename TZ, typename TY, bool kRoundZOk>
void launch_walk_n(const ScanArgs& a, dim3 grid, cudaStream_t stream) {
  if constexpr (kRoundZOk) {
    if (a.round_z) {
      if (a.ckpt) {
        scan_walk_kernel<N, TU, TZ, TY, true, true><<<grid, kScanThreads, 0, stream>>>(a);
      } else {
        scan_walk_kernel<N, TU, TZ, TY, true, false><<<grid, kScanThreads, 0, stream>>>(a);
      }
      return;
    }
  }
  if (a.ckpt) {
    scan_walk_kernel<N, TU, TZ, TY, false, true><<<grid, kScanThreads, 0, stream>>>(a);
  } else {
    scan_walk_kernel<N, TU, TZ, TY, false, false><<<grid, kScanThreads, 0, stream>>>(a);
  }
}

// Launches the walk over grid (ceil(D / kScanThreads), batch) for the state
// sizes the library is built for (N in {8, 16, 32, 64, 128}; the wrappers pad
// other sizes with zero lanes). round_z (K4's bf16
// gate) only where kRoundZOk; checkpoints with or without it.
template <typename TU, typename TZ, typename TY, bool kRoundZOk = false>
cudaError_t launch_scan_walk_t(const ScanArgs& a, int batch, int n,
                               cudaStream_t stream) {
  if (a.round_z && !kRoundZOk) return cudaErrorInvalidValue;
  const dim3 grid((a.D + kScanThreads - 1) / kScanThreads, batch);
  switch (n) {
    case 8:
      launch_walk_n<8, TU, TZ, TY, kRoundZOk>(a, grid, stream);
      break;
    case 16:
      launch_walk_n<16, TU, TZ, TY, kRoundZOk>(a, grid, stream);
      break;
    case 32:
      launch_walk_n<32, TU, TZ, TY, kRoundZOk>(a, grid, stream);
      break;
    case 64:
      launch_walk_n<64, TU, TZ, TY, kRoundZOk>(a, grid, stream);
      break;
    case 128:
      launch_walk_n<128, TU, TZ, TY, kRoundZOk>(a, grid, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K4's walk: fp32 operands, z rounded to bf16 on its bf16 path.
inline cudaError_t launch_scan_walk(const ScanArgs& a, int batch, int n,
                                    cudaStream_t stream) {
  return launch_scan_walk_t<float, float, float, true>(a, batch, n, stream);
}

}  // namespace vmt
