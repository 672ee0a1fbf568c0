// Operands (ScanArgs) and helpers shared by the selective-scan walks: the
// time-split forward walk of scan_walk_split.cuh (K1 selective_scan.cu, K3
// mixer_fused.cu, K4 block_fused.cu), the reverse walks that include
// scan_walk_bwd.cuh (K5, K6, K7) and the decode stacks (decode_step.cu).
//
// Recurrence per (batch b, channel d, state n), all in fp32:
//   dt     = softplus(delta[t, d] + delta_bias[d])     (softplus optional)
//   h[n]   = exp(dt * A[d, n]) * h[n] + dt * u[t, d] * B[t, n]
//   y[t,d] = (sum_n C[t, n] * h[n] + Dskip[d] * u[t, d]) * silu(z[t, d])
// (the gate only with a z). z may be rounded to bf16 first (round_z), as the
// whole-block kernel's bf16 path stores the gate input
// (videomamba_tpu/ops/pallas/block_fused.py:427). With ckpt non-null a
// forward walk also stores the state at the start of every kScanTile-step
// segment, in fp32, as ckpt[b][t / kScanTile][d][n]: the residual the
// reverse walks rebuild each segment from.
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

}  // namespace vmt
