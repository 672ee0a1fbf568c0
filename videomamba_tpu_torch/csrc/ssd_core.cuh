// The Mamba-2 (SSD) chunk walk shared by the mixer kernel (ssd_mixer.cu, K12),
// the projected mixer (ssd_pmixer.cu, K14) and the bare scan (K11's forward,
// vmt_ssd_scan in ssd_mixer.cu): conv + SiLU over the [x B C] slab, the
// state-passing chunk walk, the D skip, the silu(z) gate and the gated
// RMSNorm, from an in_proj output zx to the gated rows. Defined in
// ssd_mixer.cu for T = float and bf16.
#pragma once

#include "add_norm.cuh"

namespace vmt {

// Rows of (B, L, .) operands are batch-major: row r = b * L + t.
struct SsdArgs {
  const void* zx;          // (B * L, ld_zx) T: z at column 0, [x B C] at Di
  long long ld_zx;
  void* out;               // (B * L, Di) T: the gated rows
  const float* conv_state; // (B, CD, W), already rounded to T
  const float* conv_w;     // (CD, W)
  const float* conv_b;     // (CD,)
  const float* s;          // (B, Lp, H): per-chunk inclusive cumsum of dt * A
  const float* dt;         // (B, Lp, H): post-softplus dt, 0 on padded rows
  const float* Dskip;      // (H,) or null: no D skip
  const float* norm_w;     // (Di,) or null: no gated RMSNorm
  const float* h0;         // (B, H, P, N)
  float* h_last;           // (B, H, P, N)
  float* cy;               // scratch (B * L, CD): the conv after SiLU
  float* y;                // (B * L, Di): y before the gate (the backward's yd)
  float* hin;              // (B, nc, H, P, N): chunk states, then entry states (hins)
  int B, L, Q, H, P, G, N, W;
  float eps;
};

// Chunk rows the chunk kernels stage in shared memory at a time, and the
// width of the head-dim (P) and state (N) tiles they stage.
constexpr int kSsdSlab = 64;

// v rounded to the compute dtype T (bf16, or no rounding at fp32).
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// acc[i][j] += a[i] b[j]: the chunk kernels' 4 x 4 register tile.
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Shared memory of the chunk-output kernel, the largest of the walk: six
// (kSsdSlab, kSsdSlab) tiles (C and B slabs of an N tile, m, an x slab of a
// P tile, the entry state's (N, P) tile and the rows' sums), s and dt (Q,).
// It does not grow with P or N.
inline size_t ssd_out_smem_bytes(int Q) {
  const size_t S = kSsdSlab;
  return sizeof(float) * (6 * S * S + 2 * (size_t)Q);
}

// cudaErrorInvalidValue for shapes the walk does not take: P and N
// multiples of 4, G dividing H, the chunk-output tiles in one block.
cudaError_t ssd_check(const SsdArgs& a);

template <typename T>
cudaError_t ssd_core(const SsdArgs& a, cudaStream_t stream);

// The walk alone (K11's forward): launches 2-4 of ssd_core over a.cy, which
// holds x, B and C (post-SiLU or the caller's inputs) as fp32 rows of CD.
template <typename T>
cudaError_t ssd_walk(const SsdArgs& a, cudaStream_t stream);

// The gate and the norm alone (launch 5): a.out = rnd(norm(a.y * silu(z))).
template <typename T>
cudaError_t ssd_gate(const SsdArgs& a, cudaStream_t stream);

}  // namespace vmt
