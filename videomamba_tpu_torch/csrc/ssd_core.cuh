// The Mamba-2 (SSD) chunk walk shared by the mixer kernel (ssd_mixer.cu, K12)
// and the projected mixer (ssd_pmixer.cu, K14): conv + SiLU over the [x B C]
// slab, the state-passing chunk walk, the D skip, the silu(z) gate and the
// gated RMSNorm, from an in_proj output zx to the gated rows. Defined in
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
  const float* Dskip;      // (H,)
  const float* norm_w;     // (Di,) or null: no gated RMSNorm
  const float* h0;         // (B, H, P, N)
  float* h_last;           // (B, H, P, N)
  float* cy;               // scratch (B * L, CD): the conv after SiLU
  float* y;                // scratch (B * L, Di): y before the gate
  float* hin;              // scratch (B, nc, H, P, N): chunk states, then entry states
  int B, L, Q, H, P, G, N, W;
  float eps;
};

// Chunk rows the chunk kernels stage in shared memory at a time.
constexpr int kSsdSlab = 64;

// Shared memory of the chunk-output kernel, the largest of the walk: C and
// B slabs (N, kSsdSlab), the (kSsdSlab, kSsdSlab) tile of m, an x slab and
// the rows' sums (kSsdSlab, P), the entry state (N, P), s and dt (Q,).
inline size_t ssd_out_smem_bytes(int Q, int P, int N) {
  const size_t S = kSsdSlab;
  return sizeof(float) * (2 * S * N + S * S + 2 * S * P + (size_t)N * P + 2 * (size_t)Q);
}

// cudaErrorInvalidValue for shapes the walk does not take: P and N
// multiples of 4, G dividing H, the chunk-output tiles in one block.
cudaError_t ssd_check(const SsdArgs& a);

template <typename T>
cudaError_t ssd_core(const SsdArgs& a, cudaStream_t stream);

}  // namespace vmt
