// The reverse SSD chunk walk (K11's backward), shared by the bare scan's
// backward (vmt_ssd_scan_bwd in ssd_core_bwd.cu), the mixer backward
// (ssd_mixer_bwd.cu, K13) and the projected mixer's backward
// (ssd_pmixer_bwd.cu, K14). Defined in ssd_core_bwd.cu for T = float and bf16.
#pragma once

#include "ssd_core.cuh"

namespace vmt {

// Rows of (B, L, .) operands are batch-major: row r = b * L + t; per-step
// scalars are (B, Lp, H) with Lp = nc Q.
struct SsdBwdArgs {
  const float* xbc;     // (B * L, CD): x at column h P, B at Di + g N, C at Di + G N + g N
  const float* dy;      // (B * L, Di): the cotangent of y
  const float* s;       // (B, Lp, H): per-chunk inclusive cumsum of dt * A
  const float* dt;      // (B, Lp, H): post-softplus dt, 0 on padded rows
  const float* hins;    // (B, nc, H, P, N): each chunk's entry state
  const float* dhlast;  // (B, H, P, N) or null: the cotangent of h_last
  const float* Dskip;   // (H,) or null: dx also gets D dy
  float* g;             // scratch (B, nc, H, P, N): per chunk its own dh_in,
                        // then the cotangent of the state leaving it
  float* dxbc;          // (B * L, CD): dx, dB and dC
  float* dbh;           // scratch (B * L, H, N): dB per head
  float* dch;           // scratch (B * L, H, N): dC per head
  float* dsq;           // (B, Lp, H): ds terms indexed by the output row
  float* dsk;           // (B, Lp, H): ds terms indexed by the input row
  float* ddt;           // (B, Lp, H): the cotangent of dt
  float* dslast;        // (B, nc, nks, H): per 64-row slab, the chunk's last-row ds
  float* dh0;           // (B, H, P, N)
  float* cb;            // scratch (B, nc, G, Q, Q): each chunk's causal C B^T tiles
  int B, L, Q, H, P, G, N;
};

// Row slabs a chunk splits into (the dslast partials' second axis).
inline int ssd_bwd_slabs(int Q) { return (Q + kSsdSlab - 1) / kSsdSlab; }

template <typename T>
cudaError_t ssd_bwd_core(const SsdBwdArgs& a, cudaStream_t stream);

// Rows of the mixer backward's epilogue launch a block takes.
constexpr int kSsdEpiRows = 16;

// K13's span (ssd_mixer_bwd.cu), which K14's backward also runs: every
// gradient of K12's span from its checkpoints.
struct SsdMixerBwdArgs {
  const void* zx;          // (B * L, ld_zx) T: z at column 0, [x B C] at Di
  long long ld_zx;
  const void* dout;        // (B * L, Di): the cotangent of the gated rows, T or fp32
  int dout_f32;
  void* dzx;               // (B * L, ld_dzx) T: dz, then d[x B C], then zero_cols zeros
  long long ld_dzx;
  int zero_cols;
  const float* conv_state; // (B, CD, W), already rounded to T
  const float* conv_w;     // (CD, W)
  const float* conv_b;     // (CD,)
  const float* s;          // (B, Lp, H)
  const float* dt;         // (B, Lp, H)
  const float* Dskip;      // (H,)
  const float* norm_w;     // (Di,) or null
  const float* hins;       // (B, nc, H, P, N): the forward's entry states
  const float* yd;         // (B * L, Di): the forward's pre-gate y
  const float* dhlast;     // (B, H, P, N) or null
  float* dh0;              // (B, H, P, N)
  float* dconv_state;      // (B, CD, W)
  float* dconv_w;          // (CD, W)
  float* dconv_b;          // (CD,)
  float* part_nw;          // (ceil(B L / kSsdEpiRows), Di): per-block sums of dnorm_w
  float* part_dD;          // (ceil(B L / kSsdEpiRows), Di): per-block sums of dyd x
  float* cy;               // scratch (B * L, CD): the conv after SiLU
  float* cpre;             // scratch (B * L, CD): the conv before it
  float* dyd;              // scratch (B * L, Di): the cotangent of the pre-gate y
  float* dxbc;             // scratch (B * L, CD)
  float* g;                // scratch, as SsdBwdArgs
  float* dbh;
  float* dch;
  float* dsq;              // (B, Lp, H), as SsdBwdArgs
  float* dsk;
  float* ddt;
  float* dslast;
  float* conv_part;        // scratch (ceil(B L / 256), W + 1, CD)
  float* cb;               // scratch, as SsdBwdArgs
  int B, L, Q, H, P, G, N, W;
  float eps;
};

template <typename T>
cudaError_t ssd_mixer_bwd(const SsdMixerBwdArgs& a, cudaStream_t stream);

}  // namespace vmt
