// Whole prenorm Block for Hopper: add + norm, in_proj, conv, x_proj,
// dt_proj, the selective-scan walk with the gate, out_proj.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/block_fused.py
// (block_fused_pallas -> _block_fused_jit -> _block_kernel_pipelined, the
// serving form), with its rounding points:
//   res_out = f32(hidden) + f32(residual), stored in res_out's dtype
//   normed  = norm(res_out) in fp32, rounded to the weight dtype
//   xz      = normed @ W_in^T (fp32 accumulate); x and z stay fp32
//   cy      = silu(conv over [conv_state[..., 1:] || x] + b), fp32
//   x_dbl   = bf16(cy) @ W_x^T; delta = bf16(x_dbl[:, :R]) @ W_dt^T
//   y, h    = walk (softplus(delta + dt_bias), D skip, silu(z) gate), where
//             z is rounded to bf16 on the bf16 path
//   out     = bf16(y) @ W_out^T, rounded to hidden's dtype
// On the fp32 path ("highest") nothing is rounded before a product.
// With ckpt (the training forward, JAX block_fused.py:102, 196-198) the walk
// also stores the state at each 16-step tile boundary, the residual K7
// (block_bwd.cu) rebuilds from: a compile-time flag of the walk, so serving
// pays nothing for it.
//
// Why several launches: the TPU kernel keeps all five weight matrices in
// VMEM (about 9 MB at VideoMamba-Base bf16) and streams time blocks past
// them. A Hopper block has 227 KB of shared memory, and the x_proj
// contraction crosses every channel while the walk runs in parallel over
// channels, so the span runs as nine launches on one stream through
// scratch the caller allocates: add + norm (add_norm.cuh), in_proj, conv +
// SiLU, x_proj, dt_proj (mixer_parts.cuh), the walk's three (chunk states,
// the pass over chunks, the output walk: scan_walk_split.cuh), out_proj.
// The four products are written here (the TPU kernel computes them in its
// body). At bf16, in_proj and out_proj run on hopper_gemm.cuh's persistent
// TMA-fed wgmma tile (hg::product, NT, 256 x 128 tiles; in_proj writes xz in
// fp32, the NT product's fp32 output), and the walk stores y in bf16: its
// store rounds to nearest even (__float2bfloat16_rn), as the mma.sync
// tile's load rounded the fp32 y before, so out_proj reads the same
// values, now through TMA, which cannot convert. x_proj and dt_proj stay
// on the 64 x 64 mma.sync tile (mixer_parts.cuh gemm_nt_bf16): x_proj's
// N = R + 2N = 80 and dt_proj's K = R = 48 at Base, where a 128-wide,
// 64-deep wgmma tile would leave most of its width or depth idle. At fp32
// all four run on fp32 FMA tiles.
//
// What bounds it on the H100 (Base, bf16): its operations. At the serving
// shape (4 streams of L 12,545, 50,180 rows; H100 SXM 700 W) the Block
// takes about 4.1 ms: in_proj 0.42 ms (237 GFLOP, 0.24 ms at 989 TFLOP/s),
// out_proj 0.18 (118 GFLOP, 0.12 ms), where the mma.sync tile took 1.83
// and 1.02; the walk (chunk states, pass, output walk: 2.1 ms) and conv +
// SiLU (0.7 ms) are now most of it. The walk cuts time into chunks that
// pass a state from one to the next (scan_walk_split.cuh), so its launches
// fill the card; it is a serial chain within a chunk.
#include <type_traits>

#include "add_norm.cuh"
#include "hopper_gemm.cuh"
#include "mixer_parts.cuh"
#include "scan_walk_split.cuh"

namespace {

// Every launch after add + norm: in_proj, conv + SiLU, x_proj, dt_proj, the
// walk, out_proj; the products as bf16 tensor-core tiles or fp32 FMA tiles.
template <bool kBf16>
cudaError_t products_and_walk(const void* normed, const void* in_w,
                              const void* conv_w, const void* conv_b,
                              const void* x_proj_w, const void* dt_proj_w,
                              const void* out_w, const float* conv_state,
                              vmt::ScanArgs& walk, const vmt::SplitArgs& split,
                              float* xz, float* conv_out,
                              float* x_dbl, float* delta, void* y, void* out,
                              int batch, int L, int E, int Di, int W, int R,
                              int N, cudaStream_t s) {
  using T = typename std::conditional<kBf16, vmt::bf16, float>::type;
  const int rows = batch * L;
  const int P = R + 2 * N;
  cudaError_t err;
  if constexpr (kBf16) {
    err = vmt::hg::product<T>(vmt::hg::kNT, (const T*)normed, E, (const T*)in_w, E, xz, 2 * Di,
                              rows, 2 * Di, E, nullptr, s, /*c_f32=*/true);
  } else {
    err = vmt::gemm_nt((const T*)normed, E, (const T*)in_w, E, xz, 2 * Di,
                       rows, 2 * Di, E, s);
  }
  if (err != cudaSuccess) return err;

  err = vmt::conv_silu<float, T>(xz, 2 * Di, conv_state, (const T*)conv_w,
                          (const T*)conv_b, conv_out, batch, L, Di, W, s);
  if (err != cudaSuccess) return err;

  if constexpr (kBf16) {
    err = vmt::gemm_nt_bf16<float, float>(conv_out, Di, (const T*)x_proj_w, Di,
                                          x_dbl, P, rows, P, Di, s);
    if (err != cudaSuccess) return err;
    err = vmt::gemm_nt_bf16<float, float>(x_dbl, P, (const T*)dt_proj_w, R,
                                          delta, Di, rows, Di, R, s);
  } else {
    err = vmt::gemm_nt(conv_out, Di, (const T*)x_proj_w, Di, x_dbl, P, rows,
                       P, Di, s);
    if (err != cudaSuccess) return err;
    err = vmt::gemm_nt(x_dbl, P, (const T*)dt_proj_w, R, delta, Di, rows, Di,
                       R, s);
  }
  if (err != cudaSuccess) return err;

  walk.u = conv_out;
  walk.ld_u = Di;
  walk.delta = delta;
  walk.ld_delta = Di;
  walk.z = xz + Di;
  walk.ld_z = 2 * Di;
  walk.B = x_dbl + R;
  walk.ld_B = P;
  walk.C = x_dbl + R + N;
  walk.ld_C = P;
  walk.y = y;
  walk.ld_y = Di;
  walk.L = L;
  walk.D = Di;
  walk.softplus = 1;
  walk.round_z = kBf16 ? 1 : 0;
  err = vmt::launch_scan_walk_split<float, float, T, true>(walk, split, batch, N, s);
  if (err != cudaSuccess) return err;

  if constexpr (kBf16) {
    return vmt::hg::product<T>(vmt::hg::kNT, (const T*)y, Di, (const T*)out_w, Di, out, E, rows,
                               E, Di, nullptr, s);
  } else {
    return vmt::gemm_nt((const T*)y, Di, (const T*)out_w, Di, (T*)out, E, rows, E, Di, s);
  }
}

}  // namespace

// hidden, out: (batch, L, E) in the weight dtype (bf16 when is_bf16, else
// fp32); residual (batch, L, E) and res_out by res_bf16 / res_out_bf16;
// norm_w, norm_b (may be null): (E,) fp32; in_w (2Di, E), out_w (E, Di),
// conv_w (Di, W), conv_b (Di,), x_proj_w (R + 2N, Di), dt_proj_w (Di, R) in
// the weight dtype; dt_bias, Dskip (Di,), A (Di, N), h0 / h_last
// (batch, Di, N), conv_state (batch, Di, W): fp32. All contiguous. Scratch:
// normed and y (batch * L * E and batch * L * Di, the weight dtype), xz
// (batch * L * 2Di), conv_out and delta (batch * L * Di), x_dbl
// (batch * L * (R + 2N)), fp32; the
// walk's walk_states (batch, nchunks - 1, Di, N) and walk_dtsum
// (batch, nchunks - 1, Di), fp32, nchunks = ceil(L / walk_chunk), walk_chunk
// a multiple of 16. ckpt: (batch, ceil(L / 16), Di, N) fp32, or null for
// serving.
extern "C" int vmt_block_fused(
    const void* hidden, const void* residual, int res_bf16,
    const float* norm_w, const float* norm_b, const void* in_w,
    const void* out_w, const void* conv_w, const void* conv_b,
    const void* x_proj_w, const void* dt_proj_w, const float* dt_bias,
    const float* A, const float* Dskip, const float* h0,
    const float* conv_state, void* out, void* res_out, int res_out_bf16,
    float* h_last, float* ckpt, void* normed, float* xz, float* conv_out,
    float* x_dbl, float* delta, void* y, float* walk_states, float* walk_dtsum,
    int walk_chunk, int is_bf16, int batch, int L, int E, int Di, int W, int R,
    int N, float eps, int is_rms, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;

  vmt::AddNormArgs n;
  n.x = hidden;
  n.x_bf16 = is_bf16;
  n.residual = residual;
  n.res_bf16 = res_bf16;
  n.weight = norm_w;
  n.bias = norm_b;
  n.out = normed;
  n.res_out = res_out;
  n.res_out_bf16 = res_out_bf16;
  n.M = batch * L;
  n.D = E;
  n.eps = eps;
  n.is_rms = is_rms;
  err = vmt::launch_add_norm(n, s);
  if (err != cudaSuccess) return (int)err;

  vmt::ScanArgs walk;
  walk.A = A;
  walk.Dskip = Dskip;
  walk.delta_bias = dt_bias;
  walk.h0 = h0;
  walk.h_last = h_last;
  walk.ckpt = ckpt;
  vmt::SplitArgs split;
  split.states = walk_states;
  split.dtsum = walk_dtsum;
  split.chunk = walk_chunk;
  err = is_bf16
            ? products_and_walk<true>(normed, in_w, conv_w, conv_b, x_proj_w,
                                      dt_proj_w, out_w, conv_state, walk, split, xz,
                                      conv_out, x_dbl, delta, y, out, batch, L,
                                      E, Di, W, R, N, s)
            : products_and_walk<false>(normed, in_w, conv_w, conv_b, x_proj_w,
                                       dt_proj_w, out_w, conv_state, walk, split, xz,
                                       conv_out, x_dbl, delta, y, out, batch,
                                       L, E, Di, W, R, N, s);
  return (int)err;
}
