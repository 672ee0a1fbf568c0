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
//              silu(z) gate), the time-split walk of scan_walk_split.cuh
//
// On the TPU one kernel holds all of this, because the x_proj contraction
// crosses every channel while the walk is parallel over channels and VMEM
// holds a whole time block of both. On Hopper a block sees 227 KB of shared
// memory, so the span runs as launches on one stream: conv, two products,
// and the walk's three (chunk states, the pass over chunks, the output
// walk; only the last when L fits one chunk). conv_out, x_dbl and delta
// make one round trip through device memory each (about 20 MB at
// VideoMamba-Base, batch 1).
//
// Precision follows the TPU kernel's two routes (mixer_fused.py:121-127):
// with fp32 weights ("highest") everything is fp32 and the products are FMA
// tiles; with bf16 weights conv_out is rounded to bf16 before x_proj and
// x_dbl's dt columns before dt_proj, on the bf16 mma.sync tiles (fp32
// accumulate). x and z (fp32 or bf16) are widened on load; conv_out, x_dbl,
// delta and the walk are fp32; y is stored in x's dtype. With ckpt the walk
// stores its 16-step segment-start states for the backward (mixer_bwd.cu).
//
// What bounds it on the H100 (Base, batch 1, fp32): its operations, 0.0129
// ms at the fp32 rate (0.87 GFLOP of products, conv and walk; x, z, y and
// the states are 39 MB, 0.0117 ms). As built the span also moves conv_out
// and delta through device memory, about 80 MB in all. The walk once set
// the time, a serial chain of L steps on ceil(Di / 128) blocks (12 at Base,
// batch 1); it now cuts time into chunks that pass a state from one to the
// next (scan_walk_split.cuh), so its launches fill the card. The conv and
// the tiles are in mixer_parts.cuh, shared with the whole-block kernel and
// the backward.
#include "mixer_parts.cuh"
#include "scan_walk_split.cuh"

namespace {

template <typename TX, typename TW>
cudaError_t mixer_fused_t(const void* x, long long ld_x, const void* z,
                          long long ld_z, const float* conv_state,
                          const void* conv_w, const void* conv_b,
                          const void* x_proj_w, const void* dt_proj_w,
                          const float* dt_bias, const float* A,
                          const float* Dskip, const float* h0, void* y,
                          float* h_last, float* ckpt, float* conv_out,
                          float* x_dbl, float* delta,
                          const vmt::SplitArgs& split, int batch, int L, int Di,
                          int W, int R, int N, cudaStream_t s) {
  const int rows = batch * L;
  const int P = R + 2 * N;
  cudaError_t err = vmt::conv_silu<TX, TW>((const TX*)x, ld_x, conv_state,
                                           (const TW*)conv_w, (const TW*)conv_b,
                                           conv_out, batch, L, Di, W, s);
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(TW) == 2) {
    err = vmt::gemm_nt_bf16<float, float>(conv_out, Di, (const TW*)x_proj_w, Di,
                                          x_dbl, P, rows, P, Di, s);
    if (err != cudaSuccess) return err;
    err = vmt::gemm_nt_bf16<float, float>(x_dbl, P, (const TW*)dt_proj_w, R,
                                          delta, Di, rows, Di, R, s);
  } else {
    err = vmt::gemm_nt(conv_out, Di, (const float*)x_proj_w, Di, x_dbl, P,
                       rows, P, Di, s);
    if (err != cudaSuccess) return err;
    err = vmt::gemm_nt(x_dbl, P, (const float*)dt_proj_w, R, delta, Di, rows,
                       Di, R, s);
  }
  if (err != cudaSuccess) return err;

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
  a.ckpt = ckpt;
  a.L = L;
  a.D = Di;
  a.softplus = 1;
  return vmt::launch_scan_walk_split<float, TX, TX>(a, split, batch, N, s);
}

}  // namespace

// x, z: (batch, L, Di) rows of stride ld_x / ld_z, fp32 or bf16 (x_bf16);
// y (batch, L, Di) contiguous in x's dtype. conv_w (Di, W), conv_b (Di,),
// x_proj_w (R + 2N, Di), dt_proj_w (Di, R) in the weight dtype (w_bf16);
// conv_state (batch, Di, W), dt_bias, Dskip (Di,), A (Di, N), h0 / h_last
// (batch, Di, N), ckpt (batch, ceil(L / 16), Di, N) or null: fp32. conv_out
// and delta (batch * L * Di) and x_dbl (batch * L * (R + 2N)) are fp32
// scratch the caller allocates, and so are the walk's: walk_states
// (batch, nchunks - 1, Di, N) and walk_dtsum (batch, nchunks - 1, Di), fp32,
// nchunks = ceil(L / walk_chunk), walk_chunk a multiple of 16.
extern "C" int vmt_mixer_fused(
    const void* x, long long ld_x, const void* z, long long ld_z,
    const float* conv_state, const void* conv_w, const void* conv_b,
    const void* x_proj_w, const void* dt_proj_w, const float* dt_bias,
    const float* A, const float* Dskip, const float* h0, void* y,
    float* h_last, float* ckpt, float* conv_out, float* x_dbl, float* delta,
    float* walk_states, float* walk_dtsum, int walk_chunk, int x_bf16,
    int w_bf16, int batch, int L, int Di, int W, int R, int N, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  vmt::SplitArgs split;
  split.states = walk_states;
  split.dtsum = walk_dtsum;
  split.chunk = walk_chunk;
  using bf = vmt::bf16;
#define VMT_MIXER_ARGS                                                        \
  x, ld_x, z, ld_z, conv_state, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, \
      A, Dskip, h0, y, h_last, ckpt, conv_out, x_dbl, delta, split, batch, L, \
      Di, W, R, N, s
  if (x_bf16) {
    err = w_bf16 ? mixer_fused_t<bf, bf>(VMT_MIXER_ARGS)
                 : mixer_fused_t<bf, float>(VMT_MIXER_ARGS);
  } else {
    err = w_bf16 ? mixer_fused_t<float, bf>(VMT_MIXER_ARGS)
                 : mixer_fused_t<float, float>(VMT_MIXER_ARGS);
  }
#undef VMT_MIXER_ARGS
  return (int)err;
}
