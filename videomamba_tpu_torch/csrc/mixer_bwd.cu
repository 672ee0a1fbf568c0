// Fused Mamba-1 mixer backward (K6) for Hopper: every gradient of the span
// mixer_fused.cu computes (conv, x_proj, dt_proj, scan, D skip, gate).
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/mixer_bwd.py
// (mixer_bwd_pallas -> _mixer_bwd_kernel), math at mixer_bwd.py:140-357:
//   recompute  cy_pre = conv(x), cy = silu(cy_pre), x_dbl = cy Wx^T,
//              delta_raw = x_dbl[:, :R] Wdt^T
//   reverse    the time-split reverse walk of scan_walk_split_bwd.cuh with
//              u = cy: du, ddelta_raw, dz, dB, dC, dA, dD, dbias, dh0
//   products   dxdbl = [ddelta_raw Wdt | dB | dC];  dcy = du + dxdbl Wx;
//              dcpre = dcy silu'(cy_pre)
//   conv       dx = correlation of dcpre with the taps (rows past L are 0);
//              dconv_state from the first W - 1 context rows;
//              dconv_w, dconv_b = sums over (b, t) of dcpre times the context
//   weights    dWx = dxdbl^T cy  (R + 2N, Di);  dWdt = ddelta_raw^T x_dbl[:, :R]
//
// Rounding (mixer_bwd.py, highest=False, i.e. bf16 weights): cy to bf16
// before x_proj (:156), x_dbl's dt columns before dt_proj (:162),
// ddelta_raw before its product with Wdt (:290), dxdbl before its product
// with Wx (:304), and both inputs of each weight-gradient product (:316-326);
// every product accumulates in fp32. dx and dz are stored in x's and z's
// dtype. With fp32 weights nothing is rounded.
//
// The span's device pieces live in mixer_bwd.cuh, which K7 (block_bwd.cu)
// shares.
//
// Why many launches: the TPU kernel walks time blocks in reverse on one core
// and keeps every intermediate in VMEM, carrying the next block's dcpre head
// rows in scratch. Hopper blocks run in no order and see 227 KB of shared
// memory, so the span runs as a sequence of launches on one stream through
// fp32 scratch the wrapper allocates; the conv backward reads the next rows
// of dcpre straight from device memory. The reverse walk splits time into
// chunks (scan_walk_split_bwd.cuh: chunk cotangents, a reverse pass over the
// chunks, the output walk), so a batch-1 Base call runs about 1,200 blocks
// where the serial walk ran 24. The products are hand-written, as the TPU
// kernel computes them in its body: the forward's NT tiles (mixer_parts.cuh)
// for the recompute, and two tile variants in mixer_bwd.cuh, NN (A W, for
// ddelta_raw Wdt and dxdbl Wx; the latter's epilogue forms dcpre) and TN
// (P^T Q, for the weight gradients, both operands read along the
// contraction), on bf16 tensor cores (mma.sync) at bf16 weights and on fp32
// FMA tiles at fp32. The weight gradients contract over K = batch * L rows
// into small outputs (80 x 1536 and 1536 x 48 at Base), so K is split into
// slices of kSplitRows rows, each slice writes its own partial, and a last
// launch sums the partials in order. No floating-point atomics anywhere:
// repeated runs are bit-identical.
//
// What bounds it on the H100: at fp32 its operations (about 2.3 GFLOP of
// products at Base, batch 1, on FMA tiles, and the walk's exps); a serial
// reverse walk took 2.5 of 3.3 ms (PERF.md).
#include "mixer_bwd.cuh"

// fp32 scratch the wrapper allocates for one call (in floats).
// chunk: steps per chunk of the split reverse walk, a multiple of 16.
extern "C" long long vmt_mixer_bwd_scratch_floats(int batch, int L, int Di,
                                                  int W, int R, int N, int chunk) {
  return mixer_bwd_scratch(batch, L, Di, W, R, N, chunk).total;
}

// x, z: (batch, L, Di) rows of stride ld_x / ld_z, fp32 or bf16 (x_bf16);
// g (cotangent of y) and dx, dz: (batch, L, Di) contiguous in x's dtype.
// conv_w (Di, W), conv_b (Di,), x_proj_w (R + 2N, Di), dt_proj_w (Di, R) in
// the weight dtype (w_bf16). conv_state (batch, Di, W), dt_bias, Dskip (Di,),
// A (Di, N), ckpt (batch, ceil(L / 16), Di, N), g_hlast (batch, Di, N; may
// be null) and every weight / state gradient: fp32, contiguous, in the
// weights' layouts.
extern "C" int vmt_mixer_bwd(
    const void* x, long long ld_x, const void* z, long long ld_z,
    const float* conv_state, const void* conv_w, const void* conv_b,
    const void* x_proj_w, const void* dt_proj_w, const float* dt_bias,
    const float* A, const float* Dskip, const float* ckpt, const void* g,
    const float* g_hlast, void* dx, void* dz, float* dconv_w, float* dconv_b,
    float* dx_proj_w, float* ddt_proj_w, float* ddt_bias, float* dA, float* dD,
    float* dh0, float* dconv_state, float* scratch, int x_bf16, int w_bf16,
    int batch, int L, int Di, int W, int R, int N, int chunk, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MixerBwdIO io{x, ld_x, z, ld_z, conv_state, conv_w, conv_b, x_proj_w,
                dt_proj_w, dt_bias, A, Dskip, ckpt, g, Di, g_hlast, dx, Di, dz,
                Di, nullptr, dconv_w, dconv_b, dx_proj_w, ddt_proj_w, ddt_bias,
                dA, dD, dh0, dconv_state, scratch, batch, L, Di, W, R, N, chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    err = w_bf16 ? mixer_bwd_t<bf16, bf16, false>(io, s)
                 : mixer_bwd_t<bf16, float, false>(io, s);
  } else {
    err = w_bf16 ? mixer_bwd_t<float, bf16, false>(io, s)
                 : mixer_bwd_t<float, float, false>(io, s);
  }
  return (int)err;
}
