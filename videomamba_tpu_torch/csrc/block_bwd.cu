// Whole prenorm Block backward (K7) for Hopper: every gradient of the span
// block_fused.cu (K4) computes, from the forward's fp32 res_out and its
// 16-step scan checkpoints.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/block_bwd.py
// (block_bwd_pallas -> _block_bwd_kernel), math at block_bwd.py:143-436:
//   recompute  normed = norm(res_out) rounded to the weight dtype;
//              xz = normed Win^T (fp32); x, z = split (z stays fp32)
//   out_proj   g_y = g_out Wout                      (g_out in its dtype)
//   mixer      K6's span (mixer_bwd.cuh) with x, z read from xz and dx, dz
//              written into dxz = [dx | dz]; its time-split reverse walk
//              (scan_walk_split_bwd.cuh) also rebuilds the forward's gated
//              output y = pre silu(z) (a compile-time flag of the walk,
//              block_bwd.py:297-303): no forward y is kept
//   weights    dWout = g_out^T y;  dWin = dxz^T normed
//   in_proj    dnormed = dxz Win
//   add-norm   K8's row backward (add_norm_bwd.cuh) at res_out, with the
//              res_out cotangent g_res added: dres, dnorm_w, dnorm_b
// Rounding at bf16 weights (block_bwd.py:161-206, 324-393): each product's
// input is rounded to bf16 (normed, g_out, ddelta, dxdbl, dxz) and both
// inputs of every weight-gradient product (g_out and y, dxz and normed, and
// K6's own); every product accumulates in fp32. With fp32 weights nothing
// is rounded. The caller passes res_out = f32(hidden) + f32(residual),
// whatever residual_in_fp32 says, the point the forward normed at.
//
// Why many launches: the TPU kernel walks time blocks in reverse on one core
// with all five weights and every intermediate in VMEM. A Hopper block has
// 227 KB of shared memory and blocks run in no order, so the span runs as a
// sequence of launches on one stream through fp32 scratch the caller
// allocates, reusing the forward's pieces: K2's row kernel for the norm,
// K4's product tiles (bf16 mma.sync or fp32 FMA) for in_proj, K6's span
// whole (conv recompute, NN/TN tiles, the time-split reverse walk, conv
// backward, ordered partial sums) and K8's row backward. The four outer
// products are K6's NN tiles (g_y, dnormed) and TN tiles (dWout, dWin,
// split over 256-row slices summed in order): bf16 mma.sync at bf16
// weights, fp32 FMA at fp32. No floating-point atomics: repeated runs are
// bit-identical.
//
// What bounds it on the H100: its operations, about 30 GFLOP at Base,
// B = 1 (in_proj recompute, g_y, dnormed, dWout, dWin and K6's four), on
// the tensor cores at bf16 and on FMA tiles at fp32. A serial reverse walk
// and FMA tiles at bf16 took 2.5 and 2.0 of 5.1 ms (PERF.md).
#include "add_norm_bwd.cuh"
#include "mixer_bwd.cuh"

namespace {

struct BlockBwdIO {
  const float* res_out;
  const float* norm_w;
  const float* norm_b;
  const void* in_w;
  const void* out_w;
  const void* conv_w;
  const void* conv_b;
  const void* x_proj_w;
  const void* dt_proj_w;
  const float* dt_bias;
  const float* A;
  const float* Dskip;
  const float* conv_state;
  const float* ckpt;
  const void* g_out;
  const void* g_res;
  const float* g_hlast;
  float* dres;
  float* dnorm_w;
  float* dnorm_b;
  float* dWin;
  float* dWout;
  float* dconv_w;
  float* dconv_b;
  float* dx_proj_w;
  float* ddt_proj_w;
  float* ddt_bias;
  float* dA;
  float* dD;
  float* dh0;
  float* dconv_state;
  float* scratch;
  int batch, L, E, Di, W, R, N;
  int chunk;  // steps per chunk of the split reverse walk
  float eps;
  int is_rms;
  vmt::NormBwdPlan norm_plan;  // the add-norm row pass's (the wrapper's norm_bwd_plan)
};

// Scratch regions in floats, each 64-float aligned (16-byte loads).
struct BlockBwdScratch {
  long long normed, xz, g_y, y, dxz, dnormed, tn_part, norm_part, mixer, total;
};

BlockBwdScratch block_bwd_scratch(int batch, int L, int E, int Di, int W, int R, int N,
                                  int chunk, int norm_blocks) {
  const long long rows = (long long)batch * L;
  BlockBwdScratch s;
  long long at = 0;
  s.normed = at;
  at += align64(rows * E);  // bf16 rows use half of it
  s.xz = at;
  at += align64(rows * 2 * Di);
  s.g_y = at;
  at += align64(rows * Di);
  s.y = at;
  at += align64(rows * Di);
  s.dxz = at;
  at += align64(rows * 2 * Di);
  s.dnormed = at;
  at += align64(rows * E);
  s.tn_part = at;
  at += align64((long long)tn_slices(rows) * E * 2 * Di);
  s.norm_part = at;
  at += align64((long long)norm_blocks * 2 * E);
  s.mixer = at;
  at += mixer_bwd_scratch(batch, L, Di, W, R, N, chunk).total;
  s.total = at;
  return s;
}

template <typename TW, typename TG>
cudaError_t block_bwd_t(const BlockBwdIO& io, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(TW) == 2;
  const int batch = io.batch, L = io.L, E = io.E, Di = io.Di;
  const int rows = batch * L;
  const BlockBwdScratch at =
      block_bwd_scratch(batch, L, E, Di, io.W, io.R, io.N, io.chunk, io.norm_plan.blocks);
  TW* normed = (TW*)(io.scratch + at.normed);
  float* xz = io.scratch + at.xz;
  float* g_y = io.scratch + at.g_y;
  float* y = io.scratch + at.y;
  float* dxz = io.scratch + at.dxz;
  float* dnormed = io.scratch + at.dnormed;
  float* tn_part = io.scratch + at.tn_part;
  float* norm_part = io.scratch + at.norm_part;
  const TW* in_w = (const TW*)io.in_w;
  const TW* out_w = (const TW*)io.out_w;
  const TW* g_out = (const TW*)io.g_out;

  // normed = norm(res_out), rounded to the weight dtype (K2's row kernel).
  cudaError_t err = vmt::launch_add_norm_rows<float, float, float, TW>(
      io.res_out, nullptr, io.norm_w, io.norm_b, normed, (float*)nullptr, rows, E, io.eps,
      io.is_rms, s);
  if (err != cudaSuccess) return err;

  // xz = normed Win^T (K4's tiles).
  if constexpr (kBf16) {
    err = vmt::gemm_nt_bf16<TW, float>(normed, E, in_w, E, xz, 2 * Di, rows, 2 * Di, E, s);
  } else {
    err = vmt::gemm_nt(normed, E, in_w, E, xz, 2 * Di, rows, 2 * Di, E, s);
  }
  if (err != cudaSuccess) return err;

  // g_y = g_out Wout: Wout is (E, Di) row-major, the NN tile's W.
  err = product_nn<kBf16>(g_out, E, out_w, Di, g_y, Di, nullptr, nullptr, rows, Di, E, s);
  if (err != cudaSuccess) return err;

  MixerBwdIO m{xz, 2LL * Di, xz + Di, 2LL * Di, io.conv_state, io.conv_w, io.conv_b,
               io.x_proj_w, io.dt_proj_w, io.dt_bias, io.A, io.Dskip, io.ckpt,
               g_y, Di, io.g_hlast, dxz, 2LL * Di, dxz + Di, 2LL * Di, y,
               io.dconv_w, io.dconv_b, io.dx_proj_w, io.ddt_proj_w, io.ddt_bias,
               io.dA, io.dD, io.dh0, io.dconv_state, io.scratch + at.mixer,
               batch, L, Di, io.W, io.R, io.N, io.chunk};
  err = mixer_bwd_t<float, TW, true>(m, s);
  if (err != cudaSuccess) return err;

  // dWout (E, Di) = g_out^T y;  dnormed = dxz Win;  dWin (2Di, E) = dxz^T normed.
  err = product_tn<kBf16>(g_out, E, y, Di, io.dWout, tn_part, E, Di, rows, s);
  if (err != cudaSuccess) return err;
  err = product_nn<kBf16>(dxz, 2 * Di, in_w, E, dnormed, E, nullptr, nullptr, rows, E,
                          2 * Di, s);
  if (err != cudaSuccess) return err;
  err = product_tn<kBf16>(dxz, 2 * Di, normed, E, io.dWin, tn_part, 2 * Di, E, rows, s);
  if (err != cudaSuccess) return err;

  // dres = norm backward at res_out + g_res; dnorm_w, dnorm_b (K8's rows,
  // at the wrapper's plan).
  return vmt::launch_add_norm_bwd<float, float, TG, float>(
      io.res_out, nullptr, io.norm_w, dnormed, (const TG*)io.g_res, io.dres, nullptr,
      io.dnorm_w, io.dnorm_b, norm_part, rows, E, io.eps, io.is_rms, io.norm_plan, s);
}

}  // namespace

// fp32 scratch the wrapper allocates for one call (in floats).
// chunk: steps per chunk of the split reverse walk, a multiple of 16;
// norm_blocks: the add-norm row pass's blocks (its partial rows).
extern "C" long long vmt_block_bwd_scratch_floats(int batch, int L, int E, int Di,
                                                  int W, int R, int N, int chunk,
                                                  int norm_blocks) {
  return block_bwd_scratch(batch, L, E, Di, W, R, N, chunk, norm_blocks).total;
}

// res_out (batch, L, E) fp32 = f32(hidden) + f32(residual); norm_w, norm_b
// (may be null: RMSNorm) (E,) fp32; in_w (2Di, E), out_w (E, Di), conv_w
// (Di, W), conv_b (Di,), x_proj_w (R + 2N, Di), dt_proj_w (Di, R) in the
// weight dtype (w_bf16); dt_bias, Dskip (Di,), A (Di, N), conv_state
// (batch, Di, W), ckpt (batch, ceil(L / 16), Di, N): fp32. g_out (batch, L,
// E) in the weight dtype; g_res (batch, L, E) fp32 or bf16 (gres_bf16);
// g_hlast (batch, Di, N) fp32 or null. Every gradient fp32 in its primal's
// layout: dres (batch, L, E), dnorm_w, dnorm_b (E,), dWin (2Di, E), dWout
// (E, Di), dconv_w (Di, W), dconv_b (Di,), dx_proj_w (R + 2N, Di),
// ddt_proj_w (Di, R), ddt_bias, dD (Di,), dA (Di, N), dh0 (batch, Di, N),
// dconv_state (batch, Di, W). All contiguous. norm_vec .. norm_stream: the
// add-norm row pass's plan (the wrapper's norm_bwd_plan; one these pointers
// cannot take returns cudaErrorInvalidValue from that last launch).
extern "C" int vmt_block_bwd(
    const float* res_out, const float* norm_w, const float* norm_b, const void* in_w,
    const void* out_w, const void* conv_w, const void* conv_b, const void* x_proj_w,
    const void* dt_proj_w, const float* dt_bias, const float* A, const float* Dskip,
    const float* conv_state, const float* ckpt, const void* g_out, const void* g_res,
    int gres_bf16, const float* g_hlast, float* dres, float* dnorm_w, float* dnorm_b,
    float* dWin, float* dWout, float* dconv_w, float* dconv_b, float* dx_proj_w,
    float* ddt_proj_w, float* ddt_bias, float* dA, float* dD, float* dh0,
    float* dconv_state, float* scratch, int w_bf16, int batch, int L, int E, int Di,
    int W, int R, int N, int chunk, float eps, int is_rms, int norm_vec, int norm_threads,
    int norm_rows, int norm_blocks, int norm_stream, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BlockBwdIO io{res_out, norm_w, norm_b, in_w, out_w, conv_w, conv_b, x_proj_w,
                dt_proj_w, dt_bias, A, Dskip, conv_state, ckpt, g_out, g_res, g_hlast,
                dres, dnorm_w, dnorm_b, dWin, dWout, dconv_w, dconv_b, dx_proj_w,
                ddt_proj_w, ddt_bias, dA, dD, dh0, dconv_state, scratch,
                batch, L, E, Di, W, R, N, chunk, eps, is_rms,
                vmt::NormBwdPlan{norm_vec, norm_threads, norm_rows, norm_blocks, norm_stream}};
  const cudaStream_t s = (cudaStream_t)stream;
  using vmt::bf16;
  if (w_bf16) {
    err = gres_bf16 ? block_bwd_t<bf16, bf16>(io, s) : block_bwd_t<bf16, float>(io, s);
  } else {
    err = gres_bf16 ? block_bwd_t<float, bf16>(io, s) : block_bwd_t<float, float>(io, s);
  }
  return (int)err;
}
