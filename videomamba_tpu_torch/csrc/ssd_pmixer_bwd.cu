// Mamba-2 projected mixer backward for Hopper (K14's backward): K13's span
// plus the in_proj and out_proj gradients.
//
// Replaces the backward Pallas kernels of videomamba_tpu/ops/pallas/
// ssd_block.py (_ssd_pmixer_bwd_padded -> _ssd_pmixer_bwd_kernel, and
// _ssd_pmixer_bwd_merged -> _ssd_pmixer_bwd_merged_kernel), with their
// rounding points (T the input and weight dtype; fp32 rounds nothing):
//   zx      = rnd(hidden @ Win[:Di + CD]^T), recomputed     (ssd_block.py:656)
//   gated   = rnd(norm(yd silu(z))), recomputed
//   dWout   = dout^T gated                                   (:692-695)
//   dgated  = dout @ Wout, fp32                              (:696-699)
//   dzx, ... = K13's span at dout = dgated (ssd_mixer_bwd.cu), dzx rounded to T
//   dhidden = dzx @ Win[:Di + CD], fp32 (the caller rounds)  (:850-853)
//   dWin    = dzx^T hidden, rows [0, Di + CD)                (:854-857)
// Every product sums in fp32. The dt rows of Win get their gradient from
// autograd, outside: the dt columns' product and softplus run outside the
// kernel in the JAX package too (ssd_block.py:1619).
//
// Design. The TPU kernel keeps both weights and their fp32 gradients in
// VMEM and accumulates the weight gradients over the chunks. Here the span
// is launches on one stream: in_proj on K4's bf16 mma.sync tile or K14's
// wide fp32 tile (mixer_parts.cuh), K12's gate launch for gated, out_proj's
// two gradients and in_proj's two on K6/K7's FMA tiles (mixer_bwd.cuh: NN
// products, and TN products over 256-row slices summed in order), and K13's
// span between them.
//
// What bounds it on the H100: operations. At VideoMamba-Base-m2, B = 1, the
// five products are about 27 GFLOP, 0.4 ms at fp32's 67 TFLOP/s, and K13's
// walk; the FMA tiles run well below that rate.
#include <type_traits>

#include "mixer_bwd.cuh"
#include "ssd_core_bwd.cuh"

namespace {

template <bool kBf16>
cudaError_t pmixer_bwd(const void* hidden, const void* in_w, const void* out_w,
                       const void* dout, void* zx, void* gated, float* dgated, void* dzx,
                       float* dhidden, float* dwin, float* dwout, float* part, int E,
                       vmt::SsdMixerBwdArgs a, cudaStream_t s) {
  using T = typename std::conditional<kBf16, vmt::bf16, float>::type;
  const int Di = a.H * a.P, ZX = Di + Di + 2 * a.G * a.N;  // z | x B C
  const int rows = a.B * a.L;
  cudaError_t err;
  if constexpr (kBf16) {
    err = vmt::gemm_nt_bf16<T, T>((const T*)hidden, E, (const T*)in_w, E, (T*)zx, ZX, rows,
                                  ZX, E, s);
  } else {
    err = vmt::gemm_nt_wide((const T*)hidden, E, (const T*)in_w, E, (T*)zx, ZX, rows, ZX, E,
                            s);
  }
  if (err != cudaSuccess) return err;
  vmt::SsdArgs g{zx, ZX, gated, nullptr, nullptr, nullptr, a.s, a.dt, nullptr, a.norm_w,
                 nullptr, nullptr, nullptr, const_cast<float*>(a.yd), nullptr, nullptr,
                 a.B, a.L, a.Q, a.H, a.P, a.G, a.N, a.W, a.eps};
  if ((err = vmt::ssd_gate<T>(g, s)) != cudaSuccess) return err;
  if ((err = gemm_tn<T, T>((const T*)dout, E, (const T*)gated, Di, dwout, part, E, Di,
                           rows, s)) != cudaSuccess)
    return err;
  if ((err = gemm_nn<T, T>((const T*)dout, E, (const T*)out_w, Di, dgated, Di, nullptr,
                           nullptr, rows, Di, E, s)) != cudaSuccess)
    return err;
  a.zx = zx;
  a.ld_zx = ZX;
  a.dout = dgated;
  a.dout_f32 = 1;
  a.dzx = dzx;
  a.ld_dzx = ZX;
  a.zero_cols = 0;
  if ((err = vmt::ssd_mixer_bwd<T>(a, s)) != cudaSuccess) return err;
  if ((err = gemm_nn<T, T>((const T*)dzx, ZX, (const T*)in_w, E, dhidden, E, nullptr,
                           nullptr, rows, E, ZX, s)) != cudaSuccess)
    return err;
  return gemm_tn<T, T>((const T*)dzx, ZX, (const T*)hidden, E, dwin, part, ZX, E, rows, s);
}

}  // namespace

// hidden, dout (B, L, E), in_w (2 Di + 2 G N + H, E) (rows [0, Di + CD) are
// read), out_w (E, Di): one dtype, fp32 or bf16 (is_bf16), contiguous.
// Writes dhidden (B * L, E) fp32, dwin (Di + CD, E) and dwout (E, Di) fp32,
// and, as vmt_ssd_mixer_bwd, dh0, the conv gradients, the per-block
// partials and the scan's per-step cotangents. Scratch in that dtype: zx and
// dzx B L (Di + CD), gated B L Di; fp32: dgated B L Di, part (ceil(B L /
// 256) max((Di + CD) E, E Di)), and vmt_ssd_mixer_bwd's.
extern "C" int vmt_ssd_pmixer_bwd(
    const void* hidden, const void* in_w, const void* out_w, const void* dout, void* zx,
    void* gated, float* dgated, void* dzx, float* dhidden, float* dwin, float* dwout,
    float* part, int E, const float* conv_state, const float* conv_w, const float* conv_b,
    const float* s, const float* dt, const float* Dskip, const float* norm_w,
    const float* hins, const float* yd, const float* dhlast, float* dh0, float* dconv_state,
    float* dconv_w, float* dconv_b, float* part_nw, float* part_dD, float* cy, float* cpre,
    float* dyd, float* dxbc, float* g, float* dbh, float* dch, float* dsq, float* dsk,
    float* ddt, float* dslast, float* conv_part, float* cb, int B, int L, int Q, int H, int P,
    int G, int N, int W, float eps, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vmt::SsdMixerBwdArgs a{nullptr, 0, nullptr, 1, nullptr, 0, 0, conv_state, conv_w,
                               conv_b, s, dt, Dskip, norm_w, hins, yd, dhlast, dh0,
                               dconv_state, dconv_w, dconv_b, part_nw, part_dD, cy, cpre, dyd,
                               dxbc, g, dbh, dch, dsq, dsk, ddt, dslast, conv_part, cb,
                               B, L, Q, H, P, G, N, W, eps};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? pmixer_bwd<true>(hidden, in_w, out_w, dout, zx, gated, dgated, dzx,
                                          dhidden, dwin, dwout, part, E, a, st)
                       : pmixer_bwd<false>(hidden, in_w, out_w, dout, zx, gated, dgated, dzx,
                                           dhidden, dwin, dwout, part, E, a, st));
}
