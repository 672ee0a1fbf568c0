// Mamba-2 projected mixer for Hopper (K14, forward): in_proj, the SSD mixer
// core (K12's span), out_proj.
//
// Replaces the forward of the Pallas kernels in
// videomamba_tpu/ops/pallas/ssd_block.py (ssd_projected_mixer:
// _ssd_pmixer_fwd_padded -> _ssd_pmixer_kernel, and _ssd_pmixer_fwd_merged
// -> _ssd_pmixer_fwd_merged_kernel), with their rounding points:
//   zx    = rnd(hidden @ Win[:Di + CD]^T), fp32 sums     (ssd_block.py:286)
//   gated = K12's span on zx (ssd_core.cuh), rounded to T
//   out   = rnd(gated @ Wout^T), fp32 sums                (ssd_block.py:323)
// T is the input and weight dtype: fp32 (the TPU's "highest", nothing
// rounded) or bf16. The dt columns Win[Di + CD:] are the caller's
// (torch.matmul, as the JAX package computes them outside the kernel).
//
// Design. The TPU kernel holds Win and Wout in VMEM (about 10 MB at
// VideoMamba-Base-m2 fp32) and feeds its idle MXU slots with the two
// products. A Hopper block has 227 KB of shared memory, so the span runs as
// eight launches on one stream through scratch the caller allocates: the two
// products, K12's six launches between them. At bf16 the products run on
// hopper_gemm.cuh's persistent TMA-fed wgmma tile (hg::product, NT, 256 x
// 128 tiles, fp32 sums, C in bf16), the tile K14's backward uses. At fp32
// they run on the wide FMA tile (gemm_nt_wide: a 64 x 64 block tile of 128
// threads, 8 x 4 outputs a thread as an outer product from
// contraction-major shared tiles, K slices double-buffered through
// registers; 1,250 and 300 blocks at Base, B = 1). It sums over k in order,
// as gemm_nt does, so the fp32 results are gemm_nt's.
//
// What bounds it on the H100: operations. At Base, B = 1, L = 1569 in_proj
// is 7.7 GFLOP and out_proj 3.7, about 0.17 ms at fp32's 67 TFLOP/s and
// 0.012 ms on bf16 tensor cores. At the serving shape (4 streams of L
// 12,545, bf16; H100 SXM 700 W) the layer takes about 5 ms: in_proj 0.41 ms (247 GFLOP, 0.25 ms at 989 TFLOP/s) and out_proj
// 0.18 (118 GFLOP, 0.12 ms), where the mma.sync tile took 1.9 and 1.0 ms;
// K12's state pass and chunk outputs are now most of the call.
#include <type_traits>

#include "hopper_gemm.cuh"
#include "mixer_parts.cuh"
#include "ssd_core.cuh"

namespace {

template <bool kBf16>
cudaError_t pmixer(const void* hidden, const void* in_w, const void* out_w, void* out,
                   void* zx, void* gated, int E, vmt::SsdArgs a, cudaStream_t s) {
  using T = typename std::conditional<kBf16, vmt::bf16, float>::type;
  cudaError_t err = vmt::ssd_check(a);
  if (err != cudaSuccess) return err;
  const int Di = a.H * a.P, ZX = Di + Di + 2 * a.G * a.N;  // z | x B C
  const int rows = a.B * a.L;
  if constexpr (kBf16) {
    err = vmt::hg::product<T>(vmt::hg::kNT, (const T*)hidden, E, (const T*)in_w, E, zx, ZX,
                              rows, ZX, E, nullptr, s);
  } else {
    err = vmt::gemm_nt_wide((const T*)hidden, E, (const T*)in_w, E, (T*)zx, ZX, rows, ZX, E,
                            s);
  }
  if (err != cudaSuccess) return err;
  a.zx = zx;
  a.ld_zx = ZX;
  a.out = gated;
  if ((err = vmt::ssd_core<T>(a, s)) != cudaSuccess) return err;
  if constexpr (kBf16) {
    return vmt::hg::product<T>(vmt::hg::kNT, (const T*)gated, Di, (const T*)out_w, Di, out, E,
                               rows, E, Di, nullptr, s);
  } else {
    return vmt::gemm_nt_wide((const T*)gated, Di, (const T*)out_w, Di, (T*)out, E, rows, E,
                             Di, s);
  }
}

}  // namespace

// hidden, out (B, L, E), in_w (2 Di + 2 G N + H, E) (rows [0, Di + CD) are
// read), out_w (E, Di): one dtype, fp32 or bf16 (is_bf16), contiguous.
// Scratch in that dtype: zx B L (Di + CD), gated B L Di. The other operands
// as vmt_ssd_mixer's.
extern "C" int vmt_ssd_pmixer(const void* hidden, const void* in_w, const void* out_w,
                              void* out, void* zx, void* gated, int E,
                              const float* conv_state, const float* conv_w,
                              const float* conv_b, const float* s, const float* dt,
                              const float* Dskip, const float* norm_w, const float* h0,
                              float* h_last, float* cy, float* y, float* hin, float* cb, int B,
                              int L, int Q, int H, int P, int G, int N, int W, float eps,
                              int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vmt::SsdArgs a{nullptr, 0, nullptr, conv_state, conv_w, conv_b, s, dt, Dskip,
                       norm_w, h0, h_last, cy, y, hin, cb, B, L, Q, H, P, G, N, W, eps};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? pmixer<true>(hidden, in_w, out_w, out, zx, gated, E, a, st)
                       : pmixer<false>(hidden, in_w, out_w, out, zx, gated, E, a, st));
}
