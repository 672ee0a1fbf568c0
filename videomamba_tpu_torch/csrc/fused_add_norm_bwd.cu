// Backward of the fused residual add + RMSNorm / LayerNorm (K8) for Hopper.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/fused_add_norm.py
// (fused_add_norm_bwd_pallas -> _bwd_kernel). Per row, in fp32:
//   r = x + residual;  rms: inv = 1/sqrt(mean(r^2) + eps), nrm = r inv
//                      layer: cen = r - mean(r), inv = 1/sqrt(mean(cen^2) + eps),
//                      nrm = cen inv
//   dweight += g nrm;  dbias += g;  dn = g weight
//   rms:   dr = dn inv - r inv^3 sum(dn r) / D
//   layer: dc = dn inv - cen inv^3 sum(dn cen) / D;  dr = dc - mean(dc)
//   prenorm: dr += g_res;  dx = dr (x's dtype), dresidual = dr (its dtype)
//
// The row pass and its ordered column sum are add_norm_bwd.cuh, which K7
// shares: rows in registers (a warp a row up to D = 768, 2-8 warps a
// wider row, a streamed row above D = 6128), 16-byte vectors where D and
// the pointers allow, a row's loads all issued before its first reduction,
// dweight / dbias summed per thread into its row group's shared-memory row,
// then per block in group order, then over blocks by a second launch in a
// fixed tree. No floating-point atomics. The wrapper plans the launch
// (ops/kernels/fused_add_norm.py norm_bwd_plan) and passes the plan in.
//
// What bounds it on the H100: device memory (three or four rows read, two
// written, a few flops per element), which is why every element crosses it
// once and each thread keeps several 16-byte loads in flight.
#include "add_norm_bwd.cuh"

namespace {

using vmt::bf16;

struct NormBwdIO {
  const void* x;
  const void* residual;
  const float* weight;
  const void* g_n;
  const void* g_r;
  void* dx;
  void* dres;
  float* dweight;
  float* dbias;
  float* part;
  long long M;
  int D;
  float eps;
  int is_rms;
  vmt::NormBwdPlan plan;
};

template <typename TX, typename TR, typename TN, typename TG>
cudaError_t add_norm_bwd_t(const NormBwdIO& io, cudaStream_t s) {
  return vmt::launch_add_norm_bwd<TX, TR, TG, TN>(
      (const TX*)io.x, (const TR*)io.residual, io.weight, (const TN*)io.g_n,
      (const TG*)io.g_r, (TX*)io.dx, (TR*)io.dres, io.dweight, io.dbias, io.part,
      io.M, io.D, io.eps, io.is_rms, io.plan, s);
}

template <typename TX, typename TR, typename TN>
cudaError_t add_norm_bwd_n(const NormBwdIO& io, int gr_bf16, cudaStream_t s) {
  return gr_bf16 ? add_norm_bwd_t<TX, TR, TN, bf16>(io, s)
                 : add_norm_bwd_t<TX, TR, TN, float>(io, s);
}

template <typename TX, typename TR>
cudaError_t add_norm_bwd_r(const NormBwdIO& io, int gn_bf16, int gr_bf16, cudaStream_t s) {
  return gn_bf16 ? add_norm_bwd_n<TX, TR, bf16>(io, gr_bf16, s)
                 : add_norm_bwd_n<TX, TR, float>(io, gr_bf16, s);
}

template <typename TX>
cudaError_t add_norm_bwd_x(const NormBwdIO& io, int res_bf16, int gn_bf16, int gr_bf16,
                           cudaStream_t s) {
  return res_bf16 ? add_norm_bwd_r<TX, bf16>(io, gn_bf16, gr_bf16, s)
                  : add_norm_bwd_r<TX, float>(io, gn_bf16, gr_bf16, s);
}

}  // namespace

// x, dx: (M, D) in x's dtype (x_bf16); residual and dres (may be null) in
// the residual's dtype (res_bf16); g_n (the normed output's cotangent) in
// its own (gn_bf16); g_r (the returned residual's cotangent, null unless
// prenorm) by gr_bf16. A missing residual or g_r takes x's dtype flag.
// weight (D,) fp32; dweight, dbias (D,) fp32; part (blocks x 2 x D) fp32
// scratch. All contiguous. The plan (vec, threads, rows, blocks, stream) is
// the wrapper's norm_bwd_plan; a plan the pointers or D cannot take
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int vmt_fused_add_norm_bwd(const void* x, int x_bf16,
                                      const void* residual, int res_bf16,
                                      const float* weight, const void* g_n, int gn_bf16,
                                      const void* g_r, int gr_bf16, void* dx,
                                      void* dres, float* dweight, float* dbias,
                                      float* part, long long M, int D,
                                      float eps, int is_rms, int vec, int threads,
                                      int rows, int blocks, int stream, int device,
                                      void* cuda_stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  if (!residual) res_bf16 = x_bf16;
  if (!g_r) gr_bf16 = x_bf16;
  NormBwdIO io{x, residual, weight, g_n, g_r, dx, dres, dweight, dbias, part,
               M, D, eps, is_rms, vmt::NormBwdPlan{vec, threads, rows, blocks, stream}};
  return (int)(x_bf16 ? add_norm_bwd_x<bf16>(io, res_bf16, gn_bf16, gr_bf16, s)
                      : add_norm_bwd_x<float>(io, res_bf16, gn_bf16, gr_bf16, s));
}
