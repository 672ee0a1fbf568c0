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
// The row pass (one warp per row, the row and its cotangent in shared
// memory, per-block dweight / dbias partials summed in order by a second
// launch: no floating-point atomics) is add_norm_bwd.cuh, which K7 shares.
//
// What bounds it on the H100: device memory (three rows read, two written,
// a few flops per element), which is why every element crosses it once.
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
};

template <typename TX, typename TR, typename TG>
cudaError_t add_norm_bwd_t(const NormBwdIO& io, cudaStream_t s) {
  return vmt::launch_add_norm_bwd<TX, TR, TG>(
      (const TX*)io.x, (const TR*)io.residual, io.weight, (const TX*)io.g_n,
      (const TG*)io.g_r, (TX*)io.dx, (TR*)io.dres, io.dweight, io.dbias, io.part,
      io.M, io.D, io.eps, io.is_rms, s);
}

template <typename TX, typename TR>
cudaError_t add_norm_bwd_r(const NormBwdIO& io, int gr_bf16, cudaStream_t s) {
  return gr_bf16 ? add_norm_bwd_t<TX, TR, bf16>(io, s)
                 : add_norm_bwd_t<TX, TR, float>(io, s);
}

template <typename TX>
cudaError_t add_norm_bwd_x(const NormBwdIO& io, int res_bf16, int gr_bf16,
                           cudaStream_t s) {
  return res_bf16 ? add_norm_bwd_r<TX, bf16>(io, gr_bf16, s)
                  : add_norm_bwd_r<TX, float>(io, gr_bf16, s);
}

}  // namespace

// Rows of partial sums (2 x D fp32 each) the caller allocates for M rows.
extern "C" int vmt_fused_add_norm_bwd_blocks(long long M) { return vmt::norm_bwd_blocks(M); }

// x, g_n, dx: (M, D) in x's dtype (x_bf16); residual and dres (may be null)
// in the residual's dtype (res_bf16); g_r (the returned residual's
// cotangent, null unless prenorm) by gr_bf16; weight (D,) fp32; dweight,
// dbias (D,) fp32; part (blocks x 2 x D) fp32 scratch. All contiguous.
extern "C" int vmt_fused_add_norm_bwd(const void* x, int x_bf16,
                                      const void* residual, int res_bf16,
                                      const float* weight, const void* g_n,
                                      const void* g_r, int gr_bf16, void* dx,
                                      void* dres, float* dweight, float* dbias,
                                      float* part, long long M, int D,
                                      float eps, int is_rms, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  NormBwdIO io{x, residual, weight, g_n, g_r, dx, dres, dweight, dbias, part,
               M, D, eps, is_rms};
  return (int)(x_bf16 ? add_norm_bwd_x<bf16>(io, res_bf16, gr_bf16, s)
                      : add_norm_bwd_x<float>(io, res_bf16, gr_bf16, s));
}
