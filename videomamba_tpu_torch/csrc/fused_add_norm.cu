// Fused residual add + RMSNorm / LayerNorm for Hopper.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/fused_add_norm.py
// (fused_add_norm_pallas -> _kernel):
//   res    = x + residual            (res = x when there is no residual)
//   normed = norm(res) * weight (+ bias), statistics in fp32
//   returns normed, and res as well when prenorm.
//
// x and normed are fp32 or bf16; the residual and res_out each fp32 or bf16.
// The row kernel and what bounds it are in add_norm.cuh.
#include "add_norm.cuh"

// x, residual (may be null), out, res_out (null unless prenorm): (M, D)
// contiguous, dtypes by the *_bf16 flags (out takes x's); weight, bias (may
// be null): (D,) fp32.
extern "C" int vmt_fused_add_norm(const void* x, int x_bf16,
                                  const void* residual, int res_bf16,
                                  const float* weight, const float* bias,
                                  void* out, void* res_out, int res_out_bf16,
                                  int M, int D, float eps, int is_rms,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  vmt::AddNormArgs a;
  a.x = x;
  a.x_bf16 = x_bf16;
  a.residual = residual;
  a.res_bf16 = res_bf16;
  a.weight = weight;
  a.bias = bias;
  a.out = out;
  a.res_out = res_out;
  a.res_out_bf16 = res_out_bf16;
  a.M = M;
  a.D = D;
  a.eps = eps;
  a.is_rms = is_rms;
  return (int)vmt::launch_add_norm(a, (cudaStream_t)stream);
}
