// Fused residual add + RMSNorm / LayerNorm for Hopper.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/fused_add_norm.py
// (fused_add_norm_pallas -> _kernel):
//   res    = x + residual            (res = x when there is no residual)
//   normed = norm(res) * weight (+ bias), statistics in fp32
//   returns normed, and res as well when prenorm.
//
// What bounds it on the H100: device memory. Per row it reads x and the
// residual and writes normed and res, against a handful of flops per element.
// The design gives each warp one row, keeps the row in shared memory after
// the single read of x and residual, and takes the statistics with warp
// shuffles, so each element crosses device memory once each way.
#include <cuda_runtime.h>

namespace {

constexpr int kNormWarps = 4;  // rows per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kNormWarps * 32) fused_add_norm_kernel(
    const float* __restrict__ x, const float* __restrict__ residual,
    const float* __restrict__ weight, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ res_out, int M, int D,
    float eps, int is_rms) {
  extern __shared__ float srow[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kNormWarps + warp;
  if (row >= M) return;  // whole warp leaves together; no block barrier below

  float* r = srow + warp * D;
  const float* xr = x + row * D;
  const float* rr = residual ? residual + row * D : nullptr;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = rr ? xr[i] + rr[i] : xr[i];
    r[i] = v;
    s += is_rms ? v * v : v;
  }
  s = warp_sum(s);

  float mean = 0.f;
  float var;
  if (is_rms) {
    var = s / (float)D;
  } else {
    mean = s / (float)D;
    float s2 = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float c = r[i] - mean;
      s2 += c * c;
    }
    var = warp_sum(s2) / (float)D;
  }
  const float inv = 1.f / sqrtf(var + eps);

  float* o = out + row * D;
  float* ro = res_out ? res_out + row * D : nullptr;
  for (int i = lane; i < D; i += 32) {
    const float v = r[i];
    float nv = (v - mean) * inv * weight[i];
    if (bias) nv += bias[i];
    o[i] = nv;
    if (ro) ro[i] = v;
  }
}

}  // namespace

// x, residual (may be null), out, res_out (null unless prenorm): (M, D) fp32
// contiguous; weight, bias (may be null): (D,) fp32.
extern "C" int vmt_fused_add_norm(const float* x, const float* residual,
                                  const float* weight, const float* bias,
                                  float* out, float* res_out, int M, int D,
                                  float eps, int is_rms, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kNormWarps * D * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kNormWarps - 1) / kNormWarps;
  fused_add_norm_kernel<<<blocks, kNormWarps * 32, smem, (cudaStream_t)stream>>>(
      x, residual, weight, bias, out, res_out, M, D, eps, is_rms);
  return (int)cudaGetLastError();
}
