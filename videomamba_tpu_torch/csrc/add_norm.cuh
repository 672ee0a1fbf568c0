// Residual add + RMSNorm / LayerNorm row kernel, shared by K2
// (fused_add_norm.cu), the first launch of K4 (block_fused.cu) and K7's norm
// recompute (block_bwd.cu), plus the fp32 <-> bf16 conversions the kernels
// use.
//
//   res    = x + residual            (res = x when there is no residual)
//   normed = norm(res) * weight (+ bias), statistics in fp32
//
// x and normed share one dtype (fp32 or bf16) unless a caller names normed's
// own (TO: K7 norms an fp32 res_out into bf16); the residual and res_out
// each are fp32 or bf16 on their own, so a bf16 model can carry an fp32 residual
// stream (residual_in_fp32). The sum and the statistics are fp32 and the
// normalised row is rounded once, to normed's dtype, as in
// videomamba_tpu/ops/pallas/fused_add_norm.py (_kernel).
//
// What bounds it on the H100: device memory. Per row it reads x and the
// residual and writes normed and res, against a handful of flops per element.
// Each warp owns one row, keeps the fp32 sum in shared memory after the
// single read of x and residual, and takes the statistics with warp
// shuffles, so each element crosses device memory once each way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vmt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as astype(bf16)
}

constexpr int kNormWarps = 4;  // rows per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TX, typename TR, typename TRO, typename TO = TX>
__global__ void __launch_bounds__(kNormWarps * 32) add_norm_kernel(
    const TX* __restrict__ x, const TR* __restrict__ residual,
    const float* __restrict__ weight, const float* __restrict__ bias,
    TO* __restrict__ out, TRO* __restrict__ res_out, int M, int D, float eps,
    int is_rms) {
  extern __shared__ float srow[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kNormWarps + warp;
  if (row >= M) return;  // whole warp leaves together; no block barrier below

  float* r = srow + warp * D;
  const TX* xr = x + row * D;
  const TR* rr = residual ? residual + row * D : nullptr;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = rr ? to_f32(xr[i]) + to_f32(rr[i]) : to_f32(xr[i]);
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

  TO* o = out + row * D;
  TRO* ro = res_out ? res_out + row * D : nullptr;
  for (int i = lane; i < D; i += 32) {
    const float v = r[i];
    float nv = (v - mean) * inv * weight[i];
    if (bias) nv += bias[i];
    o[i] = from_f32<TO>(nv);
    if (ro) ro[i] = from_f32<TRO>(v);
  }
}

// Operands of one add + norm launch; *_bf16 flags give each tensor's dtype
// (0 = fp32, 1 = bf16). residual, bias and res_out may be null.
struct AddNormArgs {
  const void* x;
  int x_bf16;
  const void* residual;
  int res_bf16;
  const float* weight;
  const float* bias;
  void* out;  // x's dtype
  void* res_out;
  int res_out_bf16;
  int M;
  int D;
  float eps;
  int is_rms;
};

template <typename TX, typename TR, typename TRO>
cudaError_t add_norm_typed(const AddNormArgs& a, cudaStream_t s) {
  const size_t smem = (size_t)kNormWarps * a.D * sizeof(float);
  const int blocks = (a.M + kNormWarps - 1) / kNormWarps;
  add_norm_kernel<TX, TR, TRO><<<blocks, kNormWarps * 32, smem, s>>>(
      (const TX*)a.x, (const TR*)a.residual, a.weight, a.bias, (TX*)a.out,
      (TRO*)a.res_out, a.M, a.D, a.eps, a.is_rms);
  return cudaGetLastError();
}

template <typename TX, typename TR>
cudaError_t add_norm_res(const AddNormArgs& a, cudaStream_t s) {
  return a.res_out_bf16 ? add_norm_typed<TX, TR, bf16>(a, s)
                        : add_norm_typed<TX, TR, float>(a, s);
}

template <typename TX>
cudaError_t add_norm_x(const AddNormArgs& a, cudaStream_t s) {
  return a.res_bf16 ? add_norm_res<TX, bf16>(a, s)
                    : add_norm_res<TX, float>(a, s);
}

// One row per warp; D fp32 per warp in static-size dynamic shared memory,
// so D <= 3072 keeps the block within the 48 KB a launch may take unasked.
inline cudaError_t launch_add_norm(const AddNormArgs& a, cudaStream_t s) {
  if ((size_t)kNormWarps * a.D * sizeof(float) > 48 * 1024) return cudaErrorInvalidValue;
  if (a.M == 0) return cudaSuccess;
  return a.x_bf16 ? add_norm_x<bf16>(a, s) : add_norm_x<float>(a, s);
}

}  // namespace vmt
