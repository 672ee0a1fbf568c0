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
// shuffles, so each element crosses device memory once each way. A block
// holds four rows (above D = 3072 opting into more than 48 KB of shared
// memory, up to 227 KB), fewer above D = 14528; a row too wide for even one
// (D > 58112) is read again from device memory for each of its passes
// (launch_add_norm_rows).
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

constexpr int kNormWarps = 4;  // rows per block, at most
constexpr size_t kNormSmemMax = 232448;  // dynamic shared memory a block may opt into (227 KB)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows a block of a row kernel holding `floats` fp32 values per row element
// in shared memory takes at width D: kNormWarps while they fit in
// kNormSmemMax, fewer above, 0 when not even one row fits (the kernel then
// streams the row from device memory, kStream).
inline int norm_rows_per_block(int D, int floats) {
  const size_t row = (size_t)floats * (size_t)D * sizeof(float);
  if (row == 0) return kNormWarps;
  const size_t fit = kNormSmemMax / row;
  return fit >= (size_t)kNormWarps ? kNormWarps : (int)fit;
}

// One warp per row, blockDim.x / 32 rows a block. The row sum x + residual
// stays in shared memory between its single read and the writes; with
// kStream (rows too wide for shared memory) it is read again from device
// memory in each pass instead, in the same order, so both forms give the
// same bits.
template <typename TX, typename TR, typename TRO, typename TO = TX, bool kStream = false>
__global__ void __launch_bounds__(kNormWarps * 32) add_norm_kernel(
    const TX* __restrict__ x, const TR* __restrict__ residual,
    const float* __restrict__ weight, const float* __restrict__ bias,
    TO* __restrict__ out, TRO* __restrict__ res_out, int M, int D, float eps,
    int is_rms) {
  extern __shared__ float srow[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= M) return;  // whole warp leaves together; no block barrier below

  float* r = kStream ? nullptr : srow + (long long)warp * D;
  const TX* xr = x + row * D;
  const TR* rr = residual ? residual + row * D : nullptr;
  auto load = [&](int i) { return rr ? to_f32(xr[i]) + to_f32(rr[i]) : to_f32(xr[i]); };
  float s = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = load(i);
    if constexpr (!kStream) r[i] = v;
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
      const float c = (kStream ? load(i) : r[i]) - mean;
      s2 += c * c;
    }
    var = warp_sum(s2) / (float)D;
  }
  const float inv = 1.f / sqrtf(var + eps);

  TO* o = out + row * D;
  TRO* ro = res_out ? res_out + row * D : nullptr;
  for (int i = lane; i < D; i += 32) {
    const float v = kStream ? load(i) : r[i];
    float nv = (v - mean) * inv * weight[i];
    if (bias) nv += bias[i];
    o[i] = from_f32<TO>(nv);
    if (ro) ro[i] = from_f32<TRO>(v);
  }
}

// add_norm_kernel over M rows of width D, at the rows a block that fit
// (opting into more than 48 KB of shared memory where needed), or streamed.
template <typename TX, typename TR, typename TRO, typename TO = TX>
cudaError_t launch_add_norm_rows(const TX* x, const TR* residual, const float* weight,
                                 const float* bias, TO* out, TRO* res_out, int M, int D,
                                 float eps, int is_rms, cudaStream_t s) {
  if (M == 0) return cudaSuccess;
  const int warps = norm_rows_per_block(D, 1);
  if (warps == 0) {
    add_norm_kernel<TX, TR, TRO, TO, true>
        <<<(M + kNormWarps - 1) / kNormWarps, kNormWarps * 32, 0, s>>>(
            x, residual, weight, bias, out, res_out, M, D, eps, is_rms);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)warps * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(add_norm_kernel<TX, TR, TRO, TO, false>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  add_norm_kernel<TX, TR, TRO, TO, false><<<(M + warps - 1) / warps, warps * 32, smem, s>>>(
      x, residual, weight, bias, out, res_out, M, D, eps, is_rms);
  return cudaGetLastError();
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
  return launch_add_norm_rows<TX, TR, TRO>((const TX*)a.x, (const TR*)a.residual, a.weight,
                                           a.bias, (TX*)a.out, (TRO*)a.res_out, a.M, a.D,
                                           a.eps, a.is_rms, s);
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

// Any row width D: up to kNormWarps rows a block while their D fp32 fit in
// shared memory (up to 227 KB), fewer above D = 14528, and above 58112 the
// rows streamed from device memory.
inline cudaError_t launch_add_norm(const AddNormArgs& a, cudaStream_t s) {
  if (a.M == 0) return cudaSuccess;
  return a.x_bf16 ? add_norm_x<bf16>(a, s) : add_norm_x<float>(a, s);
}

}  // namespace vmt
