// Causal depthwise conv1d + bias + SiLU (K10) for Hopper.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/causal_conv.py
// (causal_conv1d_pallas -> _conv_kernel):
//   y[b, t, d] = act(bias[d] + sum_k w[k, d] ctx[b, t + k, d])
// where ctx is x preceded by the last W - 1 raw inputs of conv_state
// (b, d, 1 .. W-1), fp32 sums, y in x's dtype.
//
// Design. The TPU kernel streams (time, channel) blocks through VMEM and
// passes the input twice (the current and the previous time block) to have
// the W - 1 rows of left context at hand. Here a block owns 128 channels of
// one batch row and a tile of kConvTile time steps; each thread owns one
// channel and walks the tile in time order with the last W - 1 inputs in
// registers: the halo rows before the tile come from the previous tile's
// rows (or conv_state for the first tile), read once, and every load and
// store is coalesced across the warp's neighbouring channels. The taps and
// the bias sit in registers for the whole tile. Widths 1 to 4 are compiled
// as such (causal_conv_kernel); any other width runs causal_conv_any_kernel,
// whose taps loop at run time over inputs read from device memory (the
// W - 1 rows before a step come from L1 and L2), in the same summation
// order.
//
// What bounds it on the H100: device memory. One read of x and one write of
// y (plus (W - 1) / kConvTile extra halo reads), against 2W + 5 operations
// an element.
#include "add_norm.cuh"

namespace {

constexpr int kConvThreads = 128;  // channels per block
constexpr int kConvTile = 64;      // time steps per block

template <typename TX, int W>
__global__ void __launch_bounds__(kConvThreads)
    causal_conv_kernel(const TX* __restrict__ x, const float* __restrict__ conv_state,
                       const float* __restrict__ weight, const float* __restrict__ bias,
                       TX* __restrict__ y, int L, int D, int silu) {
  const int d = blockIdx.x * kConvThreads + threadIdx.x;
  if (d >= D) return;
  const long long b = blockIdx.z;
  const long long t0 = (long long)blockIdx.y * kConvTile;
  const int steps = (int)min((long long)kConvTile, (long long)L - t0);
  float w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = weight[(long long)k * D + d];
  const float bv = bias ? bias[d] : 0.f;
  const TX* xb = x + b * L * D;
  TX* yb = y + b * L * D;
  const float* st = conv_state + (b * D + d) * W;
  float win[W];  // win[0 .. W-2]: the W - 1 inputs before the current step
#pragma unroll
  for (int j = 0; j < W - 1; ++j) {
    const long long s = t0 - (W - 1) + j;
    win[j] = s >= 0 ? vmt::to_f32(xb[s * D + d]) : st[W + s];
  }
  for (int k = 0; k < steps; ++k) {
    const long long t = t0 + k;
    win[W - 1] = vmt::to_f32(xb[t * D + d]);
    float acc = w[0] * win[0];
#pragma unroll
    for (int j = 1; j < W; ++j) acc += w[j] * win[j];
    acc += bv;
    if (silu) acc *= 1.f / (1.f + expf(-acc));
    yb[t * D + d] = vmt::from_f32<TX>(acc);
#pragma unroll
    for (int j = 0; j < W - 1; ++j) win[j] = win[j + 1];
  }
}

// Any width W: thread (t, d) of the tile sums its W taps in order from x (or
// conv_state before the start).
template <typename TX>
__global__ void __launch_bounds__(kConvThreads)
    causal_conv_any_kernel(const TX* __restrict__ x, const float* __restrict__ conv_state,
                           const float* __restrict__ weight, const float* __restrict__ bias,
                           TX* __restrict__ y, int L, int D, int W, int silu) {
  const int d = blockIdx.x * kConvThreads + threadIdx.x;
  if (d >= D) return;
  const long long b = blockIdx.z;
  const long long t0 = (long long)blockIdx.y * kConvTile;
  const int steps = (int)min((long long)kConvTile, (long long)L - t0);
  const float bv = bias ? bias[d] : 0.f;
  const TX* xb = x + b * L * D;
  TX* yb = y + b * L * D;
  const float* st = conv_state + (b * D + d) * W;
  for (int k = 0; k < steps; ++k) {
    const long long t = t0 + k;
    float acc = 0.f;
    for (int j = 0; j < W; ++j) {
      const long long s = t - (W - 1) + j;
      const float v = s >= 0 ? vmt::to_f32(xb[s * D + d]) : st[W + s];
      const float p = weight[(long long)j * D + d] * v;
      acc = j == 0 ? p : acc + p;
    }
    acc += bv;
    if (silu) acc *= 1.f / (1.f + expf(-acc));
    yb[t * D + d] = vmt::from_f32<TX>(acc);
  }
}

template <typename TX>
cudaError_t causal_conv_t(const TX* x, const float* conv_state, const float* weight,
                          const float* bias, TX* y, int batch, int L, int D, int W,
                          int silu, cudaStream_t s) {
  const dim3 grid((D + kConvThreads - 1) / kConvThreads, (L + kConvTile - 1) / kConvTile,
                  batch);
  switch (W) {
    case 1:
      causal_conv_kernel<TX, 1><<<grid, kConvThreads, 0, s>>>(x, conv_state, weight, bias,
                                                              y, L, D, silu);
      break;
    case 2:
      causal_conv_kernel<TX, 2><<<grid, kConvThreads, 0, s>>>(x, conv_state, weight, bias,
                                                              y, L, D, silu);
      break;
    case 3:
      causal_conv_kernel<TX, 3><<<grid, kConvThreads, 0, s>>>(x, conv_state, weight, bias,
                                                              y, L, D, silu);
      break;
    case 4:
      causal_conv_kernel<TX, 4><<<grid, kConvThreads, 0, s>>>(x, conv_state, weight, bias,
                                                              y, L, D, silu);
      break;
    default:
      causal_conv_any_kernel<TX><<<grid, kConvThreads, 0, s>>>(x, conv_state, weight, bias, y,
                                                               L, D, W, silu);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: (batch, L, D) contiguous, fp32 or bf16 (x_bf16); conv_state
// (batch, D, W), weight (W, D) and bias (D,) (may be null): fp32. Any W >= 1;
// silu: apply SiLU.
extern "C" int vmt_causal_conv(const void* x, const float* conv_state,
                               const float* weight, const float* bias, void* y,
                               int x_bf16, int batch, int L, int D, int W, int silu,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || L == 0 || D == 0) return cudaSuccess;
  if (W < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  using vmt::bf16;
  return (int)(x_bf16 ? causal_conv_t<bf16>((const bf16*)x, conv_state, weight, bias,
                                            (bf16*)y, batch, L, D, W, silu, s)
                      : causal_conv_t<float>((const float*)x, conv_state, weight, bias,
                                             (float*)y, batch, L, D, W, silu, s));
}
