// Causal depthwise conv1d + bias + SiLU (K10) for Hopper.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/causal_conv.py
// (causal_conv1d_pallas -> _conv_kernel):
//   y[b, t, d] = act(bias[d] + sum_k w[k, d] ctx[b, t + k, d])
// where ctx is x preceded by the last W - 1 raw inputs of conv_state
// (b, d, 1 .. W-1), fp32 sums, y in x's dtype.
//
// What bounds it on the H100: device memory. One read of x and one write of
// y (plus (W - 1) / tile halo rows read again, from L2 in practice) against
// 2W + 5 operations an element. The card streams at its rate only with about
// 2 MB of loads in flight, so the design is about bytes in flight:
// - Each thread owns one 16-byte vector of channels (4 fp32 or 8 bf16) and
//   a tile of time steps of one batch row. Its taps and bias sit in
//   registers; a block is 64 such threads side by side, so a warp's loads
//   and stores are 512 contiguous bytes of one time row. Blocks are laid
//   out time tile first, so neighbours share their halo rows in L2.
// - Widths 1 to 4 are compiled as such, over a tile of 4 steps: a thread
//   issues all 4 + W - 1 of its time rows' loads (kept as raw 16-byte
//   vectors, bf16 unconverted) before its first multiply-add, then writes
//   4 outputs. At (1, 1569, 1536) that is 2358 blocks at fp32 (1179 at
//   bf16), 8 of 64 threads resident an SM: the whole call is in flight at
//   once. The halo rows a short tile reads again (W - 1 of every 4 + W - 1)
//   come from L2, where the neighbouring tile just put them; tiles of 8 and
//   16 steps were slower on the card (fewer warps to hide each step's
//   multiply-adds and SiLU behind: 75-78 % and 57-70 % of the byte bound at
//   fp32 against 79-81 %, 29-45 % and 19-36 % at bf16 against 40-52 %).
// - Any other width keeps its taps in a run-time loop over the same vector
//   loads: a tile of 8 steps, its input rows read once in batches of 8 (all
//   loads of a batch in flight) and each row added into the outputs it
//   touches, the taps from L1.
// - The first tile's W - 1 rows of left context come from conv_state (fp32
//   or bf16, read as it is).
// - A D no multiple of the vector width, or x, weight or bias not on a
//   16-byte boundary, runs the same kernels one channel a thread (vec 1).
// Each output sums its taps in order, w0 x0 first, then each further tap
// as a fused multiply-add, then the bias, then SiLU.
// The wrapper plans the launch (ops/kernels/causal_conv.py causal_conv_plan).
#include "add_norm.cuh"

namespace {

constexpr int kConvThreads = 64;     // vectors of channels per block
constexpr int kConvTileFixed = 4;    // time steps per thread, widths 1-4
constexpr int kConvTileAny = 8;      // time steps per thread, other widths

// One load of V channels of T, kept raw until used.
template <typename T, int V>
struct Raw;
template <>
struct Raw<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ float at(int c) const {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};
template <>
struct Raw<vmt::bf16, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const vmt::bf16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float at(int c) const {
    const unsigned int w = (c >> 1) == 0 ? v.x : (c >> 1) == 1 ? v.y : (c >> 1) == 2 ? v.z : v.w;
    return (c & 1) ? __uint_as_float(w & 0xffff0000u) : __uint_as_float(w << 16);
  }
};
template <typename T>
struct Raw<T, 1> {
  T v;
  __device__ __forceinline__ void load(const T* p) { v = *p; }
  __device__ __forceinline__ float at(int) const { return vmt::to_f32(v); }
};

template <int V>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float* out) {
  if constexpr (V == 1) {
    out[0] = p[0];
  } else {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 v = reinterpret_cast<const float4*>(p)[h];
      out[4 * h] = v.x;
      out[4 * h + 1] = v.y;
      out[4 * h + 2] = v.z;
      out[4 * h + 3] = v.w;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_out(T* __restrict__ p, const float* v) {
  if constexpr (V == 1) {
    p[0] = vmt::from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    unsigned int w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned int*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// conv_state is fp32 or bf16 (the other pointer null); element k of a
// channel's window.
struct State {
  const float* f32;
  const vmt::bf16* b16;
  __device__ __forceinline__ float at(long long k) const {
    return b16 ? vmt::to_f32(b16[k]) : f32[k];
  }
};

__device__ __forceinline__ float finish(float acc, float b, int silu) {
  acc += b;
  return silu ? acc * (1.f / (1.f + expf(-acc))) : acc;
}

// Width W (1-4) compiled as such; tile T steps; V channels a thread.
template <typename TX, int V, int W, int T>
__global__ void __launch_bounds__(kConvThreads)
    causal_conv_kernel(const TX* __restrict__ x, State conv_state,
                       const float* __restrict__ weight, const float* __restrict__ bias,
                       TX* __restrict__ y, int L, int D, int silu) {
  const int j = blockIdx.y * kConvThreads + threadIdx.x;
  if (j >= D / V) return;
  const int d0 = j * V;
  const long long b = blockIdx.z;
  const long long t0 = (long long)blockIdx.x * T;
  const int steps = (int)min((long long)T, (long long)L - t0);
  const TX* xb = x + b * L * D + d0;
  TX* yb = y + b * L * D + d0;
  const bool first = t0 == 0;  // the halo comes from conv_state
  // Row i of the window is time t0 - (W - 1) + i.
  Raw<TX, V> in[T + W - 1];
#pragma unroll
  for (int i = 0; i < T + W - 1; ++i) {
    const long long s = t0 - (W - 1) + i;
    if (s >= 0 && s < L) in[i].load(xb + s * D);
  }
  float w[W][V], bv[V];
#pragma unroll
  for (int k = 0; k < W; ++k) load_f32<V>(weight + (long long)k * D + d0, w[k]);
  if (bias) {
    load_f32<V>(bias + d0, bv);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) bv[c] = 0.f;
  }
  const long long st = (b * D + d0) * W;  // (b, d0 + c, W + s) at st + c W + W + s
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (t >= steps) break;
    float out[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int i = t + k;  // window row: time t0 + t - (W - 1) + k
        const float v = (i < W - 1 && first) ? conv_state.at(st + c * W + 1 + i) : in[i].at(c);
        acc = k == 0 ? w[0][c] * v : __fmaf_rn(w[k][c], v, acc);
      }
      out[c] = finish(acc, bv[c], silu);
    }
    store_out<TX, V>(yb + (t0 + t) * D, out);
  }
}

// Any width: the window's rows (T + width - 1 of them) in batches of T
// loads; each row goes into every output of the tile it is a tap of, in
// tap order.
template <typename TX, int V, int T>
__global__ void __launch_bounds__(kConvThreads)
    causal_conv_any_kernel(const TX* __restrict__ x, State conv_state,
                           const float* __restrict__ weight, const float* __restrict__ bias,
                           TX* __restrict__ y, int L, int D, int W, int silu) {
  const int j = blockIdx.y * kConvThreads + threadIdx.x;
  if (j >= D / V) return;
  const int d0 = j * V;
  const long long b = blockIdx.z;
  const long long t0 = (long long)blockIdx.x * T;
  const int steps = (int)min((long long)T, (long long)L - t0);
  const TX* xb = x + b * L * D + d0;
  TX* yb = y + b * L * D + d0;
  const long long st = (b * D + d0) * W;
  const int rows = T + W - 1;
  float acc[T][V];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int c = 0; c < V; ++c) acc[t][c] = 0.f;
  }
  for (int base = 0; base < rows; base += T) {
    Raw<TX, V> in[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const long long s = t0 - (W - 1) + base + i;
      if (base + i < rows && s >= 0 && s < L) in[i].load(xb + s * D);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int r = base + i;
      if (r >= rows) break;
      const long long s = t0 - (W - 1) + r;
      if (s >= L) break;  // only outputs past the sequence use it
      float v[V];
#pragma unroll
      for (int c = 0; c < V; ++c) v[c] = s < 0 ? conv_state.at(st + c * W + W + s) : in[i].at(c);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int k = r - t;  // the tap row r is for output t
        if (k < 0 || k >= W) continue;
        float w[V];
        load_f32<V>(weight + (long long)k * D + d0, w);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          acc[t][c] = k == 0 ? w[c] * v[c] : __fmaf_rn(w[c], v[c], acc[t][c]);
        }
      }
    }
  }
  float bv[V];
  if (bias) {
    load_f32<V>(bias + d0, bv);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) bv[c] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (t >= steps) break;
    float out[V];
#pragma unroll
    for (int c = 0; c < V; ++c) out[c] = finish(acc[t][c], bv[c], silu);
    store_out<TX, V>(yb + (t0 + t) * D, out);
  }
}

template <typename TX, int V, int T>
cudaError_t causal_conv_fixed(const TX* x, State state, const float* weight, const float* bias,
                              TX* y, int L, int D, int W, int silu, dim3 grid, cudaStream_t s) {
  switch (W) {
    case 1:
      causal_conv_kernel<TX, V, 1, T><<<grid, kConvThreads, 0, s>>>(x, state, weight, bias, y,
                                                                    L, D, silu);
      break;
    case 2:
      causal_conv_kernel<TX, V, 2, T><<<grid, kConvThreads, 0, s>>>(x, state, weight, bias, y,
                                                                    L, D, silu);
      break;
    case 3:
      causal_conv_kernel<TX, V, 3, T><<<grid, kConvThreads, 0, s>>>(x, state, weight, bias, y,
                                                                    L, D, silu);
      break;
    default:
      causal_conv_kernel<TX, V, 4, T><<<grid, kConvThreads, 0, s>>>(x, state, weight, bias, y,
                                                                    L, D, silu);
  }
  return cudaGetLastError();
}

template <typename TX, int V>
cudaError_t causal_conv_v(const TX* x, State state, const float* weight, const float* bias,
                          TX* y, int batch, int L, int D, int W, int silu, int tile,
                          cudaStream_t s) {
  // Time tiles on x (neighbouring blocks share their halo rows in L2),
  // channel blocks on y, batch rows on z.
  const dim3 grid((L + tile - 1) / tile, (D / V + kConvThreads - 1) / kConvThreads, batch);
  if (W > 4) {
    causal_conv_any_kernel<TX, V, kConvTileAny><<<grid, kConvThreads, 0, s>>>(
        x, state, weight, bias, y, L, D, W, silu);
    return cudaGetLastError();
  }
  return causal_conv_fixed<TX, V, kConvTileFixed>(x, state, weight, bias, y, L, D, W, silu,
                                                  grid, s);
}

bool on_boundary(const void* p) { return p == nullptr || (unsigned long long)p % 16 == 0; }

}  // namespace

// x, y: (batch, L, D) contiguous, fp32 or bf16 (x_bf16); conv_state
// (batch, D, W), fp32 or bf16 (state_bf16); weight (W, D) and bias (D,)
// (may be null): fp32. Any W >= 1; silu: apply SiLU. vec and tile are the
// wrapper's plan (causal_conv_plan): vec 4 (fp32) or 8 (bf16) where D and
// the pointers allow it, else 1; tile 4 for W <= 4, 8 above. Another plan
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int vmt_causal_conv(const void* x, const void* conv_state, int state_bf16,
                               const float* weight, const float* bias, void* y,
                               int x_bf16, int batch, int L, int D, int W, int silu,
                               int vec, int tile, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || L == 0 || D == 0) return cudaSuccess;
  const int wide = x_bf16 ? 8 : 4;
  const bool vec_ok = vec == 1 || (vec == wide && D % wide == 0 && on_boundary(x) &&
                                   on_boundary(y) && on_boundary(weight) && on_boundary(bias));
  const bool tile_ok = tile == (W <= 4 ? kConvTileFixed : kConvTileAny);
  if (W < 1 || !vec_ok || !tile_ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  using vmt::bf16;
  const State st{state_bf16 ? nullptr : (const float*)conv_state,
                 state_bf16 ? (const bf16*)conv_state : nullptr};
  if (x_bf16) {
    const bf16* xb = (const bf16*)x;
    return (int)(vec == 1 ? causal_conv_v<bf16, 1>(xb, st, weight, bias, (bf16*)y, batch, L, D,
                                                   W, silu, tile, s)
                          : causal_conv_v<bf16, 8>(xb, st, weight, bias, (bf16*)y, batch, L, D,
                                                   W, silu, tile, s));
  }
  const float* xf = (const float*)x;
  return (int)(vec == 1 ? causal_conv_v<float, 1>(xf, st, weight, bias, (float*)y, batch, L, D,
                                                  W, silu, tile, s)
                        : causal_conv_v<float, 4>(xf, st, weight, bias, (float*)y, batch, L, D,
                                                  W, silu, tile, s));
}
