// One decode token through the whole layer stack for Hopper: Mamba-1 (K9)
// and, at the end of this file, Mamba-2 (K15).
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/decode_step.py
// (decode_stack_pallas -> _decode_kernel). Per layer k, for a token (B, E):
//   residual' = hidden + residual                          fp32
//   normed    = rms / layer norm(residual'), rounded to the weight dtype
//   xz        = normed Win_k^T; x_raw, z = split           fp32
//   x         = silu(conv over [conv_state_k[1:] || x_raw] + b); the window
//               rolls to [conv_state_k[1:] || x_raw]
//   x_dbl     = x Wx_k^T;  dt = softplus(x_dbl[:R] Wdt_k^T + dt_bias)
//   h_k       = exp(dt A) h_k + dt x B;  y = (C h_k + D x) silu(z)
//   hidden    = y Wout_k^T                                  fp32
// With bf16 weights every product's input (normed, x, x_dbl, y) is rounded
// to bf16 and the sum is fp32 (decode_step.py:134-184); fp32 weights take
// fp32 products, the JAX package's interpret-mode numbers. The states are
// stored in their own dtype, and the caller keeps hidden and residual in
// fp32 for the model's final norm.
//
// Design. The TPU kernel's grid is the layer axis, each step streaming one
// layer's weights into VMEM while the activations stay in scratch. Here each
// layer is four launches on one stream, each a hand-written GEMV or
// elementwise pass over (B, .) rows kept in fp32 device buffers between
// them (a few KB, in L2):
//   1. norm + in_proj + conv: every block recomputes the normed rows into
//      shared memory from hidden and residual, kDecBatch rows a pass, so
//      any batch fits (block 0 also writes residual'); one warp per output
//      row of Win, 16-byte weight loads,
//      the batch rows' sums in registers; x rows finish with the conv and
//      roll the window, z rows are stored;
//   2. x_proj: one warp per output row of Wx;
//   3. dt_proj + state update + gate: one thread per (b, channel), the
//      state row read and written once;
//   4. out_proj: one warp per output row of Wout, into hidden.
// residual' ping-pongs between two buffers so that no block reads a row
// another block of the same launch writes. Layer weights are read once per
// token, whatever the batch (up to kDecBatch rows per pass over them).
//
// What bounds it on the H100: device memory. Every weight crosses it once
// per token: about 90.5 M parameters at VideoMamba-Base, 362 MB at fp32 and
// 181 MB at bf16, 0.108 and 0.054 ms at 3.35 TB/s; none of it fits the
// 50 MB L2 across tokens. At B = 1 the 4 x depth launches are short, so the
// host's launch rate and the gaps between launches are the other bound (a
// persistent kernel or a CUDA graph would remove them).
#include "add_norm.cuh"
#include "scan_walk.cuh"

namespace {

using vmt::bf16;

constexpr int kDecWarps = 8;  // output rows per GEMV block
constexpr int kDecBatch = 8;  // batch rows per pass over the weights
constexpr int kStateThreads = 128;

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Eight consecutive weights from p (16-byte aligned) as fp32.
__device__ __forceinline__ void load8(const bf16* p, float (&w)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// acc[bb] = sum_k rnd(v[b0 + bb][k]) wrow[k] over the K columns (K a
// multiple of 8), for bb < nb; every lane ends with the warp's sums. Lanes
// take 8 consecutive columns each, 256 per warp step, and the lanes' sums
// are added in a fixed butterfly order.
template <typename TW>
__device__ __forceinline__ void row_dots(const float* v, long long ldv, int b0, int nb,
                                         const TW* __restrict__ wrow, int K, int lane,
                                         float (&acc)[kDecBatch]) {
#pragma unroll
  for (int bb = 0; bb < kDecBatch; ++bb) acc[bb] = 0.f;
  for (int k0 = lane * 8; k0 < K; k0 += 256) {
    float w[8];
    load8(wrow + k0, w);
#pragma unroll
    for (int bb = 0; bb < kDecBatch; ++bb) {
      if (bb < nb) {
        const float* vr = v + (long long)(b0 + bb) * ldv + k0;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[bb] += rnd<TW>(vr[i]) * w[i];
      }
    }
  }
#pragma unroll
  for (int bb = 0; bb < kDecBatch; ++bb) acc[bb] = vmt::warp_sum(acc[bb]);
}

// Launch 1: norm + in_proj + conv over the M rows of Win. Rows j in
// [conv_lo, conv_lo + C) are conv channels c = j - conv_lo: the raw input,
// then the conv into cy (B, C) and the rolled window (B, C, W); every other
// row's sum goes to raw[b * ld_raw + j - raw_off]. Mamba-1 (K9): the x rows
// [0, Di) are the channels and z = raw; Mamba-2 (K15): [x B C] at [Di, Di +
// CD) are the channels and raw keeps the z and dt rows in place.
template <typename TW, typename TS>
__global__ void __launch_bounds__(kDecWarps * 32) decode_in_kernel(
    const float* __restrict__ hid, const float* __restrict__ res_in,
    float* __restrict__ res_out, const float* __restrict__ norm_w,
    const float* __restrict__ norm_b, const TW* __restrict__ in_w, int M, int conv_lo,
    int C, const TW* __restrict__ conv_w, const float* __restrict__ conv_b,
    TS* __restrict__ conv_state, float* __restrict__ cy, float* __restrict__ raw,
    int ld_raw, int raw_off, int B, int E, int W, float eps, int is_rms) {
  extern __shared__ float normed[];  // (min(B, kDecBatch), E), rounded to TW
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float inv_e = 1.f / (float)E;
  const int j = blockIdx.x * kDecWarps + warp;
  // The batch goes kDecBatch rows at a time: each pass stages its rows'
  // norms in shared memory, so any batch fits.
  for (int b0 = 0; b0 < B; b0 += kDecBatch) {
    const int nb = min(kDecBatch, B - b0);
    if (b0 > 0) __syncthreads();  // every warp is done with the last pass's rows
    for (int bb = warp; bb < nb; bb += kDecWarps) {
      const long long b = b0 + bb;
      float* row = normed + (long long)bb * E;
      float s = 0.f;
      for (int e = lane; e < E; e += 32) {
        const float r = hid[b * E + e] + res_in[b * E + e];
        row[e] = r;
        if (blockIdx.x == 0) res_out[b * E + e] = r;
        s += is_rms ? r * r : r;
      }
      s = vmt::warp_sum(s);
      float mean = 0.f, var;
      if (is_rms) {
        var = s * inv_e;
      } else {
        mean = s * inv_e;
        float s2 = 0.f;
        for (int e = lane; e < E; e += 32) {
          const float c = row[e] - mean;
          s2 += c * c;
        }
        var = vmt::warp_sum(s2) * inv_e;
      }
      const float inv = 1.f / sqrtf(var + eps);
      for (int e = lane; e < E; e += 32) {
        float nv = (row[e] - mean) * inv * norm_w[e];
        if (norm_b) nv += norm_b[e];
        row[e] = rnd<TW>(nv);
      }
    }
    __syncthreads();
    if (j >= M) continue;
    float acc[kDecBatch];
    row_dots<TW>(normed, E, 0, nb, in_w + (long long)j * E, E, lane, acc);
    if (lane != 0) continue;
    const int ch = j - conv_lo;
    if (ch < 0 || ch >= C) {
#pragma unroll
      for (int bb = 0; bb < kDecBatch; ++bb)
        if (bb < nb) raw[(long long)(b0 + bb) * ld_raw + (j - raw_off)] = acc[bb];
      continue;
    }
    const TW* cw = conv_w + (long long)ch * W;
#pragma unroll
    for (int bb = 0; bb < kDecBatch; ++bb) {
      if (bb >= nb) continue;
      const float x_raw = acc[bb];
      TS* cs = conv_state + ((long long)(b0 + bb) * C + ch) * W;
      // The TPU kernel's order: window taps 1 .. W-1 oldest first, x_raw last.
      float c = W > 1 ? vmt::to_f32(cs[1]) * vmt::to_f32(cw[0]) : x_raw * vmt::to_f32(cw[0]);
      for (int w = 1; w < W; ++w) {
        const float tap = w == W - 1 ? x_raw : vmt::to_f32(cs[w + 1]);
        c += tap * vmt::to_f32(cw[w]);
      }
      c += conv_b[ch];
      cy[(long long)(b0 + bb) * C + ch] = c * (1.f / (1.f + expf(-c)));
      for (int w = 0; w < W - 1; ++w) cs[w] = cs[w + 1];
      cs[W - 1] = vmt::from_f32<TS>(x_raw);
    }
  }
}

// Launches 2 and 4: out[b, m] = sum_k rnd(v[b, k]) Wt[m, k], one warp per m.
template <typename TW>
__global__ void __launch_bounds__(kDecWarps * 32) decode_gemv_kernel(
    const float* __restrict__ v, const TW* __restrict__ wt, float* __restrict__ out,
    int B, int M, int K) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * kDecWarps + warp;
  if (m >= M) return;
  for (int b0 = 0; b0 < B; b0 += kDecBatch) {
    const int nb = min(kDecBatch, B - b0);
    float acc[kDecBatch];
    row_dots<TW>(v, K, b0, nb, wt + (long long)m * K, K, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int bb = 0; bb < kDecBatch; ++bb)
        if (bb < nb) out[(long long)(b0 + bb) * M + m] = acc[bb];
    }
  }
}

// Launch 3: dt_proj, softplus, the single-step state update and the gate,
// one thread per (b, d) over grid (ceil(Di / 128), B).
template <typename TW, typename TS>
__global__ void __launch_bounds__(kStateThreads) decode_state_kernel(
    const float* __restrict__ x_dbl, const TW* __restrict__ dt_w,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Dskip, const float* __restrict__ cy,
    const float* __restrict__ z, TS* __restrict__ ssm_state, float* __restrict__ y,
    int Di, int R, int N) {
  extern __shared__ float sx[];  // x_dbl row of batch b: [dt | B | C]
  const int P = R + 2 * N;
  const long long b = blockIdx.y;
  for (int i = threadIdx.x; i < P; i += kStateThreads) sx[i] = x_dbl[b * P + i];
  __syncthreads();
  const int d = blockIdx.x * kStateThreads + threadIdx.x;
  if (d >= Di) return;
  const TW* wr = dt_w + (long long)d * R;
  float dt = 0.f;
  for (int r = 0; r < R; ++r) dt += rnd<TW>(sx[r]) * vmt::to_f32(wr[r]);
  dt = vmt::softplus_f(dt + dt_bias[d]);
  const float xv = cy[b * Di + d];
  const float dx = dt * xv;
  TS* h = ssm_state + (b * Di + d) * N;
  const float* a = A + (long long)d * N;
  float yv = 0.f;
  for (int n = 0; n < N; ++n) {
    const float hn = expf(dt * a[n]) * vmt::to_f32(h[n]) + dx * sx[R + n];
    h[n] = vmt::from_f32<TS>(hn);
    yv += sx[R + N + n] * hn;
  }
  yv += Dskip[d] * xv;
  const float zz = z[b * Di + d];
  y[b * Di + d] = yv * (zz * (1.f / (1.f + expf(-zz))));
}

struct DecodeIO {
  float* hid;     // (B, E): the token in, each layer's output after
  float* res[2];  // (B, E) ping-pong: layer k reads res[k % 2]
  const float* norm_w;  // (K, E)
  const float* norm_b;  // (K, E) or null
  const void* in_w;     // (K, 2Di, E)
  const void* out_w;    // (K, E, Di)
  const void* conv_w;   // (K, Di, W)
  const float* conv_b;  // (K, Di)
  const void* x_proj_w;   // (K, P, Di)
  const void* dt_proj_w;  // (K, Di, R)
  const float* dt_bias;   // (K, Di)
  const float* A;         // (K, Di, N)
  const float* Dskip;     // (K, Di)
  void* conv_states;      // (K, B, Di, W)
  void* ssm_states;       // (K, B, Di, N)
  float* scratch;         // cy, z, y (B, Di) and x_dbl (B, P)
  int K, B, E, Di, W, R, N;
  float eps;
  int is_rms;
};

template <typename TW, typename TS>
cudaError_t decode_stack_t(const DecodeIO& io, cudaStream_t s) {
  const int B = io.B, E = io.E, Di = io.Di, W = io.W, R = io.R, N = io.N;
  const int P = R + 2 * N;
  float* cy = io.scratch;
  float* z = cy + (long long)B * Di;
  float* y = z + (long long)B * Di;
  float* x_dbl = y + (long long)B * Di;
  const size_t in_smem = (size_t)min(B, kDecBatch) * E * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_in_kernel<TW, TS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)in_smem);
  if (err != cudaSuccess) return err;
  const unsigned rows_in = (2 * Di + kDecWarps - 1) / kDecWarps;
  const unsigned rows_x = (P + kDecWarps - 1) / kDecWarps;
  const unsigned rows_out = (E + kDecWarps - 1) / kDecWarps;
  const dim3 grid_state((Di + kStateThreads - 1) / kStateThreads, B);
  for (int k = 0; k < io.K; ++k) {
    const TW* in_w = (const TW*)io.in_w + (long long)k * 2 * Di * E;
    const TW* out_w = (const TW*)io.out_w + (long long)k * E * Di;
    const TW* conv_w = (const TW*)io.conv_w + (long long)k * Di * W;
    const TW* x_proj_w = (const TW*)io.x_proj_w + (long long)k * P * Di;
    const TW* dt_w = (const TW*)io.dt_proj_w + (long long)k * Di * R;
    TS* cst = (TS*)io.conv_states + (long long)k * B * Di * W;
    TS* sst = (TS*)io.ssm_states + (long long)k * B * Di * N;
    decode_in_kernel<TW, TS><<<rows_in, kDecWarps * 32, in_smem, s>>>(
        io.hid, io.res[k % 2], io.res[(k + 1) % 2], io.norm_w + (long long)k * E,
        io.norm_b ? io.norm_b + (long long)k * E : nullptr, in_w, 2 * Di, 0, Di, conv_w,
        io.conv_b + (long long)k * Di, cst, cy, z, Di, Di, B, E, W, io.eps, io.is_rms);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    decode_gemv_kernel<TW><<<rows_x, kDecWarps * 32, 0, s>>>(cy, x_proj_w, x_dbl, B, P, Di);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    decode_state_kernel<TW, TS><<<grid_state, kStateThreads, P * sizeof(float), s>>>(
        x_dbl, dt_w, io.dt_bias + (long long)k * Di, io.A + (long long)k * Di * N,
        io.Dskip + (long long)k * Di, cy, z, sst, y, Di, R, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    decode_gemv_kernel<TW><<<rows_out, kDecWarps * 32, 0, s>>>(y, out_w, io.hid, B, E, Di);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Mamba-2 (K15): the same stack walk with the SSD mixer. Per layer:
//   1. norm + in_proj + conv (decode_in_kernel): Win's rows give z, the
//      [x B C] slab (conv + SiLU, the window rolled) and the dt rows;
//   2. the state update, one warp per (b, head, p) row of N states:
//      dt = softplus(dt_raw + dt_bias_h), h = exp(dt A_h) h + (dt x) B,
//      y = C . h + D_h x, gated = y silu(z);
//   3. gated RMSNorm + out_proj: each block recomputes the normed gated rows
//      (kDecBatch at a time) into shared memory, rounded to the weight
//      dtype, then one warp per output row of Wout.
// Replaces decode_stack_pallas_m2 -> _decode_kernel_m2 (videomamba_tpu/ops/
// pallas/decode_step.py), whose grid walks the layers with each layer's
// weights double-buffered in VMEM and its per-head scalars widened to lanes
// by a one-hot product; here a thread block indexes its head directly.
// Rounding as the TPU kernel's: normed and the normed gated rows round to
// the weight dtype before their products; the conv, the state update and
// the gate are fp32; the conv window keeps its dtype, the SSD state is fp32.
// What bounds it on the H100: device memory. Every weight crosses it once a
// token (about 88 M parameters at VideoMamba-Base-m2: 351 MB fp32, 176 MB
// bf16) and each layer's (H, P, N) state is read and written (24 x 64 x 64
// fp32, 393 KB a layer and batch row): 0.110 ms fp32 and 0.058 ms bf16 at
// B = 1 on 3.35 TB/s; at B = 1 the 3 x depth short launches too.

// Launch 2: grid (ceil(H P / kDecWarps), B). The SSD state is fp32 (the
// streaming contract's), whatever the conv window's dtype.
__global__ void __launch_bounds__(kDecWarps * 32) decode_m2_state_kernel(
    const float* __restrict__ raw, const float* __restrict__ cy,
    const float* __restrict__ A, const float* __restrict__ Dskip,
    const float* __restrict__ dt_bias, float* __restrict__ ssm_state,
    float* __restrict__ gated, int H, int P, int G, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Di = H * P, GN = G * N, CD = Di + 2 * GN, M = Di + CD + H;
  const int hp = blockIdx.x * kDecWarps + warp;
  if (hp >= Di) return;
  const long long b = blockIdx.y;
  const int h = hp / P;
  const int g = h / (H / G);
  const float* rb = raw + b * M;
  const float* cb = cy + b * CD;
  const float dt = vmt::softplus_f(rb[Di + CD + h] + dt_bias[h]);
  const float dA = expf(dt * A[h]);
  const float x = cb[hp];
  const float dx = dt * x;
  float* st = ssm_state + (b * Di + hp) * N;
  float acc = 0.f;
  for (int n = lane; n < N; n += 32) {
    const float hn = dA * st[n] + dx * cb[Di + g * N + n];
    st[n] = hn;
    acc += cb[Di + GN + g * N + n] * hn;
  }
  const float y = vmt::warp_sum(acc) + Dskip[h] * x;
  if (lane == 0) {
    const float z = rb[hp];
    gated[b * Di + hp] = y * (z * (1.f / (1.f + expf(-z))));
  }
}

// Launch 3: hid[b, m] = sum_d rnd(norm(gated[b])[d]) Wout[m, d].
template <typename TW>
__global__ void __launch_bounds__(kDecWarps * 32) decode_m2_out_kernel(
    const float* __restrict__ gated, const float* __restrict__ gate_w,
    const TW* __restrict__ out_w, float* __restrict__ hid, int B, int E, int Di,
    float gate_eps) {
  extern __shared__ float rows[];  // (min(B, kDecBatch), Di)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * kDecWarps + warp;
  for (int b0 = 0; b0 < B; b0 += kDecBatch) {
    const int nb = min(kDecBatch, B - b0);
    if (b0 > 0) __syncthreads();
    for (int bb = warp; bb < nb; bb += kDecWarps) {
      const float* g = gated + (long long)(b0 + bb) * Di;
      float* row = rows + (long long)bb * Di;
      float inv = 1.f;
      if (gate_w) {
        float ss = 0.f;
        for (int d = lane; d < Di; d += 32) ss += g[d] * g[d];
        inv = 1.f / sqrtf(vmt::warp_sum(ss) / (float)Di + gate_eps);
      }
      for (int d = lane; d < Di; d += 32)
        row[d] = rnd<TW>(gate_w ? g[d] * inv * gate_w[d] : g[d]);
    }
    __syncthreads();
    if (m >= E) continue;
    float acc[kDecBatch];
    row_dots<TW>(rows, Di, 0, nb, out_w + (long long)m * Di, Di, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int bb = 0; bb < kDecBatch; ++bb)
        if (bb < nb) hid[(long long)(b0 + bb) * E + m] = acc[bb];
    }
  }
}

struct DecodeM2IO {
  float* hid;
  float* res[2];
  const float* norm_w;  // (K, E)
  const float* norm_b;  // (K, E) or null
  const void* in_w;     // (K, M, E), M = 2 Di + 2 G N + H
  const void* out_w;    // (K, E, Di)
  const void* conv_w;   // (K, CD, W)
  const float* conv_b;  // (K, CD)
  const float* A;       // (K, H)
  const float* Dskip;   // (K, H)
  const float* dt_bias; // (K, H)
  const float* gate_w;  // (K, Di) or null: no gated RMSNorm
  void* conv_states;    // (K, B, CD, W)
  float* ssm_states;    // (K, B, H, P, N)
  float* scratch;       // raw (B, M), cy (B, CD), gated (B, Di)
  int K, B, E, H, P, G, N, W;
  float eps;
  int is_rms;
  float gate_eps;
};

template <typename TW, typename TC>
cudaError_t decode_stack_m2_t(const DecodeM2IO& io, cudaStream_t s) {
  const int B = io.B, E = io.E, H = io.H, P = io.P, N = io.N, W = io.W;
  const int Di = H * P, CD = Di + 2 * io.G * N, M = Di + CD + H;
  float* raw = io.scratch;
  float* cy = raw + (long long)B * M;
  float* gated = cy + (long long)B * CD;
  const size_t in_smem = (size_t)min(B, kDecBatch) * E * sizeof(float);
  const size_t out_smem = (size_t)min(B, kDecBatch) * Di * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_in_kernel<TW, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)in_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(decode_m2_out_kernel<TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)out_smem);
  if (err != cudaSuccess) return err;
  const unsigned rows_in = (M + kDecWarps - 1) / kDecWarps;
  const dim3 grid_state((Di + kDecWarps - 1) / kDecWarps, B);
  const unsigned rows_out = (E + kDecWarps - 1) / kDecWarps;
  for (int k = 0; k < io.K; ++k) {
    const TW* in_w = (const TW*)io.in_w + (long long)k * M * E;
    const TW* out_w = (const TW*)io.out_w + (long long)k * E * Di;
    const TW* conv_w = (const TW*)io.conv_w + (long long)k * CD * W;
    TC* cst = (TC*)io.conv_states + (long long)k * B * CD * W;
    float* sst = io.ssm_states + (long long)k * B * Di * N;
    decode_in_kernel<TW, TC><<<rows_in, kDecWarps * 32, in_smem, s>>>(
        io.hid, io.res[k % 2], io.res[(k + 1) % 2], io.norm_w + (long long)k * E,
        io.norm_b ? io.norm_b + (long long)k * E : nullptr, in_w, M, Di, CD, conv_w,
        io.conv_b + (long long)k * CD, cst, cy, raw, M, 0, B, E, W, io.eps, io.is_rms);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    decode_m2_state_kernel<<<grid_state, kDecWarps * 32, 0, s>>>(
        raw, cy, io.A + (long long)k * H, io.Dskip + (long long)k * H,
        io.dt_bias + (long long)k * H, sst, gated, H, P, io.G, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    decode_m2_out_kernel<TW><<<rows_out, kDecWarps * 32, out_smem, s>>>(
        gated, io.gate_w ? io.gate_w + (long long)k * Di : nullptr, out_w, io.hid, B, E, Di,
        io.gate_eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// hid (B, E) fp32: the token on entry, the last layer's output on return;
// res0, res1 (B, E) fp32: res0 the incoming residual (zeros), the final
// residual in res[K % 2]. Stacked weights: norm_w, norm_b (may be null)
// (K, E) fp32; in_w (K, 2Di, E), out_w (K, E, Di), conv_w (K, Di, W),
// x_proj_w (K, R + 2N, Di), dt_proj_w (K, Di, R) in the weight dtype
// (w_bf16); conv_b, dt_bias, Dskip (K, Di), A (K, Di, N): fp32. States
// conv_states (K, B, Di, W) and ssm_states (K, B, Di, N), updated in place,
// in one dtype (s_bf16). scratch: 3 B Di + B (R + 2N) fp32. E and Di
// multiples of 8, all contiguous.
extern "C" int vmt_decode_stack(
    float* hid, float* res0, float* res1, const float* norm_w, const float* norm_b,
    const void* in_w, const void* out_w, const void* conv_w, const float* conv_b,
    const void* x_proj_w, const void* dt_proj_w, const float* dt_bias, const float* A,
    const float* Dskip, void* conv_states, void* ssm_states, float* scratch, int w_bf16,
    int s_bf16, int K, int B, int E, int Di, int W, int R, int N, float eps, int is_rms,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E % 8 || Di % 8) return (int)cudaErrorInvalidValue;
  if (K == 0 || B == 0) return cudaSuccess;
  DecodeIO io{hid, {res0, res1}, norm_w, norm_b, in_w, out_w, conv_w, conv_b, x_proj_w,
              dt_proj_w, dt_bias, A, Dskip, conv_states, ssm_states, scratch,
              K, B, E, Di, W, R, N, eps, is_rms};
  const cudaStream_t s = (cudaStream_t)stream;
  if (w_bf16) {
    err = s_bf16 ? decode_stack_t<bf16, bf16>(io, s) : decode_stack_t<bf16, float>(io, s);
  } else {
    err = s_bf16 ? decode_stack_t<float, bf16>(io, s) : decode_stack_t<float, float>(io, s);
  }
  return (int)err;
}

// Mamba-2 (K15). hid, res0, res1 as vmt_decode_stack's. Stacked weights:
// norm_w, norm_b (may be null) (K, E) fp32; in_w (K, 2Di + 2GN + H, E),
// out_w (K, E, Di), conv_w (K, CD, W) in the weight dtype (w_bf16); conv_b
// (K, CD), A, Dskip, dt_bias (K, H), gate_w (K, Di) or null: fp32. States,
// updated in place: conv_states (K, B, CD, W) fp32 or bf16 (c_bf16),
// ssm_states (K, B, H, P, N) fp32. scratch: B (2Di + 2GN + H + CD + Di)
// fp32. E a multiple of 8, Di = H P a multiple of 8, G dividing H;
// contiguous.
extern "C" int vmt_decode_stack_m2(
    float* hid, float* res0, float* res1, const float* norm_w, const float* norm_b,
    const void* in_w, const void* out_w, const void* conv_w, const float* conv_b,
    const float* A, const float* Dskip, const float* dt_bias, const float* gate_w,
    void* conv_states, float* ssm_states, float* scratch, int w_bf16, int c_bf16, int K,
    int B, int E, int H, int P, int G, int N, int W, float eps, int is_rms, float gate_eps,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E % 8 || (H * P) % 8 || G <= 0 || H % G) return (int)cudaErrorInvalidValue;
  if (K == 0 || B == 0) return cudaSuccess;
  DecodeM2IO io{hid, {res0, res1}, norm_w, norm_b, in_w, out_w, conv_w, conv_b, A, Dskip,
                dt_bias, gate_w, conv_states, ssm_states, scratch, K, B, E, H, P, G, N, W,
                eps, is_rms, gate_eps};
  const cudaStream_t s = (cudaStream_t)stream;
  if (w_bf16) {
    err = c_bf16 ? decode_stack_m2_t<bf16, bf16>(io, s) : decode_stack_m2_t<bf16, float>(io, s);
  } else {
    err = c_bf16 ? decode_stack_m2_t<float, bf16>(io, s) : decode_stack_m2_t<float, float>(io, s);
  }
  return (int)err;
}
