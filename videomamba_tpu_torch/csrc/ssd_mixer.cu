// Mamba-2 (SSD) mixer core for Hopper (K12): conv + SiLU over the [x B C]
// slab, the SSD chunk walk, the D skip, the silu(z) gate, the gated RMSNorm.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/ssd_scan.py
// (ssd_mixer_pallas: _ssd_mixer_padded -> _ssd_kernel per head, and
// _ssd_mixer_fwd_merged -> _ssd_mixer_fwd_merged_kernel). Per chunk of Q
// steps, head h (group g) and batch row b, with s the inclusive cumsum of
// dt * A inside the chunk and h_in the state entering it:
//   cy       = silu(conv over [window || raw x B C] + bias)       fp32
//   m[q, k]  = rnd(C_q . B_k * exp(s_q - s_k) * dt_k), k <= q
//   y[q]     = sum_k m[q, k] x_k + exp(s_q) * C_q . rnd(h_in) + D_h x_f[q]
//   h_out    = exp(s_last) h_in + sum_k rnd(x_f[k] dt_k exp(s_last - s_k)) B_k
//   out      = rnd(norm(y * silu(z)))
// rnd() rounds to the compute dtype T (bf16 or none); x, B and C enter the
// products rounded; every sum is fp32; the state stays fp32 between chunks.
// These are the merged arm's rounding points (_merged_scan_fwd_core), the
// JAX default.
//
// Design. The TPU grid is (B, L / Q) with the chunk axis walked in order and
// the state in VMEM, which on Hopper would be one block per batch row. The
// walk is split by state passing into five launches on one stream:
//   1. conv + SiLU over the slab (mixer_parts.cuh's conv_silu, the window's
//      last W - 1 raw inputs as left context), into cy;
//   2. per (chunk, head, batch) block: the chunk's own state S_c =
//      sum_k rnd(x_f w)_k^T B_k (4 x 4 register tiles from shared memory,
//      the chunk's rows staged 64 at a time);
//   3. per (head, batch, 256 state elements) block: the short sequential
//      pass over the chunks, h_c = exp(s_last) h_{c-1} + S_c, leaving each
//      chunk's entry state in place of S_c, and h_last;
//   4. per (64 rows of a chunk, head, batch) block: the causal 64 x 64
//      tiles of m in shared memory, one k slab after another, then y = m x
//      + (C h_in^T) e^s + D x_f for its rows;
//   5. per row (a warp each): the gate and the norm, which spans every head
//      of the row.
// Shared memory grows with the chunk only by its s and dt: at
// VideoMamba-Base-m2 (Q 128,
// H 24, P = N = 64, L 1569) launch 4 runs 26 x 24 = 624 blocks at B = 1 of
// 97 KB each; chunk 256 or d_state 128 take 98-146 KB. Every sum still runs
// over k (and n) in order, as with the whole chunk in one block.
//
// What bounds it on the H100: operations, the (Q, Q) and (Q, P) tiles'
// products (about 1.0 GFLOP at Base, B = 1: 0.015 ms at 67 TFLOP/s), over
// the bytes of its inputs and outputs (about 30 MB, 0.009 ms). The tiles
// are FMA at both dtypes (operands rounded first, so bf16's products are
// exact); mma.sync / wgmma tiles are later work.
#include "mixer_parts.cuh"
#include "ssd_core.cuh"

namespace {

using vmt::bf16;

constexpr int kSsdThreads = 256;
constexpr int kSlab = vmt::kSsdSlab;  // chunk rows a shared-memory slab holds
constexpr int kGateWarps = 8;

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Launch 2: S_c[p, n] = sum_k rnd(x_f[k, p] dt_k exp(s_last - s_k)) rnd(B[k, n]),
// grid (nc, H, B), into hin at chunk c. The chunk's rows are staged kSlab at
// a time; each thread carries its 4 x 4 tiles of S_c in hin from one slab to
// the next, so the sums run over k in order whatever the chunk length.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_state_kernel(vmt::SsdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, Q = a.Q, P = a.P, N = a.N, H = a.H;
  const int Di = H * P, CD = Di + 2 * a.G * N;
  const int g = h / (H / a.G);
  const long long Lp = (long long)nc * Q;
  const int t0 = c * Q;
  const int valid = min(Q, a.L - t0);
  float* xw = sm;              // [kSlab][P]
  float* bs = xw + kSlab * P;  // [kSlab][N]
  const float* sb = a.s + (long long)b * Lp * H;
  const float* db = a.dt + (long long)b * Lp * H;
  const float s_last = sb[(long long)(t0 + Q - 1) * H + h];
  float* S = a.hin + (((long long)b * nc + c) * H + h) * P * N;
  const int tn = N / 4;
  for (int k_lo = 0; k_lo < valid; k_lo += kSlab) {
    const int kn = min(kSlab, valid - k_lo);
    const float* cyb = a.cy + ((long long)b * a.L + t0 + k_lo) * CD;
    for (int i = threadIdx.x; i < kn * P; i += kSsdThreads) {
      const int k = i / P, p = i % P;
      const long long t = t0 + k_lo + k;
      const float w = db[t * H + h] * expf(s_last - sb[t * H + h]);
      xw[i] = rnd<T>(cyb[(long long)k * CD + h * P + p] * w);
    }
    for (int i = threadIdx.x; i < kn * N; i += kSsdThreads) {
      const int k = i / N, n = i % N;
      bs[i] = rnd<T>(cyb[(long long)k * CD + Di + g * N + n]);
    }
    __syncthreads();
    for (int tile = threadIdx.x; tile < (P / 4) * tn; tile += kSsdThreads) {
      const int p0 = (tile / tn) * 4, n0 = (tile % tn) * 4;
      float acc[4][4] = {};
      if (k_lo > 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = ld4(S + (long long)(p0 + i) * N + n0);
          acc[i][0] = v.x; acc[i][1] = v.y; acc[i][2] = v.z; acc[i][3] = v.w;
        }
      }
      for (int k = 0; k < kn; ++k) fma4x4(acc, ld4(xw + k * P + p0), ld4(bs + k * N + n0));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st4(S + (long long)(p0 + i) * N + n0, acc[i]);
    }
    __syncthreads();
  }
}

// Launch 3: the sequential pass over chunks, one thread per state element
// of a (head, batch), grid (H, B, ceil(P N / kSsdThreads)): each chunk's
// S_c is replaced by the state entering it; h_last is the state after all.
__global__ void __launch_bounds__(kSsdThreads) ssd_state_pass_kernel(vmt::SsdArgs a, int nc) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H, PN = a.P * a.N;
  const long long Lp = (long long)nc * a.Q;
  const int i = blockIdx.z * kSsdThreads + threadIdx.x;
  if (i < PN) {
    float st = a.h0[((long long)b * H + h) * PN + i];
    for (int c = 0; c < nc; ++c) {
      float* S = a.hin + (((long long)b * nc + c) * H + h) * PN + i;
      const float dec = expf(a.s[((long long)b * Lp + (long long)c * a.Q + a.Q - 1) * H + h]);
      const float sc = *S;
      *S = st;
      st = dec * st + sc;
    }
    a.h_last[((long long)b * H + h) * PN + i] = st;
  }
}

// Launch 4: y for kSlab rows of a chunk, grid (nc * ceil(Q / kSlab), H, B).
// The block walks the chunk's causal k slabs up to its own rows: per slab
// the (kSlab, kSlab) tile of m in shared memory, then m x added into the
// rows' sums (ys), k in order; then the inter-chunk term and the D skip.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_out_kernel(vmt::SsdArgs a, int nqs) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x / nqs, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / nqs, Q = a.Q, P = a.P, N = a.N, H = a.H;
  const int Di = H * P, CD = Di + 2 * a.G * N, GN = a.G * N;
  const int g = h / (H / a.G);
  const long long Lp = (long long)nc * Q;
  const int t0 = c * Q;
  const int valid = min(Q, a.L - t0);
  const int q_lo = (blockIdx.x % nqs) * kSlab;
  if (q_lo >= valid) return;  // the whole block: before any barrier
  const int q_end = min(q_lo + kSlab, valid);
  float* cs = sm;                  // [N][kSlab] rnd(C) of the block's rows, transposed
  float* bsT = cs + N * kSlab;     // [N][kSlab] rnd(B) of a k slab, transposed
  float* mT = bsT + N * kSlab;     // [kSlab (k)][kSlab (q)] m, transposed
  float* xs = mT + kSlab * kSlab;  // [kSlab][P] rnd(x) of a k slab
  float* hs = xs + kSlab * P;      // [N][P] rnd(h_in), transposed
  float* ys = hs + N * P;          // [kSlab][P] the rows' intra-chunk sums
  float* ss = ys + kSlab * P;      // [Q] s
  float* ds = ss + Q;              // [Q] dt
  const float* cyb = a.cy + ((long long)b * a.L + t0) * CD;
  for (int i = threadIdx.x; i < kSlab * N; i += kSsdThreads) {
    const int q = i / N, n = i % N;
    cs[n * kSlab + q] = q_lo + q < valid
        ? rnd<T>(cyb[(long long)(q_lo + q) * CD + Di + GN + g * N + n]) : 0.f;
  }
  const float* hin = a.hin + (((long long)b * nc + c) * H + h) * P * N;
  for (int i = threadIdx.x; i < P * N; i += kSsdThreads) {
    const int p = i / N, n = i % N;
    hs[n * P + p] = rnd<T>(hin[i]);
  }
  for (int i = threadIdx.x; i < kSlab * P; i += kSsdThreads) ys[i] = 0.f;
  for (int i = threadIdx.x; i < Q; i += kSsdThreads) {
    ss[i] = a.s[((long long)b * Lp + t0 + i) * H + h];
    ds[i] = a.dt[((long long)b * Lp + t0 + i) * H + h];
  }

  const int tq = kSlab / 4, tp = P / 4;
  for (int k_lo = 0; k_lo < q_end; k_lo += kSlab) {
    const int kn = min(kSlab, valid - k_lo);
    for (int i = threadIdx.x; i < kSlab * N; i += kSsdThreads) {
      const int k = i / N, n = i % N;
      bsT[n * kSlab + k] = k < kn ? rnd<T>(cyb[(long long)(k_lo + k) * CD + Di + g * N + n])
                                  : 0.f;
    }
    for (int i = threadIdx.x; i < kSlab * P; i += kSsdThreads) {
      const int k = i / P, p = i % P;
      xs[i] = k < kn ? rnd<T>(cyb[(long long)(k_lo + k) * CD + h * P + p]) : 0.f;
    }
    __syncthreads();

    // Lanes of a warp take neighbouring q0 (one k0), so the transposed
    // stores of m spread over the banks.
    for (int tile = threadIdx.x; tile < tq * tq; tile += kSsdThreads) {
      const int q0 = (tile % tq) * 4, k0 = (tile / tq) * 4;
      float acc[4][4] = {};
      if (k_lo + k0 <= q_lo + q0 + 3) {
        for (int n = 0; n < N; ++n)
          fma4x4(acc, ld4(cs + n * kSlab + q0), ld4(bsT + n * kSlab + k0));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = q_lo + q0 + i, k = k_lo + k0 + j;
          mT[(k0 + j) * kSlab + q0 + i] =
              k <= q && q < valid ? rnd<T>(acc[i][j] * expf(ss[q] - ss[k]) * ds[k]) : 0.f;
        }
      }
    }
    __syncthreads();

    for (int tile = threadIdx.x; tile < tq * tp; tile += kSsdThreads) {
      const int q0 = (tile / tp) * 4, p0 = (tile % tp) * 4;
      const int kend = min(min(q_lo + q0 + 4, valid) - k_lo, kn);
      if (q_lo + q0 >= valid || kend <= 0) continue;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = ld4(ys + (q0 + i) * P + p0);
        acc[i][0] = v.x; acc[i][1] = v.y; acc[i][2] = v.z; acc[i][3] = v.w;
      }
      for (int k = 0; k < kend; ++k)
        fma4x4(acc, ld4(mT + k * kSlab + q0), ld4(xs + k * P + p0));
#pragma unroll
      for (int i = 0; i < 4; ++i) st4(ys + (q0 + i) * P + p0, acc[i]);
    }
    __syncthreads();
  }

  const float dh = a.Dskip[h];
  for (int tile = threadIdx.x; tile < tq * tp; tile += kSsdThreads) {
    const int q0 = (tile / tp) * 4, p0 = (tile % tp) * 4;
    if (q_lo + q0 >= valid) continue;
    float inter[4][4] = {};
    for (int n = 0; n < N; ++n) fma4x4(inter, ld4(cs + n * kSlab + q0), ld4(hs + n * P + p0));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q_lo + q0 + i;
      if (q >= valid) continue;
      const float es = expf(ss[q]);
      const float4 xq = ld4(cyb + (long long)q * CD + h * P + p0);
      const float4 yq = ld4(ys + (q0 + i) * P + p0);
      const float xf[4] = {xq.x, xq.y, xq.z, xq.w};
      const float acc[4] = {yq.x, yq.y, yq.z, yq.w};
      float yv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) yv[j] = acc[j] + inter[i][j] * es + dh * xf[j];
      st4(a.y + ((long long)b * a.L + t0 + q) * Di + h * P + p0, yv);
    }
  }
}

// Launch 5: out = rnd(norm(y * silu(z))), one warp a row.
template <typename T>
__global__ void __launch_bounds__(kGateWarps * 32) ssd_gate_kernel(vmt::SsdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kGateWarps + warp;
  if (row >= (long long)a.B * a.L) return;
  const int Di = a.H * a.P;
  const float* yr = a.y + row * Di;
  const T* zr = (const T*)a.zx + row * a.ld_zx;
  T* o = (T*)a.out + row * Di;
  float inv = 1.f;
  if (a.norm_w) {
    float ss = 0.f;
    for (int d = lane; d < Di; d += 32) {
      const float z = vmt::to_f32(zr[d]);
      const float gv = yr[d] * (z * (1.f / (1.f + expf(-z))));
      ss += gv * gv;
    }
    inv = 1.f / sqrtf(vmt::warp_sum(ss) / (float)Di + a.eps);
  }
  for (int d = lane; d < Di; d += 32) {
    const float z = vmt::to_f32(zr[d]);
    float gv = yr[d] * (z * (1.f / (1.f + expf(-z))));
    if (a.norm_w) gv = gv * inv * a.norm_w[d];
    o[d] = vmt::from_f32<T>(gv);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

namespace vmt {

cudaError_t ssd_check(const SsdArgs& a) {
  if (a.P % 4 || a.N % 4 || a.Q <= 0 || a.G <= 0 || a.H % a.G ||
      ssd_out_smem_bytes(a.Q, a.P, a.N) > 232448)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
cudaError_t ssd_core(const SsdArgs& a, cudaStream_t s) {
  cudaError_t err = ssd_check(a);
  if (err != cudaSuccess) return err;
  const int Di = a.H * a.P, CD = Di + 2 * a.G * a.N;
  const int nc = (a.L + a.Q - 1) / a.Q;
  err = conv_silu<T, float>((const T*)a.zx + Di, a.ld_zx, a.conv_state, a.conv_w, a.conv_b,
                            a.cy, a.B, a.L, CD, a.W, s);
  if (err != cudaSuccess) return err;
  const dim3 chunks(nc, a.H, a.B);
  const size_t state_smem = sizeof(float) * (size_t)kSlab * (a.P + a.N);
  if ((err = set_smem(ssd_chunk_state_kernel<T>, state_smem)) != cudaSuccess) return err;
  ssd_chunk_state_kernel<T><<<chunks, kSsdThreads, state_smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned pn_blocks = (unsigned)((a.P * a.N + kSsdThreads - 1) / kSsdThreads);
  ssd_state_pass_kernel<<<dim3(a.H, a.B, pn_blocks), kSsdThreads, 0, s>>>(a, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t out_smem = ssd_out_smem_bytes(a.Q, a.P, a.N);
  if ((err = set_smem(ssd_chunk_out_kernel<T>, out_smem)) != cudaSuccess) return err;
  const int nqs = (a.Q + kSlab - 1) / kSlab;
  ssd_chunk_out_kernel<T><<<dim3(nc * nqs, a.H, a.B), kSsdThreads, out_smem, s>>>(a, nqs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rows = (long long)a.B * a.L;
  ssd_gate_kernel<T><<<(unsigned)((rows + kGateWarps - 1) / kGateWarps), kGateWarps * 32,
                        0, s>>>(a);
  return cudaGetLastError();
}

template cudaError_t ssd_core<float>(const SsdArgs&, cudaStream_t);
template cudaError_t ssd_core<bf16>(const SsdArgs&, cudaStream_t);

}  // namespace vmt

// zx (B * L rows of ld_zx) fp32 or bf16 (is_bf16): z at column 0, [x B C] at
// H * P; out (B, L, H * P) in zx's dtype. conv_state (B, CD, W) rounded to
// zx's dtype, conv_w (CD, W), conv_b (CD,), s and dt (B, Lp, H) with Lp = Q
// ceil(L / Q), Dskip (H,), norm_w (H * P,) or null, h0 / h_last (B, H, P, N):
// fp32, contiguous. Scratch (fp32): cy B L CD, y B L H P, hin B nc H P N.
extern "C" int vmt_ssd_mixer(const void* zx, long long ld_zx, void* out,
                             const float* conv_state, const float* conv_w,
                             const float* conv_b, const float* s, const float* dt,
                             const float* Dskip, const float* norm_w, const float* h0,
                             float* h_last, float* cy, float* y, float* hin, int B, int L,
                             int Q, int H, int P, int G, int N, int W, float eps,
                             int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vmt::SsdArgs a{zx, ld_zx, out, conv_state, conv_w, conv_b, s, dt, Dskip, norm_w,
                       h0, h_last, cy, y, hin, B, L, Q, H, P, G, N, W, eps};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? vmt::ssd_core<bf16>(a, st) : vmt::ssd_core<float>(a, st));
}
