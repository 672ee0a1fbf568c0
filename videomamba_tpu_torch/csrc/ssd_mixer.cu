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
//      one 64 x 64 (P, N) tile of S_c at a time, the chunk's rows staged 64
//      at a time);
//   3. per (head, batch, 256 state elements) block: the short sequential
//      pass over the chunks, h_c = exp(s_last) h_{c-1} + S_c, leaving each
//      chunk's entry state in place of S_c, and h_last;
//   4. per (64 rows of a chunk, 64 head-dim columns, head, batch) block:
//      the causal 64 x 64 tiles of m in shared memory (C B^T summed over
//      64-wide N tiles), one k slab after another, then y = m x + (C
//      h_in^T) e^s + D x_f for its rows and columns;
//   5. per row (a warp each): the gate and the norm, which spans every head
//      of the row.
// Shared memory grows with the chunk only by its s and dt, and not with P or
// N: at VideoMamba-Base-m2 (Q 128, H 24, P = N = 64, L 1569) launch 4 runs
// 26 x 24 = 624 blocks at B = 1 of 97 KB each; chunk 256, d_state 128 and
// P = N = 256 take 97-98 KB (a wider P runs more blocks, each recomputing
// its rows' m). Every sum still runs over k (and n) in order.
//
// K11's forward (vmt_ssd_scan) is launches 2-4 over x, B and C given as
// fp32 rows, without a D skip. With the walk's hin and y buffers kept, the
// mixer's training forward has its checkpoints (hins, yd) for free.
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
constexpr int kSlab = vmt::kSsdSlab;  // chunk rows a shared-memory slab holds; P and N tile
constexpr int kGateWarps = 8;

using vmt::fma4x4;
using vmt::ld4;
using vmt::rnd;

// Launch 2: S_c[p, n] = sum_k rnd(x_f[k, p] dt_k exp(s_last - s_k)) rnd(B[k, n]),
// grid (nc, H, B), into hin at chunk c. One 64 x 64 (P, N) tile of S_c at a
// time, one 4 x 4 register tile a thread, the chunk's rows staged kSlab at a
// time, so the sums run over k in order whatever the chunk and state sizes.
// A row's weight dt_k exp(s_last - s_k) is taken once a slab, and each
// thread writes its tile's rows of S_c as float4.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_state_kernel(vmt::SsdArgs a) {
  __shared__ __align__(16) float xw[kSlab * kSlab];  // [k][p]
  __shared__ __align__(16) float bs[kSlab * kSlab];  // [k][n]
  __shared__ float ws[kSlab];                        // [k] the rows' weights
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, Q = a.Q, P = a.P, N = a.N, H = a.H;
  const int Di = H * P, CD = Di + 2 * a.G * N;
  const int g = h / (H / a.G);
  const long long Lp = (long long)nc * Q;
  const int t0 = c * Q;
  const int valid = min(Q, a.L - t0);
  const float* sb = a.s + (long long)b * Lp * H;
  const float* db = a.dt + (long long)b * Lp * H;
  const float s_last = sb[(long long)(t0 + Q - 1) * H + h];
  float* S = a.hin + (((long long)b * nc + c) * H + h) * P * N;
  const int p0 = (threadIdx.x / 16) * 4, n0 = (threadIdx.x % 16) * 4;
  for (int p_lo = 0; p_lo < P; p_lo += kSlab) {
    const int pw = min(kSlab, P - p_lo);
    for (int n_lo = 0; n_lo < N; n_lo += kSlab) {
      const int nw = min(kSlab, N - n_lo);
      float acc[4][4] = {};
      for (int k_lo = 0; k_lo < valid; k_lo += kSlab) {
        const int kn = min(kSlab, valid - k_lo);
        const float* cyb = a.cy + ((long long)b * a.L + t0 + k_lo) * CD;
        if (threadIdx.x < kn) {
          const long long t = t0 + k_lo + threadIdx.x;
          ws[threadIdx.x] = db[t * H + h] * expf(s_last - sb[t * H + h]);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < kSlab * kSlab; i += kSsdThreads) {
          const int k = i / kSlab, j = i % kSlab;
          float xv = 0.f, bv = 0.f;
          if (k < kn) {
            if (j < pw) xv = rnd<T>(cyb[(long long)k * CD + h * P + p_lo + j] * ws[k]);
            if (j < nw) bv = rnd<T>(cyb[(long long)k * CD + Di + g * N + n_lo + j]);
          }
          xw[i] = xv;
          bs[i] = bv;
        }
        __syncthreads();
        if (p0 < pw && n0 < nw)
          for (int k = 0; k < kn; ++k)
            fma4x4(acc, ld4(xw + k * kSlab + p0), ld4(bs + k * kSlab + n0));
        __syncthreads();
      }
      if (p0 < pw && n0 < nw) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(S + (long long)(p_lo + p0 + i) * N + n_lo + n0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
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

// Launch 4: y for kSlab rows and kSlab head-dim columns of a chunk, grid
// (nc * nqs * npt, H, B). The block walks the chunk's causal k slabs up to
// its own rows: per slab the (kSlab, kSlab) tile of m in shared memory (its
// C B^T summed over kSlab-wide N tiles in a thread's registers), then m x
// added into the rows' sums (ys), k in order; then the inter-chunk term
// (over the same N tiles) and the D skip.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_out_kernel(vmt::SsdArgs a, int nqs,
                                                                    int npt) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x / (nqs * npt), h = blockIdx.y, b = blockIdx.z;
  const int q_lo = ((blockIdx.x / npt) % nqs) * kSlab;
  const int p_lo = (blockIdx.x % npt) * kSlab;
  const int nc = gridDim.x / (nqs * npt), Q = a.Q, P = a.P, N = a.N, H = a.H;
  const int Di = H * P, CD = Di + 2 * a.G * N, GN = a.G * N;
  const int g = h / (H / a.G);
  const long long Lp = (long long)nc * Q;
  const int t0 = c * Q;
  const int valid = min(Q, a.L - t0);
  if (q_lo >= valid) return;  // the whole block: before any barrier
  const int q_end = min(q_lo + kSlab, valid);
  const int pw = min(kSlab, P - p_lo);
  float* cs = sm;                  // [n][q] rnd(C) of the block's rows, an N tile
  float* bsT = cs + kSlab * kSlab;  // [n][k] rnd(B) of a k slab, an N tile
  float* mT = bsT + kSlab * kSlab;  // [k][q] m, transposed
  float* xs = mT + kSlab * kSlab;   // [k][p] rnd(x) of a k slab, a P tile
  float* hs = xs + kSlab * kSlab;   // [n][p] rnd(h_in), an (N, P) tile
  float* ys = hs + kSlab * kSlab;   // [q][p] the rows' intra-chunk sums
  float* ss = ys + kSlab * kSlab;   // [Q] s
  float* ds = ss + Q;               // [Q] dt
  const float* cyb = a.cy + ((long long)b * a.L + t0) * CD;
  for (int i = threadIdx.x; i < kSlab * kSlab; i += kSsdThreads) ys[i] = 0.f;
  for (int i = threadIdx.x; i < Q; i += kSsdThreads) {
    ss[i] = a.s[((long long)b * Lp + t0 + i) * H + h];
    ds[i] = a.dt[((long long)b * Lp + t0 + i) * H + h];
  }

  const int tq = kSlab / 4, tp = pw / 4;
  // The block's rnd(C) rows of an N tile; with one N tile (N <= kSlab) they
  // are staged once for every k slab and the inter-chunk term.
  const bool one_n_tile = N <= kSlab;
  auto stage_c = [&](int n_lo, int nw) {
    for (int i = threadIdx.x; i < kSlab * kSlab; i += kSsdThreads) {
      const int r = i / kSlab, n = i % kSlab;  // r: the row within the slab
      cs[n * kSlab + r] = q_lo + r < valid && n < nw
          ? rnd<T>(cyb[(long long)(q_lo + r) * CD + Di + GN + g * N + n_lo + n]) : 0.f;
    }
  };
  if (one_n_tile) stage_c(0, N);
  // This thread's 4 x 4 tile of m: lanes of a warp take neighbouring q0
  // (one k0), so the transposed stores of m spread over the banks.
  const int mq0 = (threadIdx.x % tq) * 4, mk0 = (threadIdx.x / tq) * 4;
  for (int k_lo = 0; k_lo < q_end; k_lo += kSlab) {
    const int kn = min(kSlab, valid - k_lo);
    const bool live = k_lo + mk0 <= q_lo + mq0 + 3;
    float acc[4][4] = {};
    for (int n_lo = 0; n_lo < N; n_lo += kSlab) {
      const int nw = min(kSlab, N - n_lo);
      if (!one_n_tile) stage_c(n_lo, nw);
      for (int i = threadIdx.x; i < kSlab * kSlab; i += kSsdThreads) {
        const int r = i / kSlab, n = i % kSlab;  // r: the row within the slab
        bsT[n * kSlab + r] = r < kn && n < nw
            ? rnd<T>(cyb[(long long)(k_lo + r) * CD + Di + g * N + n_lo + n]) : 0.f;
      }
      __syncthreads();
      if (live)
        for (int n = 0; n < nw; ++n)
          fma4x4(acc, ld4(cs + n * kSlab + mq0), ld4(bsT + n * kSlab + mk0));
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q_lo + mq0 + i, k = k_lo + mk0 + j;
        mT[(mk0 + j) * kSlab + mq0 + i] =
            k <= q && q < valid ? rnd<T>(acc[i][j] * expf(ss[q] - ss[k]) * ds[k]) : 0.f;
      }
    }
    for (int i = threadIdx.x; i < kSlab * kSlab; i += kSsdThreads) {
      const int k = i / kSlab, p = i % kSlab;
      xs[i] = k < kn && p < pw ? rnd<T>(cyb[(long long)(k_lo + k) * CD + h * P + p_lo + p]) : 0.f;
    }
    __syncthreads();

    for (int tile = threadIdx.x; tile < tq * tp; tile += kSsdThreads) {
      const int q0 = (tile / tp) * 4, p0 = (tile % tp) * 4;
      const int kend = min(min(q_lo + q0 + 4, valid) - k_lo, kn);
      if (q_lo + q0 >= valid || kend <= 0) continue;
      float yacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = ld4(ys + (q0 + i) * kSlab + p0);
        yacc[i][0] = v.x; yacc[i][1] = v.y; yacc[i][2] = v.z; yacc[i][3] = v.w;
      }
      for (int k = 0; k < kend; ++k)
        fma4x4(yacc, ld4(mT + k * kSlab + q0), ld4(xs + k * kSlab + p0));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(ys + (q0 + i) * kSlab + p0) =
            make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]);
    }
    __syncthreads();
  }

  // The inter-chunk term (C rnd(h_in)^T) over N tiles, this thread's (q0, p0)
  // tile in registers (tq * tp <= kSsdThreads tiles, at most one a thread).
  const float* hin = a.hin + (((long long)b * nc + c) * H + h) * P * N;
  const int tile = threadIdx.x;
  const int q0 = (tile / (tp > 0 ? tp : 1)) * 4, p0 = (tile % (tp > 0 ? tp : 1)) * 4;
  const bool mine = tile < tq * tp;
  float inter[4][4] = {};
  for (int n_lo = 0; n_lo < N; n_lo += kSlab) {
    const int nw = min(kSlab, N - n_lo);
    if (!one_n_tile) stage_c(n_lo, nw);
    for (int i = threadIdx.x; i < kSlab * kSlab; i += kSsdThreads) {
      const int p = i / kSlab, hn = i % kSlab;
      hs[hn * kSlab + p] = p < pw && hn < nw
          ? rnd<T>(hin[(long long)(p_lo + p) * N + n_lo + hn]) : 0.f;
    }
    __syncthreads();
    if (mine)
      for (int n = 0; n < nw; ++n)
        fma4x4(inter, ld4(cs + n * kSlab + q0), ld4(hs + n * kSlab + p0));
    __syncthreads();
  }
  if (!mine) return;
  const float dh = a.Dskip ? a.Dskip[h] : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q_lo + q0 + i;
    if (q >= valid) continue;
    const float es = expf(ss[q]);
    const float4 xq = ld4(cyb + (long long)q * CD + h * P + p_lo + p0);
    const float4 yq = ld4(ys + (q0 + i) * kSlab + p0);
    const float xf[4] = {xq.x, xq.y, xq.z, xq.w};
    const float yin[4] = {yq.x, yq.y, yq.z, yq.w};
    float yv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) yv[j] = yin[j] + inter[i][j] * es + dh * xf[j];
    *reinterpret_cast<float4*>(a.y + ((long long)b * a.L + t0 + q) * Di + h * P + p_lo + p0) =
        make_float4(yv[0], yv[1], yv[2], yv[3]);
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
      ssd_out_smem_bytes(a.Q) > 232448)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
cudaError_t ssd_walk(const SsdArgs& a, cudaStream_t s) {
  cudaError_t err = ssd_check(a);
  if (err != cudaSuccess) return err;
  const int nc = (a.L + a.Q - 1) / a.Q;
  ssd_chunk_state_kernel<T><<<dim3(nc, a.H, a.B), kSsdThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned pn_blocks = (unsigned)((a.P * a.N + kSsdThreads - 1) / kSsdThreads);
  ssd_state_pass_kernel<<<dim3(a.H, a.B, pn_blocks), kSsdThreads, 0, s>>>(a, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t out_smem = ssd_out_smem_bytes(a.Q);
  if ((err = set_smem(ssd_chunk_out_kernel<T>, out_smem)) != cudaSuccess) return err;
  const int nqs = (a.Q + kSlab - 1) / kSlab, npt = (a.P + kSlab - 1) / kSlab;
  ssd_chunk_out_kernel<T><<<dim3(nc * nqs * npt, a.H, a.B), kSsdThreads, out_smem, s>>>(
      a, nqs, npt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ssd_gate(const SsdArgs& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.L;
  ssd_gate_kernel<T><<<(unsigned)((rows + kGateWarps - 1) / kGateWarps), kGateWarps * 32,
                        0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ssd_core(const SsdArgs& a, cudaStream_t s) {
  cudaError_t err = ssd_check(a);
  if (err != cudaSuccess) return err;
  const int Di = a.H * a.P, CD = Di + 2 * a.G * a.N;
  err = conv_silu<T, float>((const T*)a.zx + Di, a.ld_zx, a.conv_state, a.conv_w, a.conv_b,
                            a.cy, a.B, a.L, CD, a.W, s);
  if (err != cudaSuccess) return err;
  if ((err = ssd_walk<T>(a, s)) != cudaSuccess) return err;
  return ssd_gate<T>(a, s);
}

template cudaError_t ssd_core<float>(const SsdArgs&, cudaStream_t);
template cudaError_t ssd_core<bf16>(const SsdArgs&, cudaStream_t);
template cudaError_t ssd_gate<float>(const SsdArgs&, cudaStream_t);
template cudaError_t ssd_gate<bf16>(const SsdArgs&, cudaStream_t);

}  // namespace vmt

// zx (B * L rows of ld_zx) fp32 or bf16 (is_bf16): z at column 0, [x B C] at
// H * P; out (B, L, H * P) in zx's dtype. conv_state (B, CD, W) rounded to
// zx's dtype, conv_w (CD, W), conv_b (CD,), s and dt (B, Lp, H) with Lp = Q
// ceil(L / Q), Dskip (H,), norm_w (H * P,) or null, h0 / h_last (B, H, P, N):
// fp32, contiguous. Scratch (fp32): cy B L CD; y B L H P and hin B nc H P N
// hold the pre-gate y and the chunks' entry states after the call (the
// training forward's checkpoints).
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

// K11's forward, the bare SSD chunk scan: xbc (B * L, H P + 2 G N) fp32 rows
// [x | B | C] holding values of the compute dtype (is_bf16: bf16, else
// fp32), s and dt (B, Lp, H), h0 (B, H, P, N) fp32. Writes y (B * L, H P)
// fp32 (no D skip), h_last, and hins (B, nc, H, P, N): each chunk's entry
// state.
extern "C" int vmt_ssd_scan(const float* xbc, float* y, const float* s, const float* dt,
                            const float* h0, float* h_last, float* hins, int B, int L,
                            int Q, int H, int P, int G, int N, int is_bf16, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vmt::SsdArgs a{nullptr, 0, nullptr, nullptr, nullptr, nullptr, s, dt, nullptr,
                       nullptr, h0, h_last, const_cast<float*>(xbc), y, hins,
                       B, L, Q, H, P, G, N, 0, 0.f};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? vmt::ssd_walk<bf16>(a, st) : vmt::ssd_walk<float>(a, st));
}
