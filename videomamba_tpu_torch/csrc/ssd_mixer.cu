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
// walk is split by state passing into six launches on one stream:
//   1. conv + SiLU over the slab (mixer_parts.cuh's conv_silu, the window's
//      last W - 1 raw inputs as left context), into cy;
//   2. per (chunk, head, batch) block: the chunk's own state S_c =
//      sum_k rnd(x_f w)_k^T B_k, one 64 x 64 (P, N) tile at a time, the
//      chunk's rows staged 64 at a time;
//   3. per (512 state elements, head, batch) block: the sequential pass
//      over the chunks, h_c = exp(s_last) h_{c-1} + S_c, leaving each
//      chunk's entry state in place of S_c, and h_last. A thread owns a
//      16-byte vector of the state and keeps 8 chunks' loads in flight
//      ahead of the serial combine, the block's chunk-end decays in shared
//      memory;
//   4. per (causal 64 x 64 tile pair of a chunk, group, batch) block: C B^T,
//      summed over 64-wide N tiles, into scratch (cb, fp32). It depends on
//      the group only, so it is built once for the group's H / G heads;
//   5. per (64 rows of a chunk, 64 head-dim columns, head, batch) block:
//      per causal k slab the tile m = rnd(C B^T e^(s_q - s_k) dt_k) staged
//      from cb, then y += m x; then (C h_in^T) e^s + D x_f for its rows and
//      columns;
//   6. per row (a warp each): the gate and the norm, which spans every head
//      of the row.
// Every product is ssd_core.cuh's 64 x 64 slab product: fp32 FMA at fp32
// (the TPU's HIGHEST: no TF32), bf16 mma.sync with fp32 sums at bf16, where
// the operands are already rounded, so the products are exact. Shared
// memory grows with the chunk only by its s and dt, and not with P or N:
// at VideoMamba-Base-m2 (Q 128, H 24, P = N = 64, L 1569) launch 5 runs 26 x
// 24 = 624 blocks at B = 1 of 49 KB (fp32) or 28 KB (bf16) each; a wider P
// runs more blocks. Every sum still runs over k (and n) in order, so at
// fp32 launch 4 gives the values the per-head tiles gave.
//
// K11's forward (vmt_ssd_scan) is launches 2-5 over x, B and C given as
// fp32 rows, without a D skip. With the walk's hin and y buffers kept, the
// mixer's training forward has its checkpoints (hins, yd) for free.
//
// What bounds it on the H100: operations, the (Q, Q) and (Q, P) tiles'
// products (about 1.0 GFLOP at Base, B = 1: 0.015 ms at 67 TFLOP/s fp32,
// far less on bf16 tensor cores), over the bytes of its inputs and outputs
// (about 30 MB, 0.009 ms). Launch 3 alone does no product and is bound by
// bytes: it reads and writes hin once, 2 B nc H P N 4 bytes (311 MB at 4
// streams of Base-m2 at L 12,545: 0.093 ms at 3.35 TB/s); with 8 chunks'
// loads in flight a thread it takes 0.13 ms there on an H100 SXM at 700 W,
// 72 % of that rate.
#include "mixer_parts.cuh"
#include "ssd_core.cuh"

namespace {

using vmt::bf16;

constexpr int kSsdThreads = vmt::kSlabThreads;  // the slab product's 256
constexpr int kSlab = vmt::kSsdSlab;  // chunk rows a shared-memory slab holds; P and N tile
constexpr int kGateWarps = 8;


// Launch 2: S_c[p, n] = sum_k rnd(x_f[k, p] dt_k exp(s_last - s_k)) rnd(B[k, n]),
// grid (nc, H, B), into hin at chunk c. One 64 x 64 (P, N) tile of S_c at a
// time on the slab product (ssd_core.cuh: FMA at fp32, mma.sync at bf16),
// the chunk's rows staged kSlab at a time, so the sums run over k in order
// whatever the chunk and state sizes. A row's weight dt_k exp(s_last - s_k)
// is taken once a slab.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_state_kernel(vmt::SsdArgs a) {
  using St = vmt::SlabT<T>;
  __shared__ __align__(16) St xw[vmt::slab_elems<T>()];  // [k][p]
  __shared__ __align__(16) St bs[vmt::slab_elems<T>()];  // [k][n]
  __shared__ float ws[kSlab];                            // [k] the rows' weights
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
  for (int p_lo = 0; p_lo < P; p_lo += kSlab) {
    const int pw = min(kSlab, P - p_lo);
    for (int n_lo = 0; n_lo < N; n_lo += kSlab) {
      const int nw = min(kSlab, N - n_lo);
      float acc[vmt::kSlabOut] = {};
      for (int k_lo = 0; k_lo < valid; k_lo += kSlab) {
        const int kn = min(kSlab, valid - k_lo);
        const float* cyb = a.cy + ((long long)b * a.L + t0 + k_lo) * CD;
        if (threadIdx.x < kn) {
          const long long t = t0 + k_lo + threadIdx.x;
          ws[threadIdx.x] = db[t * H + h] * expf(s_last - sb[t * H + h]);
        }
        __syncthreads();
        vmt::slab_stage<T, false>(xw, cyb + h * P + p_lo, CD, kn, pw,
                                  [&](int r, int, float v) { return v * ws[r]; });
        vmt::slab_stage<T, false>(bs, cyb + Di + g * N + n_lo, CD, kn, nw, vmt::AsIs());
        __syncthreads();
        vmt::slab_mma<T>(acc, xw, bs, kn);
        __syncthreads();
      }
      vmt::slab_each<T>([&](int i, int p, int n) {
        if (p < pw && n < nw) S[(long long)(p_lo + p) * N + n_lo + n] = acc[i];
      });
    }
  }
}

// Launch 3: the sequential pass over chunks, h_c = exp(s_last) h_{c-1} + S_c,
// grid (ceil(P N / 4 / kPassThreads), H, B): a thread owns 4 state elements
// (one 16-byte vector) of a (head, batch) and walks its chunks in order,
// replacing each chunk's S_c by the state entering it; h_last is the state
// after all. Only the combine is serial: the thread keeps kPassDepth chunks'
// loads in flight ahead of it (a register ring, each load issued before the
// stores of the chunks it runs ahead of), so the pass streams hin at the
// card's byte rate instead of paying a round trip a chunk. The block's
// chunk-end decays are staged in shared memory kPassDecays at a time, off
// the dependent path. Each element sees the same decays and the same fma in
// chunk order whatever the layout, so the entry states and h_last do not
// depend on how the threads split the state.
constexpr int kPassThreads = 128;
constexpr int kPassDepth = 8;
constexpr int kPassDecays = 256;  // a multiple of kPassDepth
static_assert(kPassDecays % kPassDepth == 0, "a decay tile holds whole rounds of the ring");

__global__ void __launch_bounds__(kPassThreads) ssd_state_pass_kernel(vmt::SsdArgs a, int nc) {
  __shared__ float dec[kPassDecays];
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = a.H, PN = a.P * a.N;  // PN % 16 == 0 (ssd_check)
  const int i = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  const bool live = i < PN;
  const long long step = (long long)H * PN;  // hin's stride from one chunk to the next
  float* S = a.hin + ((long long)b * nc * H + h) * PN + i;
  const float* s_last = a.s + ((long long)b * nc * a.Q + a.Q - 1) * H + h;
  const long long s_step = (long long)a.Q * H;
  const long long hi = ((long long)b * H + h) * PN + i;
  float4 st = {}, ring[kPassDepth];
  if (live) {
    st = make_float4(a.h0[hi], a.h0[hi + 1], a.h0[hi + 2], a.h0[hi + 3]);
#pragma unroll
    for (int j = 0; j < kPassDepth; ++j)
      if (j < nc) ring[j] = vmt::ld4(S + j * step);
  }
  for (int c0 = 0; c0 < nc; c0 += kPassDecays) {
    const int cn = min(kPassDecays, nc - c0);
    __syncthreads();  // the last tile's decays are read
    for (int j = threadIdx.x; j < cn; j += kPassThreads) dec[j] = expf(s_last[(c0 + j) * s_step]);
    __syncthreads();
    if (!live) continue;
    for (int c1 = 0; c1 < cn; c1 += kPassDepth) {
#pragma unroll
      for (int j = 0; j < kPassDepth; ++j) {  // chunk c0 + c1 + j sits in ring[j]
        const int c = c0 + c1 + j;
        if (c1 + j < cn) {
          const float4 sc = ring[j];
          if (c + kPassDepth < nc) ring[j] = vmt::ld4(S + (c + kPassDepth) * step);
          *reinterpret_cast<float4*>(S + c * step) = st;
          const float d = dec[c1 + j];
          st.x = d * st.x + sc.x;
          st.y = d * st.y + sc.y;
          st.z = d * st.z + sc.z;
          st.w = d * st.w + sc.w;
        }
      }
    }
  }
  if (live) {
    a.h_last[hi] = st.x;
    a.h_last[hi + 1] = st.y;
    a.h_last[hi + 2] = st.z;
    a.h_last[hi + 3] = st.w;
  }
}

// Launch 4: the causal C B^T tiles of a (chunk, group, batch): tile pair number
// blockIdx.x % ntri of the chunk (q slab >= k slab, in the order (0, 0),
// (1, 0), (1, 1), (2, 0), ...), grid (nc * ntri, G, B), summed over 64-wide N
// tiles with n in order, written fp32 to cb (Q, Q) of the chunk and group.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_cb_kernel(const float* __restrict__ cy, float* __restrict__ cb, int L, int Q, int H,
                  int P, int G, int N, int ntri) {
  using St = vmt::SlabT<T>;
  __shared__ __align__(16) St cs[vmt::slab_elems<T>()];  // [n][q] rnd(C)
  __shared__ __align__(16) St bs[vmt::slab_elems<T>()];  // [n][k] rnd(B)
  const int nc = gridDim.x / ntri, c = blockIdx.x / ntri, g = blockIdx.y, b = blockIdx.z;
  int ks = blockIdx.x % ntri, qs = 0;
  while (ks > qs) ks -= ++qs;
  const int q_lo = qs * kSlab, k_lo = ks * kSlab;
  const int t0 = c * Q, valid = min(Q, L - t0);
  if (q_lo >= valid) return;  // the whole block: before any barrier
  const int qn = min(kSlab, valid - q_lo), kn = min(kSlab, valid - k_lo);
  const int Di = H * P, GN = G * N, CD = Di + 2 * GN;
  const float* cyb = cy + ((long long)b * L + t0) * CD;
  float acc[vmt::kSlabOut] = {};
  for (int n_lo = 0; n_lo < N; n_lo += kSlab) {
    const int nw = min(kSlab, N - n_lo);
    vmt::slab_stage<T, true>(cs, cyb + (long long)q_lo * CD + Di + GN + g * N + n_lo, CD, qn,
                             nw, vmt::AsIs());
    vmt::slab_stage<T, true>(bs, cyb + (long long)k_lo * CD + Di + g * N + n_lo, CD, kn, nw,
                             vmt::AsIs());
    __syncthreads();
    vmt::slab_mma<T>(acc, cs, bs, nw);
    __syncthreads();
  }
  float* out = cb + (((long long)b * nc + c) * G + g) * Q * Q;
  vmt::slab_each<T>([&](int i, int q, int k) {
    if (q_lo + q < Q && k_lo + k < Q) out[(long long)(q_lo + q) * Q + k_lo + k] = acc[i];
  });
}

// Launch 5: y for kSlab rows and kSlab head-dim columns of a chunk, grid
// (nc * nqs * npt, H, B). The block walks the chunk's causal k slabs up to
// its own rows: per slab the (kSlab, kSlab) tile of m = rnd(C B^T e^(s_q -
// s_k) dt_k) from the group's C B^T tiles (launch 4), then y += m x on the
// slab product, k in order; then the inter-chunk term C rnd(h_in)^T over N
// tiles and the D skip.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_out_kernel(vmt::SsdArgs a, int nqs,
                                                                    int npt) {
  using St = vmt::SlabT<T>;
  constexpr int E = vmt::slab_elems<T>();
  extern __shared__ __align__(16) unsigned char smraw[];
  St* mT = reinterpret_cast<St*>(smraw);  // [k][q] m
  St* s1 = mT + E;                        // [k][p] rnd(x), then [n][p] rnd(h_in)
  St* s2 = s1 + E;                        // [n][q] rnd(C)
  float* ss = reinterpret_cast<float*>(s2 + E);  // [Q] s
  const int c = blockIdx.x / (nqs * npt), h = blockIdx.y, b = blockIdx.z;
  const int q_lo = ((blockIdx.x / npt) % nqs) * kSlab;
  const int p_lo = (blockIdx.x % npt) * kSlab;
  const int nc = gridDim.x / (nqs * npt), Q = a.Q, P = a.P, N = a.N, H = a.H;
  float* ds = ss + Q;  // [Q] dt
  const int Di = H * P, CD = Di + 2 * a.G * N, GN = a.G * N;
  const int g = h / (H / a.G);
  const long long Lp = (long long)nc * Q;
  const int t0 = c * Q;
  const int valid = min(Q, a.L - t0);
  if (q_lo >= valid) return;  // the whole block: before any barrier
  const int qn = min(kSlab, valid - q_lo);
  const int pw = min(kSlab, P - p_lo);
  const float* cyb = a.cy + ((long long)b * a.L + t0) * CD;
  const float* cbb = a.cb + (((long long)b * nc + c) * a.G + g) * Q * Q;
  for (int i = threadIdx.x; i < Q; i += kSsdThreads) {
    ss[i] = a.s[((long long)b * Lp + t0 + i) * H + h];
    ds[i] = a.dt[((long long)b * Lp + t0 + i) * H + h];
  }
  __syncthreads();

  float yacc[vmt::kSlabOut] = {};
  for (int k_lo = 0; k_lo <= q_lo; k_lo += kSlab) {
    const int kn = min(kSlab, valid - k_lo);
    vmt::slab_stage<T, true>(mT, cbb + (long long)q_lo * Q + k_lo, Q, qn, kn,
                             [&](int r, int cc, float v) {
                               const int q = q_lo + r, k = k_lo + cc;
                               return k <= q ? v * expf(ss[q] - ss[k]) * ds[k] : 0.f;
                             });
    vmt::slab_stage<T, false>(s1, cyb + (long long)k_lo * CD + h * P + p_lo, CD, kn, pw,
                              vmt::AsIs());
    __syncthreads();
    vmt::slab_mma<T>(yacc, mT, s1, kn);
    __syncthreads();
  }

  // The inter-chunk term (C rnd(h_in)^T) over N tiles.
  const float* hin = a.hin + (((long long)b * nc + c) * H + h) * P * N;
  float iacc[vmt::kSlabOut] = {};
  for (int n_lo = 0; n_lo < N; n_lo += kSlab) {
    const int nw = min(kSlab, N - n_lo);
    vmt::slab_stage<T, true>(s2, cyb + (long long)q_lo * CD + Di + GN + g * N + n_lo, CD, qn,
                             nw, vmt::AsIs());
    vmt::slab_stage<T, true>(s1, hin + (long long)p_lo * N + n_lo, N, pw, nw, vmt::AsIs());
    __syncthreads();
    vmt::slab_mma<T>(iacc, s2, s1, nw);
    __syncthreads();
  }
  const float dh = a.Dskip ? a.Dskip[h] : 0.f;
  vmt::slab_each<T>([&](int i, int q, int p) {
    if (q >= qn || p >= pw) return;
    const long long row = (long long)b * a.L + t0 + q_lo + q;
    const float xf = a.cy[row * CD + h * P + p_lo + p];
    a.y[row * Di + h * P + p_lo + p] = yacc[i] + iacc[i] * expf(ss[q_lo + q]) + dh * xf;
  });
}

// Launch 6: out = rnd(norm(y * silu(z))), one warp a row.
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

// Launch 3 over a.hin's nc chunk states (B, nc, H, P, N).
cudaError_t ssd_state_pass(const vmt::SsdArgs& a, int nc, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(a.hin) % 16) return cudaErrorMisalignedAddress;
  const unsigned pn_blocks = (unsigned)((a.P * a.N / 4 + kPassThreads - 1) / kPassThreads);
  ssd_state_pass_kernel<<<dim3(pn_blocks, a.H, a.B), kPassThreads, 0, s>>>(a, nc);
  return cudaGetLastError();
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

namespace vmt {

cudaError_t ssd_check(const SsdArgs& a) {
  if (a.P % 4 || a.N % 4 || a.Q <= 0 || a.G <= 0 || a.H % a.G ||
      ssd_smem_bytes(a.Q) > 232448)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
cudaError_t ssd_cb(const float* cy, float* cb, int B, int L, int Q, int H, int P, int G, int N,
                   cudaStream_t s) {
  const int nc = (L + Q - 1) / Q, ntri = ssd_cb_tiles(Q);
  ssd_cb_kernel<T><<<dim3(nc * ntri, G, B), kSsdThreads, 0, s>>>(cy, cb, L, Q, H, P, G, N,
                                                                  ntri);
  return cudaGetLastError();
}

template cudaError_t ssd_cb<float>(const float*, float*, int, int, int, int, int, int, int,
                                   cudaStream_t);
template cudaError_t ssd_cb<bf16>(const float*, float*, int, int, int, int, int, int, int,
                                  cudaStream_t);

template <typename T>
cudaError_t ssd_walk(const SsdArgs& a, cudaStream_t s) {
  cudaError_t err = ssd_check(a);
  if (err != cudaSuccess) return err;
  const int nc = (a.L + a.Q - 1) / a.Q;
  ssd_chunk_state_kernel<T><<<dim3(nc, a.H, a.B), kSsdThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = ssd_state_pass(a, nc, s)) != cudaSuccess) return err;
  if ((err = ssd_cb<T>(a.cy, a.cb, a.B, a.L, a.Q, a.H, a.P, a.G, a.N, s)) != cudaSuccess)
    return err;
  const size_t out_smem = ssd_out_smem_bytes<T>(a.Q);
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
// training forward's checkpoints); cb B nc G Q Q the C B^T tiles.
extern "C" int vmt_ssd_mixer(const void* zx, long long ld_zx, void* out,
                             const float* conv_state, const float* conv_w,
                             const float* conv_b, const float* s, const float* dt,
                             const float* Dskip, const float* norm_w, const float* h0,
                             float* h_last, float* cy, float* y, float* hin, float* cb,
                             int B, int L, int Q, int H, int P, int G, int N, int W, float eps,
                             int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vmt::SsdArgs a{zx, ld_zx, out, conv_state, conv_w, conv_b, s, dt, Dskip, norm_w,
                       h0, h_last, cy, y, hin, cb, B, L, Q, H, P, G, N, W, eps};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? vmt::ssd_core<bf16>(a, st) : vmt::ssd_core<float>(a, st));
}

// K11's forward, the bare SSD chunk scan: xbc (B * L, H P + 2 G N) fp32 rows
// [x | B | C] holding values of the compute dtype (is_bf16: bf16, else
// fp32), s and dt (B, Lp, H), h0 (B, H, P, N) fp32. Writes y (B * L, H P)
// fp32 (no D skip), h_last, and hins (B, nc, H, P, N): each chunk's entry
// state. Scratch (fp32): cb B nc G Q Q.
extern "C" int vmt_ssd_scan(const float* xbc, float* y, const float* s, const float* dt,
                            const float* h0, float* h_last, float* hins, float* cb, int B,
                            int L, int Q, int H, int P, int G, int N, int is_bf16, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vmt::SsdArgs a{nullptr, 0, nullptr, nullptr, nullptr, nullptr, s, dt, nullptr,
                       nullptr, h0, h_last, const_cast<float*>(xbc), y, hins, cb,
                       B, L, Q, H, P, G, N, 0, 0.f};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? vmt::ssd_walk<bf16>(a, st) : vmt::ssd_walk<float>(a, st));
}
