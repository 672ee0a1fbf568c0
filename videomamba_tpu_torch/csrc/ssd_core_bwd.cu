// The reverse SSD chunk walk for Hopper (K11's backward), shared by the
// mixer backward (K13, ssd_mixer_bwd.cu) and the projected mixer's backward
// (K14, ssd_pmixer_bwd.cu).
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/ssd_scan.py
// (_ssd_bwd_padded -> _ssd_bwd_kernel) and the scan part of the mixer
// backward kernels (_ssd_mixer_bwd_kernel step 4, _merged_scan_bwd_core).
// Per chunk of Q steps, head h (group g) and batch row b, with the forward
// of ssd_mixer.cu (s the inclusive cumsum of dt * A in the chunk, E[q, k] =
// exp(s_q - s_k) for k <= q, w_k = dt_k exp(s_last - s_k), g the cotangent
// of the state leaving the chunk) and dy the cotangent of y:
//   M     = rnd(C B^T * E * dt_k)              dM = rnd(dy) rnd(x)^T
//   dx    = M^T rnd(dy) + w * (rnd(B) rnd(g)^T) + D dy
//   dcb   = rnd(dM * E * dt_k)                 T  = dM * (C B^T) * E
//   dC    = dcb rnd(B) + (rnd(dy) rnd(h_in)) e^s
//   dB    = dcb^T rnd(C) + rnd(x w) rnd(g)
//   ddt_k = sum_q T[q, k] + dw_k exp(s_last - s_k), dw = rowsum(rnd(x) * R)
//   ds_q  = sum_k T[q, k] dt_k + e^s_q sum_n dCw C,  ds_k -= dt_k sum_q T[q, k] + dw_k w_k
//   ds at the chunk's last row += sum_k dw_k w_k + e^s_last sum(g * h_in)
//   g'    = rnd(dy)^T rnd(rnd(C) e^s) + e^s_last g  (the state entering the chunk)
// rnd() rounds to the compute dtype T; every sum is fp32. These are the
// per-head arm's rounding points (_ssd_bwd_kernel, _ssd_mixer_bwd_kernel):
// the merged arm's head-sum of dcb before its rounding is a TPU MXU
// schedule, and the kernels here run one head per block. The short decay
// chains (d dt A from ds, dA) are torch ops around it, as they are XLA ops
// in the JAX package (_decay_chain_grads).
//
// Design. The TPU walks the chunks in reverse with g in VMEM. The walk is
// split by state passing, as the forward is:
//   1. per (chunk, head, batch): the chunk's own dh_in = rnd(dy)^T rnd(rnd(C)
//      e^s), which does not depend on g;
//   2. per (head, batch, 256 state elements): the short reverse pass
//      g_{c-1} = dh_in,c + e^s_last,c g_c, leaving each chunk's g in place of
//      its dh_in, and dh0;
//   3. per (64 input rows k of a chunk, head, batch): dx, the head's dB, ddt
//      and the k-indexed ds, walking the 64-row output slabs q >= k;
//   4. per (64 output rows q, head, batch): the head's dC and the q-indexed
//      ds, walking the input slabs k <= q;
//   5. per (row, group, state): dB and dC summed over the group's heads.
// Launches 3 and 4 both rebuild the causal tiles C B^T and dM, so no block
// sums into another's rows: there are no atomics, and repeated runs give
// bit-identical gradients. Every tile is 64 x 64, staged from the P and N
// axes 64 at a time, so shared memory (82 KB a block) does not grow with
// the chunk, the head dim or the state.
//
// What bounds it on the H100: operations, about 4x the forward's tile
// products (C B^T and dM twice, M^T dy, dcb B, dcb^T C, the state terms):
// about 4-5 GFLOP at VideoMamba-Base-m2, B = 1, on fp32 FMA tiles.
#include "ssd_core_bwd.cuh"

namespace {

using vmt::bf16;

constexpr int kThreads = 256;
constexpr int kS = vmt::kSsdSlab;  // rows of a slab; width of a P or N tile
constexpr int kT = kS * kS;
constexpr int kGrp = kS / 4 + 1;  // row stride of the per-row partial sums

using vmt::fma4x4;
using vmt::ld4;
using vmt::rnd;

// The block's chunk, head and batch row, and the offsets every launch uses.
struct Chunk {
  int c, h, b, g, nc, t0, valid, Di, CD, GN;
  long long Lp;
  const float* xb;   // xbc row of the chunk's first step
  const float* dyb;  // dy row of the chunk's first step
  __device__ Chunk(const vmt::SsdBwdArgs& a, int c_, int nc_) {
    c = c_;
    h = blockIdx.y;
    b = blockIdx.z;
    nc = nc_;
    g = h / (a.H / a.G);
    Di = a.H * a.P;
    GN = a.G * a.N;
    CD = Di + 2 * GN;
    Lp = (long long)nc * a.Q;
    t0 = c * a.Q;
    valid = min(a.Q, a.L - t0);
    xb = a.xbc + ((long long)b * a.L + t0) * CD;
    dyb = a.dy + ((long long)b * a.L + t0) * Di;
  }
  __device__ float x(int t, int p, int P) const { return xb[(long long)t * CD + h * P + p]; }
  __device__ float B(int t, int n, int N) const { return xb[(long long)t * CD + Di + g * N + n]; }
  __device__ float C(int t, int n, int N) const {
    return xb[(long long)t * CD + Di + GN + g * N + n];
  }
  __device__ float dy(int t, int p, int P) const { return dyb[(long long)t * Di + h * P + p]; }
  __device__ long long scal(int t, int H) const { return ((long long)b * Lp + t0 + t) * H + h; }
};

// Launch 1: g[b, c, h] = sum_q rnd(dy_q)^T rnd(rnd(C_q) e^s_q), grid (nc, H,
// B), one 64 x 64 (P, N) tile at a time, one 4 x 4 tile a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dhin_kernel(vmt::SsdBwdArgs a) {
  __shared__ __align__(16) float dys[kT];  // [q][p]
  __shared__ __align__(16) float cws[kT];  // [q][n]
  const Chunk k(a, blockIdx.x, gridDim.x);
  const int P = a.P, N = a.N;
  float* G = a.g + (((long long)k.b * k.nc + k.c) * a.H + k.h) * P * N;
  const int p0 = (threadIdx.x / 16) * 4, n0 = (threadIdx.x % 16) * 4;
  for (int p_lo = 0; p_lo < P; p_lo += kS) {
    const int pw = min(kS, P - p_lo);
    for (int n_lo = 0; n_lo < N; n_lo += kS) {
      const int nw = min(kS, N - n_lo);
      float acc[4][4] = {};
      for (int q_lo = 0; q_lo < k.valid; q_lo += kS) {
        const int qn = min(kS, k.valid - q_lo);
        for (int i = threadIdx.x; i < kT; i += kThreads) {
          const int q = i / kS, j = i % kS;
          float dv = 0.f, cv = 0.f;
          if (q < qn) {
            const int t = q_lo + q;
            if (j < pw) dv = rnd<T>(k.dy(t, p_lo + j, P));
            if (j < nw) cv = rnd<T>(rnd<T>(k.C(t, n_lo + j, N)) * expf(a.s[k.scal(t, a.H)]));
          }
          dys[i] = dv;
          cws[i] = cv;
        }
        __syncthreads();
        if (p0 < pw && n0 < nw)
          for (int q = 0; q < qn; ++q)
            fma4x4(acc, ld4(dys + q * kS + p0), ld4(cws + q * kS + n0));
        __syncthreads();
      }
      if (p0 < pw && n0 < nw) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) G[(long long)(p_lo + p0 + i) * N + n_lo + n0 + j] = acc[i][j];
      }
    }
  }
}

// Launch 2: the reverse pass over chunks, one thread per state element of
// a (head, batch), grid (H, B, ceil(P N / kThreads)).
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_pass_kernel(vmt::SsdBwdArgs a,
                                                                      int nc) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H, PN = a.P * a.N;
  const long long Lp = (long long)nc * a.Q;
  const int i = blockIdx.z * kThreads + threadIdx.x;
  if (i >= PN) return;
  float gr = a.dhlast ? a.dhlast[((long long)b * H + h) * PN + i] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    float* G = a.g + (((long long)b * nc + c) * H + h) * PN + i;
    const float dec = expf(a.s[((long long)b * Lp + (long long)c * a.Q + a.Q - 1) * H + h]);
    const float dh = *G;
    *G = gr;
    gr = dh + dec * gr;
  }
  a.dh0[((long long)b * H + h) * PN + i] = gr;
}

// C B^T and dM = rnd(dy) rnd(x)^T for output rows [q_lo, q_lo + 64) and input
// rows [k_lo, k_lo + 64) of a chunk: this thread's 4 x 4 tile (q0, k0) of
// each, summed over the N and P axes 64 at a time through s0 and s1.
template <typename T>
__device__ __forceinline__ void causal_tiles(const vmt::SsdBwdArgs& a, const Chunk& k,
                                             int q_lo, int qn, int k_lo, int kn, int q0,
                                             int k0, bool live, float* s0, float* s1,
                                             float (&cb)[4][4], float (&dm)[4][4]) {
  const int P = a.P, N = a.N;
  for (int n_lo = 0; n_lo < N; n_lo += kS) {
    const int nw = min(kS, N - n_lo);
    for (int i = threadIdx.x; i < kT; i += kThreads) {
      const int r = i / kS, n = i % kS;
      s0[n * kS + r] = r < qn && n < nw ? rnd<T>(k.C(q_lo + r, n_lo + n, N)) : 0.f;
      s1[n * kS + r] = r < kn && n < nw ? rnd<T>(k.B(k_lo + r, n_lo + n, N)) : 0.f;
    }
    __syncthreads();
    if (live)
      for (int n = 0; n < nw; ++n) fma4x4(cb, ld4(s0 + n * kS + q0), ld4(s1 + n * kS + k0));
    __syncthreads();
  }
  for (int p_lo = 0; p_lo < P; p_lo += kS) {
    const int pw = min(kS, P - p_lo);
    for (int i = threadIdx.x; i < kT; i += kThreads) {
      const int r = i / kS, p = i % kS;
      s0[p * kS + r] = r < qn && p < pw ? rnd<T>(k.dy(q_lo + r, p_lo + p, P)) : 0.f;
      s1[p * kS + r] = r < kn && p < pw ? rnd<T>(k.x(k_lo + r, p_lo + p, P)) : 0.f;
    }
    __syncthreads();
    if (live)
      for (int p = 0; p < pw; ++p) fma4x4(dm, ld4(s0 + p * kS + q0), ld4(s1 + p * kS + k0));
    __syncthreads();
  }
}

// Shared memory of launches 3 and 4: five 64 x 64 tiles, s and dt of the
// chunk, and the per-row sums.
inline size_t side_smem_bytes(int Q) {
  return sizeof(float) * (5 * (size_t)kT + 2 * (size_t)Q + 4 * kS + (size_t)kS * kGrp);
}

// Launch 3: per 64 input rows k of a chunk, grid (nc * nks, H, B): dx, the
// head's dB, ddt, the k-indexed ds and the slab's part of the last-row ds.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kside_kernel(vmt::SsdBwdArgs a, int nks) {
  extern __shared__ __align__(16) float sm[];
  float* s0 = sm;            // staging
  float* s1 = s0 + kT;       // staging
  float* Mq = s1 + kT;       // [q][k] M
  float* Dq = Mq + kT;       // [q][k] dcb
  float* Tq = Dq + kT;       // [q][k] T
  float* ss = Tq + kT;       // [Q] s
  float* dts = ss + a.Q;     // [Q] dt
  float* colT = dts + a.Q;   // [kS] sum_q T[q, k]
  float* dwa = colT + kS;    // [kS] dw
  float* wk = dwa + kS;      // [kS] w
  float* part = wk + kS;     // [kS][kGrp] per-row partial sums
  float* red = part + kS * kGrp;  // [kS] dw w
  const Chunk k(a, blockIdx.x / nks, gridDim.x / nks);
  const int ks = blockIdx.x % nks;
  const int P = a.P, N = a.N, H = a.H, Q = a.Q;
  const int k_lo = ks * kS;
  if (k_lo >= k.valid) return;  // the whole block: before any barrier
  const int kn = min(kS, k.valid - k_lo);
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    ss[i] = a.s[k.scal(i, H)];
    dts[i] = a.dt[k.scal(i, H)];
  }
  if (threadIdx.x < kS) {
    colT[threadIdx.x] = 0.f;
    dwa[threadIdx.x] = 0.f;
  }
  __syncthreads();
  const float s_last = ss[Q - 1];
  if (threadIdx.x < kS) {
    const int t = k_lo + threadIdx.x;
    wk[threadIdx.x] = threadIdx.x < kn ? dts[t] * expf(s_last - ss[t]) : 0.f;
  }
  const long long row0 = (long long)k.b * a.L + k.t0;  // the chunk's first row
  const int mq0 = (threadIdx.x % 16) * 4, mk0 = (threadIdx.x / 16) * 4;

  for (int q_lo = k_lo; q_lo < k.valid; q_lo += kS) {
    const int qn = min(kS, k.valid - q_lo);
    const bool first = q_lo == k_lo;
    const bool live = q_lo + mq0 + 3 >= k_lo + mk0;
    float cb[4][4] = {}, dm[4][4] = {};
    causal_tiles<T>(a, k, q_lo, qn, k_lo, kn, mq0, mk0, live, s0, s1, cb, dm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q_lo + mq0 + i, kk = k_lo + mk0 + j;
        const bool ok = kk <= q && q < k.valid && kk < k.valid;
        const float E = ok ? expf(ss[q] - ss[kk]) : 0.f;
        const float dtk = ok ? dts[kk] : 0.f;
        const int o = (mq0 + i) * kS + mk0 + j;
        Mq[o] = rnd<T>(cb[i][j] * E * dtk);
        Dq[o] = rnd<T>(dm[i][j] * E * dtk);
        Tq[o] = dm[i][j] * cb[i][j] * E;
      }
    }
    __syncthreads();
    if (threadIdx.x < kS) {
      float acc = colT[threadIdx.x];
      for (int q = 0; q < qn; ++q) acc += Tq[q * kS + threadIdx.x];
      colT[threadIdx.x] = acc;
    }
    // dx[k, p] += sum_q M[q, k] rnd(dy[q, p]), one P tile at a time.
    for (int p_lo = 0; p_lo < P; p_lo += kS) {
      const int pw = min(kS, P - p_lo);
      for (int i = threadIdx.x; i < kT; i += kThreads) {
        const int q = i / kS, p = i % kS;
        s0[i] = q < qn && p < pw ? rnd<T>(k.dy(q_lo + q, p_lo + p, P)) : 0.f;
      }
      __syncthreads();
      const int tp = pw / 4;
      if (threadIdx.x < 16 * tp) {
        const int k0 = (threadIdx.x / tp) * 4, p0 = (threadIdx.x % tp) * 4;
        float acc[4][4] = {};
        for (int q = 0; q < qn; ++q) fma4x4(acc, ld4(Mq + q * kS + k0), ld4(s0 + q * kS + p0));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k0 + i >= kn) continue;
          float* o = a.dxbc + (row0 + k_lo + k0 + i) * k.CD + k.h * P + p_lo + p0;
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = first ? acc[i][j] : o[j] + acc[i][j];
        }
      }
      __syncthreads();
    }
    // The head's dB[k, n] += sum_q dcb[q, k] rnd(C[q, n]), one N tile at a time.
    for (int n_lo = 0; n_lo < N; n_lo += kS) {
      const int nw = min(kS, N - n_lo);
      for (int i = threadIdx.x; i < kT; i += kThreads) {
        const int q = i / kS, n = i % kS;
        s0[i] = q < qn && n < nw ? rnd<T>(k.C(q_lo + q, n_lo + n, N)) : 0.f;
      }
      __syncthreads();
      const int tn = nw / 4;
      if (threadIdx.x < 16 * tn) {
        const int k0 = (threadIdx.x / tn) * 4, n0 = (threadIdx.x % tn) * 4;
        float acc[4][4] = {};
        for (int q = 0; q < qn; ++q) fma4x4(acc, ld4(Dq + q * kS + k0), ld4(s0 + q * kS + n0));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k0 + i >= kn) continue;
          float* o = a.dbh + ((row0 + k_lo + k0 + i) * H + k.h) * N + n_lo + n0;
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = first ? acc[i][j] : o[j] + acc[i][j];
        }
      }
      __syncthreads();
    }
  }

  // The state terms: R = rnd(B) rnd(g)^T, dx += w R + D dy, dw = rowsum(rnd(x) R).
  const float* G = a.g + (((long long)k.b * k.nc + k.c) * H + k.h) * P * N;
  const float dsk = a.Dskip ? a.Dskip[k.h] : 0.f;
  for (int p_lo = 0; p_lo < P; p_lo += kS) {
    const int pw = min(kS, P - p_lo);
    const int tp = pw / 4;
    const bool mine = threadIdx.x < 16 * tp;
    const int k0 = mine ? (threadIdx.x / tp) * 4 : 0, p0 = mine ? (threadIdx.x % tp) * 4 : 0;
    float racc[4][4] = {};
    for (int n_lo = 0; n_lo < N; n_lo += kS) {
      const int nw = min(kS, N - n_lo);
      for (int i = threadIdx.x; i < kT; i += kThreads) {
        const int r = i / kS, n = i % kS;
        s0[n * kS + r] = r < kn && n < nw ? rnd<T>(k.B(k_lo + r, n_lo + n, N)) : 0.f;
        s1[n * kS + r] = r < pw && n < nw ? rnd<T>(G[(long long)(p_lo + r) * N + n_lo + n]) : 0.f;
      }
      __syncthreads();
      if (mine)
        for (int n = 0; n < nw; ++n) fma4x4(racc, ld4(s0 + n * kS + k0), ld4(s1 + n * kS + p0));
      __syncthreads();
    }
    if (mine) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k0 + i;
        float acc = 0.f;
        if (kk < kn) {
          const long long row = row0 + k_lo + kk;
          float* o = a.dxbc + row * k.CD + k.h * P + p_lo + p0;
          const float* dyr = a.dy + row * k.Di + k.h * P + p_lo + p0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            o[j] = o[j] + wk[kk] * racc[i][j] + dsk * dyr[j];
            acc += rnd<T>(k.x(k_lo + kk, p_lo + p0 + j, P)) * racc[i][j];
          }
        }
        part[kk * kGrp + p0 / 4] = acc;
      }
    }
    __syncthreads();
    if (threadIdx.x < kS) {
      float acc = dwa[threadIdx.x];
      for (int grp = 0; grp < tp; ++grp) acc += part[threadIdx.x * kGrp + grp];
      dwa[threadIdx.x] = acc;
    }
    __syncthreads();
  }
  // The head's dB[k, n] += sum_p rnd(rnd(x) w)[k, p] rnd(g)[p, n].
  for (int n_lo = 0; n_lo < N; n_lo += kS) {
    const int nw = min(kS, N - n_lo);
    const int tn = nw / 4;
    const bool mine = threadIdx.x < 16 * tn;
    const int k0 = mine ? (threadIdx.x / tn) * 4 : 0, n0 = mine ? (threadIdx.x % tn) * 4 : 0;
    float bacc[4][4] = {};
    for (int p_lo = 0; p_lo < P; p_lo += kS) {
      const int pw = min(kS, P - p_lo);
      for (int i = threadIdx.x; i < kT; i += kThreads) {
        const int r = i / kS, c = i % kS;  // s0[p][k]: r = p; s1[p][n]: r = p
        s0[c * kS + r] = r < kn && c < pw
            ? rnd<T>(rnd<T>(k.x(k_lo + r, p_lo + c, P)) * wk[r]) : 0.f;
        s1[r * kS + c] = r < pw && c < nw ? rnd<T>(G[(long long)(p_lo + r) * N + n_lo + c]) : 0.f;
      }
      __syncthreads();
      if (mine)
        for (int p = 0; p < pw; ++p) fma4x4(bacc, ld4(s0 + p * kS + k0), ld4(s1 + p * kS + n0));
      __syncthreads();
    }
    if (mine) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + i >= kn) continue;
        float* o = a.dbh + ((row0 + k_lo + k0 + i) * H + k.h) * N + n_lo + n0;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] += bacc[i][j];
      }
    }
  }
  // Per row: ddt and the k-indexed ds; the slab's part of the last-row ds.
  if (threadIdx.x < kS) {
    const int r = threadIdx.x;
    float v = 0.f;
    if (r < kn) {
      const int t = k_lo + r;
      const float dw = dwa[r];
      a.ddt[k.scal(t, H)] = colT[r] + dw * expf(s_last - ss[t]);
      a.dsk[k.scal(t, H)] = -dts[t] * colT[r] - dw * wk[r];
      v = dw * wk[r];
    }
    red[r] = v;
  }
  __shared__ float ghs[kThreads];
  float gh = 0.f;
  if (ks == 0) {  // e^s_last sum(g h_in), once a chunk
    const float* hin = a.hins + (((long long)k.b * k.nc + k.c) * H + k.h) * P * N;
    for (int i = threadIdx.x; i < P * N; i += kThreads) gh += G[i] * hin[i];
  }
  ghs[threadIdx.x] = gh;
  __syncthreads();
  if (threadIdx.x == 0) {  // sums in a fixed order
    float tot = 0.f;
    for (int r = 0; r < kn; ++r) tot += red[r];
    if (ks == 0) {
      float ghsum = 0.f;
      for (int i = 0; i < kThreads; ++i) ghsum += ghs[i];
      tot += expf(s_last) * ghsum;
    }
    a.dslast[(((long long)k.b * k.nc + k.c) * nks + ks) * H + k.h] = tot;
  }
}

// Launch 4: per 64 output rows q of a chunk, grid (nc * nqs, H, B): the
// head's dC and the q-indexed ds.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_qside_kernel(vmt::SsdBwdArgs a, int nqs) {
  extern __shared__ __align__(16) float sm[];
  float* s0 = sm;            // staging
  float* s1 = s0 + kT;       // staging
  float* Dk = s1 + kT;       // [k][q] dcb
  float* Uq = Dk + kT;       // [q][k] U = T dt_k
  float* ss = Uq + 2 * kT;   // [Q] s (one tile left unused)
  float* dts = ss + a.Q;     // [Q] dt
  float* rowU = dts + a.Q;   // [kS] sum_k U[q, k]
  float* rowI = rowU + kS;   // [kS] e^s sum_n dCw C
  float* part = rowI + kS;   // [kS][kGrp]
  const Chunk k(a, blockIdx.x / nqs, gridDim.x / nqs);
  const int qs = blockIdx.x % nqs;
  const int P = a.P, N = a.N, H = a.H, Q = a.Q;
  const int q_lo = qs * kS;
  if (q_lo >= k.valid) return;  // the whole block: before any barrier
  const int qn = min(kS, k.valid - q_lo);
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    ss[i] = a.s[k.scal(i, H)];
    dts[i] = a.dt[k.scal(i, H)];
  }
  if (threadIdx.x < kS) {
    rowU[threadIdx.x] = 0.f;
    rowI[threadIdx.x] = 0.f;
  }
  __syncthreads();
  const long long row0 = (long long)k.b * a.L + k.t0;
  const int mq0 = (threadIdx.x % 16) * 4, mk0 = (threadIdx.x / 16) * 4;

  for (int k_lo = 0; k_lo < q_lo + qn; k_lo += kS) {
    const int kn = min(kS, k.valid - k_lo);
    const bool first = k_lo == 0;
    const bool live = q_lo + mq0 + 3 >= k_lo + mk0;
    float cb[4][4] = {}, dm[4][4] = {};
    causal_tiles<T>(a, k, q_lo, qn, k_lo, kn, mq0, mk0, live, s0, s1, cb, dm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q_lo + mq0 + i, kk = k_lo + mk0 + j;
        const bool ok = kk <= q && q < k.valid && kk < k.valid;
        const float E = ok ? expf(ss[q] - ss[kk]) : 0.f;
        const float dtk = ok ? dts[kk] : 0.f;
        Dk[(mk0 + j) * kS + mq0 + i] = rnd<T>(dm[i][j] * E * dtk);
        Uq[(mq0 + i) * kS + mk0 + j] = dm[i][j] * cb[i][j] * E * dtk;
      }
    }
    __syncthreads();
    if (threadIdx.x < kS) {
      float acc = rowU[threadIdx.x];
      for (int kk = 0; kk < kn; ++kk) acc += Uq[threadIdx.x * kS + kk];
      rowU[threadIdx.x] = acc;
    }
    // The head's dC[q, n] += sum_k dcb[q, k] rnd(B[k, n]), one N tile at a time.
    for (int n_lo = 0; n_lo < N; n_lo += kS) {
      const int nw = min(kS, N - n_lo);
      for (int i = threadIdx.x; i < kT; i += kThreads) {
        const int r = i / kS, n = i % kS;
        s0[i] = r < kn && n < nw ? rnd<T>(k.B(k_lo + r, n_lo + n, N)) : 0.f;
      }
      __syncthreads();
      const int tn = nw / 4;
      if (threadIdx.x < 16 * tn) {
        const int q0 = (threadIdx.x / tn) * 4, n0 = (threadIdx.x % tn) * 4;
        float acc[4][4] = {};
        for (int kk = 0; kk < kn; ++kk)
          fma4x4(acc, ld4(Dk + kk * kS + q0), ld4(s0 + kk * kS + n0));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (q0 + i >= qn) continue;
          float* o = a.dch + ((row0 + q_lo + q0 + i) * H + k.h) * N + n_lo + n0;
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = first ? acc[i][j] : o[j] + acc[i][j];
        }
      }
      __syncthreads();
    }
  }

  // Inter-chunk: dCw = rnd(dy) rnd(h_in), dC += dCw e^s, ds += sum_n dCw rnd(C) e^s.
  const float* hin = a.hins + (((long long)k.b * k.nc + k.c) * H + k.h) * P * N;
  for (int n_lo = 0; n_lo < N; n_lo += kS) {
    const int nw = min(kS, N - n_lo);
    const int tn = nw / 4;
    const bool mine = threadIdx.x < 16 * tn;
    const int q0 = mine ? (threadIdx.x / tn) * 4 : 0, n0 = mine ? (threadIdx.x % tn) * 4 : 0;
    float acc[4][4] = {};
    for (int p_lo = 0; p_lo < P; p_lo += kS) {
      const int pw = min(kS, P - p_lo);
      for (int i = threadIdx.x; i < kT; i += kThreads) {
        const int r = i / kS, c = i % kS;  // s0[p][q]: c = p; s1[p][n]: r = p
        s0[c * kS + r] = r < qn && c < pw ? rnd<T>(k.dy(q_lo + r, p_lo + c, P)) : 0.f;
        s1[r * kS + c] = r < pw && c < nw ? rnd<T>(hin[(long long)(p_lo + r) * N + n_lo + c]) : 0.f;
      }
      __syncthreads();
      if (mine)
        for (int p = 0; p < pw; ++p) fma4x4(acc, ld4(s0 + p * kS + q0), ld4(s1 + p * kS + n0));
      __syncthreads();
    }
    if (mine) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + i;
        float pacc = 0.f;
        if (q < qn) {
          const float es = expf(ss[q_lo + q]);
          float* o = a.dch + ((row0 + q_lo + q) * H + k.h) * N + n_lo + n0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            o[j] += acc[i][j] * es;
            pacc += acc[i][j] * (rnd<T>(k.C(q_lo + q, n_lo + n0 + j, N)) * es);
          }
        }
        part[q * kGrp + n0 / 4] = pacc;
      }
    }
    __syncthreads();
    if (threadIdx.x < kS) {
      float s = rowI[threadIdx.x];
      for (int grp = 0; grp < tn; ++grp) s += part[threadIdx.x * kGrp + grp];
      rowI[threadIdx.x] = s;
    }
    __syncthreads();
  }
  if (threadIdx.x < qn) {
    const int t = q_lo + threadIdx.x;
    a.dsq[k.scal(t, H)] = rowU[threadIdx.x] + rowI[threadIdx.x];
  }
}

// Launch 5: dB and dC of each group, its heads summed in order, into dxbc.
__global__ void ssd_bwd_group_sum_kernel(vmt::SsdBwdArgs a) {
  const int GN = a.G * a.N, Di = a.H * a.P, CD = Di + 2 * GN, hpg = a.H / a.G;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.B * a.L * GN) return;
  const long long row = i / GN;
  const int j = (int)(i % GN), g = j / a.N, n = j % a.N;
  float sb = 0.f, sc = 0.f;
  for (int hh = 0; hh < hpg; ++hh) {
    const long long o = (row * a.H + g * hpg + hh) * a.N + n;
    sb += a.dbh[o];
    sc += a.dch[o];
  }
  a.dxbc[row * CD + Di + j] = sb;
  a.dxbc[row * CD + Di + GN + j] = sc;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

namespace vmt {

template <typename T>
cudaError_t ssd_bwd_core(const SsdBwdArgs& a, cudaStream_t s) {
  if (a.P % 4 || a.N % 4 || a.Q <= 0 || a.G <= 0 || a.H % a.G ||
      side_smem_bytes(a.Q) > 232448)
    return cudaErrorInvalidValue;
  const int nc = (a.L + a.Q - 1) / a.Q, nks = ssd_bwd_slabs(a.Q);
  const size_t per_step = sizeof(float) * (size_t)a.B * nc * a.Q * a.H;
  cudaError_t err;
  if ((err = cudaMemsetAsync(a.dsq, 0, per_step, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(a.dsk, 0, per_step, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(a.ddt, 0, per_step, s)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(a.dslast, 0, sizeof(float) * (size_t)a.B * nc * nks * a.H, s)) !=
      cudaSuccess)
    return err;
  ssd_bwd_dhin_kernel<T><<<dim3(nc, a.H, a.B), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned pn_blocks = (unsigned)((a.P * a.N + kThreads - 1) / kThreads);
  ssd_bwd_state_pass_kernel<<<dim3(a.H, a.B, pn_blocks), kThreads, 0, s>>>(a, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = side_smem_bytes(a.Q);
  if ((err = set_smem(ssd_bwd_kside_kernel<T>, smem)) != cudaSuccess) return err;
  ssd_bwd_kside_kernel<T><<<dim3(nc * nks, a.H, a.B), kThreads, smem, s>>>(a, nks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(ssd_bwd_qside_kernel<T>, smem)) != cudaSuccess) return err;
  ssd_bwd_qside_kernel<T><<<dim3(nc * nks, a.H, a.B), kThreads, smem, s>>>(a, nks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long count = (long long)a.B * a.L * a.G * a.N;
  ssd_bwd_group_sum_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(a);
  return cudaGetLastError();
}

template cudaError_t ssd_bwd_core<float>(const SsdBwdArgs&, cudaStream_t);
template cudaError_t ssd_bwd_core<bf16>(const SsdBwdArgs&, cudaStream_t);

}  // namespace vmt

// K11's backward: xbc (B * L, H P + 2 G N) fp32 rows [x | B | C] holding
// values of the compute dtype (is_bf16), dy (B * L, H P), s and dt (B, Lp,
// H), hins (B, nc, H, P, N), dhlast (B, H, P, N) or null: fp32, contiguous.
// Writes dxbc (B * L, H P + 2 G N) [dx | dB | dC], dsq, dsk and ddt (B, Lp,
// H), dslast (B, nc, ceil(Q / 64), H) and dh0 (B, H, P, N). Scratch (fp32):
// g B nc H P N, dbh and dch B L H N.
extern "C" int vmt_ssd_scan_bwd(const float* xbc, const float* dy, const float* s,
                                const float* dt, const float* hins, const float* dhlast,
                                float* g, float* dxbc, float* dbh, float* dch, float* dsq,
                                float* dsk, float* ddt, float* dslast, float* dh0, int B,
                                int L, int Q, int H, int P, int G, int N, int is_bf16,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vmt::SsdBwdArgs a{xbc, dy, s, dt, hins, dhlast, nullptr, g, dxbc, dbh, dch,
                          dsq, dsk, ddt, dslast, dh0, B, L, Q, H, P, G, N};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? vmt::ssd_bwd_core<bf16>(a, st) : vmt::ssd_bwd_core<float>(a, st));
}
