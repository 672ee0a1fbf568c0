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
//   1. per (causal 64 x 64 tile pair of a chunk, group, batch): C B^T into
//      scratch (cb), K12's launch 4 (ssd_mixer.cu). It depends on the group
//      only, so the H / G heads of a group share it (24 heads at
//      VideoMamba-Base-m2), and it sums over n in the order the per-head
//      tiles did, so at fp32 its values are theirs;
//   2. per (chunk, head, batch): the chunk's own dh_in = rnd(dy)^T rnd(rnd(C)
//      e^s), which does not depend on g;
//   3. per (head, batch, 256 state elements): the short reverse pass
//      g_{c-1} = dh_in,c + e^s_last,c g_c, leaving each chunk's g in place of
//      its dh_in, and dh0;
//   4. per (64 input rows k of a chunk, head, batch): dx, the head's dB, ddt
//      and the k-indexed ds, walking the 64-row output slabs q >= k;
//   5. per (64 output rows q, head, batch): the head's dC and the q-indexed
//      ds, walking the input slabs k <= q;
//   6. per (row, group, state): dB and dC summed over the group's heads.
// Launches 4 and 5 both build dM (per head: it is cheaper to rebuild on the
// slab product than to store, (B, nc, H, Q, Q) fp32 is 82 MB at Base-m2 B =
// 4) and read C B^T from cb, so no block sums into another's rows: there
// are no atomics, and repeated runs give bit-identical gradients. Every
// product is ssd_core.cuh's 64 x 64 slab product, staged from the P and N
// axes 64 at a time, so shared memory (83 KB a block at fp32, 56 KB at
// bf16, chunk 128) grows with neither the head dim nor the state: fp32 FMA
// at fp32 (no TF32: the JAX package's HIGHEST), bf16 mma.sync with fp32
// sums at bf16 (every operand is already rounded to bf16, so the products
// are exact and only the order of the fp32 sums is the tile's).
//
// What bounds it on the H100: operations, about 3.5x the forward's tile
// products (dM twice, M^T dy, dcb B, dcb^T C, the state terms; C B^T once a
// group): about 3.5 GFLOP at VideoMamba-Base-m2, B = 1.
#include "ssd_core_bwd.cuh"

namespace {

using vmt::bf16;

constexpr int kThreads = vmt::kSlabThreads;  // the slab product's 256
constexpr int kS = vmt::kSsdSlab;  // rows of a slab; width of a P or N tile
constexpr int kT = kS * kS;

using vmt::AsIs;
using vmt::kSlabOut;
using vmt::rnd;
using vmt::slab_each;
using vmt::slab_mma;
using vmt::slab_stage;
using vmt::to_slab;

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
  // Row t's x (head-dim column p), B and C (state n) and dy, for staging.
  __device__ const float* x(int t, int p, int P) const {
    return xb + (long long)t * CD + h * P + p;
  }
  __device__ const float* B(int t, int n, int N) const {
    return xb + (long long)t * CD + Di + g * N + n;
  }
  __device__ const float* C(int t, int n, int N) const {
    return xb + (long long)t * CD + Di + GN + g * N + n;
  }
  __device__ const float* dy(int t, int p, int P) const {
    return dyb + (long long)t * Di + h * P + p;
  }
  __device__ long long scal(int t, int H) const { return ((long long)b * Lp + t0 + t) * H + h; }
  // The chunk's C B^T (Q, Q) for the head's group.
  __device__ const float* cb(const vmt::SsdBwdArgs& a) const {
    return a.cb + (((long long)b * nc + c) * a.G + g) * a.Q * a.Q;
  }
};

// Launch 2: g[b, c, h] = sum_q rnd(dy_q)^T rnd(rnd(C_q) e^s_q), grid (nc, H,
// B), one 64 x 64 (P, N) tile at a time, the chunk's rows 64 at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dhin_kernel(vmt::SsdBwdArgs a) {
  using St = vmt::SlabT<T>;
  __shared__ __align__(16) St dys[vmt::slab_elems<T>()];  // [q][p]
  __shared__ __align__(16) St cws[vmt::slab_elems<T>()];  // [q][n]
  __shared__ float es[kS];                                // [q] e^s
  const Chunk k(a, blockIdx.x, gridDim.x);
  const int P = a.P, N = a.N;
  float* G = a.g + (((long long)k.b * k.nc + k.c) * a.H + k.h) * P * N;
  for (int p_lo = 0; p_lo < P; p_lo += kS) {
    const int pw = min(kS, P - p_lo);
    for (int n_lo = 0; n_lo < N; n_lo += kS) {
      const int nw = min(kS, N - n_lo);
      float acc[kSlabOut] = {};
      for (int q_lo = 0; q_lo < k.valid; q_lo += kS) {
        const int qn = min(kS, k.valid - q_lo);
        if (threadIdx.x < qn) es[threadIdx.x] = expf(a.s[k.scal(q_lo + threadIdx.x, a.H)]);
        __syncthreads();
        slab_stage<T, false>(dys, k.dy(q_lo, p_lo, P), k.Di, qn, pw, AsIs());
        slab_stage<T, false>(cws, k.C(q_lo, n_lo, N), k.CD, qn, nw,
                             [&](int r, int, float v) { return rnd<T>(v) * es[r]; });
        __syncthreads();
        slab_mma<T>(acc, dys, cws, qn);
        __syncthreads();
      }
      slab_each<T>([&](int i, int p, int n) {
        if (p < pw && n < nw) G[(long long)(p_lo + p) * N + n_lo + n] = acc[i];
      });
    }
  }
}

// Launch 3: the reverse pass over chunks, one thread per state element of
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

// dM = rnd(dy) rnd(x)^T for output rows [q_lo, q_lo + qn) and input rows
// [k_lo, k_lo + kn) of a chunk, summed over the P axis 64 at a time through
// the staging tiles sA and sB (left free on return).
template <typename T>
__device__ __forceinline__ void slab_dm(const vmt::SsdBwdArgs& a, const Chunk& k, int q_lo,
                                        int qn, int k_lo, int kn, vmt::SlabT<T>* sA,
                                        vmt::SlabT<T>* sB, float (&dm)[kSlabOut]) {
  for (int p_lo = 0; p_lo < a.P; p_lo += kS) {
    const int pw = min(kS, a.P - p_lo);
    slab_stage<T, true>(sA, k.dy(q_lo, p_lo, a.P), k.Di, qn, pw, AsIs());  // [p][q]
    slab_stage<T, true>(sB, k.x(k_lo, p_lo, a.P), k.CD, kn, pw, AsIs());   // [p][k]
    __syncthreads();
    slab_mma<T>(dm, sA, sB, pw);
    __syncthreads();
  }
}

// Launch 4: per 64 input rows k of a chunk, grid (nc * nks, H, B): dx, the
// head's dB, ddt, the k-indexed ds and the slab's part of the last-row ds.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_kside_kernel(vmt::SsdBwdArgs a, int nks) {
  using St = vmt::SlabT<T>;
  constexpr int E = vmt::slab_elems<T>(), sld = vmt::slab_ld<T>();
  extern __shared__ __align__(16) unsigned char smraw[];
  St* sA = reinterpret_cast<St*>(smraw);  // staging
  St* sB = sA + E;                        // staging
  St* Mq = sB + E;                        // [q][k] M
  St* Dq = Mq + E;                        // [q][k] dcb
  float* Tq = reinterpret_cast<float*>(Dq + E);  // [q][k] T; then [k][p] rnd(x) R
  float* ss = Tq + kT;                    // [Q] s
  float* dts = ss + a.Q;                  // [Q] dt
  float* colT = dts + a.Q;                // [kS] sum_q T[q, k]
  float* dwa = colT + kS;                 // [kS] dw
  float* wk = dwa + kS;                   // [kS] w
  float* red = wk + kS;                   // [kS] dw w
  float* ghs = red + kS;                  // [kThreads] partial sums of g h_in
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
  const float* cbb = k.cb(a);

  for (int q_lo = k_lo; q_lo < k.valid; q_lo += kS) {
    const int qn = min(kS, k.valid - q_lo);
    const bool first = q_lo == k_lo;
    float dm[kSlabOut] = {};
    slab_dm<T>(a, k, q_lo, qn, k_lo, kn, sA, sB, dm);
    slab_each<T>([&](int i, int qq, int kk) {
      const int q = q_lo + qq, kx = k_lo + kk;
      const bool ok = kx <= q && q < k.valid && kx < k.valid;
      const float E_ = ok ? expf(ss[q] - ss[kx]) : 0.f;
      const float dtk = ok ? dts[kx] : 0.f;
      const float cbv = ok ? cbb[(long long)q * Q + kx] : 0.f;
      Mq[qq * sld + kk] = to_slab<St>(cbv * E_ * dtk);
      Dq[qq * sld + kk] = to_slab<St>(dm[i] * E_ * dtk);
      Tq[qq * kS + kk] = dm[i] * cbv * E_;
    });
    __syncthreads();
    if (threadIdx.x < kS) {
      float acc = colT[threadIdx.x];
      for (int q = 0; q < qn; ++q) acc += Tq[q * kS + threadIdx.x];
      colT[threadIdx.x] = acc;
    }
    // dx[k, p] += sum_q M[q, k] rnd(dy[q, p]), one P tile at a time.
    for (int p_lo = 0; p_lo < P; p_lo += kS) {
      const int pw = min(kS, P - p_lo);
      slab_stage<T, false>(sA, k.dy(q_lo, p_lo, P), k.Di, qn, pw, AsIs());  // [q][p]
      __syncthreads();
      float acc[kSlabOut] = {};
      slab_mma<T>(acc, Mq, sA, qn);
      slab_each<T>([&](int i, int kk, int p) {
        if (kk >= kn || p >= pw) return;
        float* o = a.dxbc + (row0 + k_lo + kk) * k.CD + k.h * P + p_lo + p;
        *o = first ? acc[i] : *o + acc[i];
      });
      __syncthreads();
    }
    // The head's dB[k, n] += sum_q dcb[q, k] rnd(C[q, n]), one N tile at a time.
    for (int n_lo = 0; n_lo < N; n_lo += kS) {
      const int nw = min(kS, N - n_lo);
      slab_stage<T, false>(sA, k.C(q_lo, n_lo, N), k.CD, qn, nw, AsIs());  // [q][n]
      __syncthreads();
      float acc[kSlabOut] = {};
      slab_mma<T>(acc, Dq, sA, qn);
      slab_each<T>([&](int i, int kk, int n) {
        if (kk >= kn || n >= nw) return;
        float* o = a.dbh + ((row0 + k_lo + kk) * H + k.h) * N + n_lo + n;
        *o = first ? acc[i] : *o + acc[i];
      });
      __syncthreads();
    }
  }

  // The state terms: R = rnd(B) rnd(g)^T, dx += w R + D dy, dw = rowsum(rnd(x) R).
  const float* G = a.g + (((long long)k.b * k.nc + k.c) * H + k.h) * P * N;
  const float dsk = a.Dskip ? a.Dskip[k.h] : 0.f;
  for (int p_lo = 0; p_lo < P; p_lo += kS) {
    const int pw = min(kS, P - p_lo);
    float racc[kSlabOut] = {};
    for (int n_lo = 0; n_lo < N; n_lo += kS) {
      const int nw = min(kS, N - n_lo);
      slab_stage<T, true>(sA, k.B(k_lo, n_lo, N), k.CD, kn, nw, AsIs());        // [n][k]
      slab_stage<T, true>(sB, G + (long long)p_lo * N + n_lo, N, pw, nw, AsIs());  // [n][p]
      __syncthreads();
      slab_mma<T>(racc, sA, sB, nw);
      __syncthreads();
    }
    slab_each<T>([&](int i, int kk, int p) {
      float v = 0.f;
      if (kk < kn && p < pw) {
        const long long row = row0 + k_lo + kk;
        float* o = a.dxbc + row * k.CD + k.h * P + p_lo + p;
        *o = *o + wk[kk] * racc[i] + dsk * a.dy[row * k.Di + k.h * P + p_lo + p];
        v = rnd<T>(*k.x(k_lo + kk, p_lo + p, P)) * racc[i];
      }
      Tq[kk * kS + p] = v;
    });
    __syncthreads();
    if (threadIdx.x < kS) {  // dw's sum over p, in order
      float acc = dwa[threadIdx.x];
      for (int p = 0; p < pw; ++p) acc += Tq[threadIdx.x * kS + p];
      dwa[threadIdx.x] = acc;
    }
    __syncthreads();
  }
  // The head's dB[k, n] += sum_p rnd(rnd(x) w)[k, p] rnd(g)[p, n].
  for (int n_lo = 0; n_lo < N; n_lo += kS) {
    const int nw = min(kS, N - n_lo);
    float bacc[kSlabOut] = {};
    for (int p_lo = 0; p_lo < P; p_lo += kS) {
      const int pw = min(kS, P - p_lo);
      slab_stage<T, true>(sA, k.x(k_lo, p_lo, P), k.CD, kn, pw,
                          [&](int r, int, float v) { return rnd<T>(v) * wk[r]; });  // [p][k]
      slab_stage<T, false>(sB, G + (long long)p_lo * N + n_lo, N, pw, nw, AsIs());  // [p][n]
      __syncthreads();
      slab_mma<T>(bacc, sA, sB, pw);
      __syncthreads();
    }
    slab_each<T>([&](int i, int kk, int n) {
      if (kk < kn && n < nw) a.dbh[((row0 + k_lo + kk) * H + k.h) * N + n_lo + n] += bacc[i];
    });
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

// Launch 5: per 64 output rows q of a chunk, grid (nc * nqs, H, B): the
// head's dC and the q-indexed ds.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_qside_kernel(vmt::SsdBwdArgs a, int nqs) {
  using St = vmt::SlabT<T>;
  constexpr int E = vmt::slab_elems<T>(), sld = vmt::slab_ld<T>();
  extern __shared__ __align__(16) unsigned char smraw[];
  St* sA = reinterpret_cast<St*>(smraw);  // staging
  St* sB = sA + E;                        // staging
  St* Dk = sB + E;                        // [k][q] dcb (one staging tile left unused)
  float* Uq = reinterpret_cast<float*>(Dk + 2 * E);  // [q][k] U = T dt_k; then [q][n]
  float* ss = Uq + kT;                    // [Q] s
  float* dts = ss + a.Q;                  // [Q] dt
  float* rowU = dts + a.Q;                // [kS] sum_k U[q, k]
  float* rowI = rowU + kS;                // [kS] e^s sum_n dCw C
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
  const float* cbb = k.cb(a);

  for (int k_lo = 0; k_lo < q_lo + qn; k_lo += kS) {
    const int kn = min(kS, k.valid - k_lo);
    const bool first = k_lo == 0;
    float dm[kSlabOut] = {};
    slab_dm<T>(a, k, q_lo, qn, k_lo, kn, sA, sB, dm);
    slab_each<T>([&](int i, int qq, int kk) {
      const int q = q_lo + qq, kx = k_lo + kk;
      const bool ok = kx <= q && q < k.valid && kx < k.valid;
      const float E_ = ok ? expf(ss[q] - ss[kx]) : 0.f;
      const float dtk = ok ? dts[kx] : 0.f;
      const float cbv = ok ? cbb[(long long)q * Q + kx] : 0.f;
      Dk[kk * sld + qq] = to_slab<St>(dm[i] * E_ * dtk);
      Uq[qq * kS + kk] = dm[i] * cbv * E_ * dtk;
    });
    __syncthreads();
    if (threadIdx.x < kS) {
      float acc = rowU[threadIdx.x];
      for (int kk = 0; kk < kn; ++kk) acc += Uq[threadIdx.x * kS + kk];
      rowU[threadIdx.x] = acc;
    }
    // The head's dC[q, n] += sum_k dcb[q, k] rnd(B[k, n]), one N tile at a time.
    for (int n_lo = 0; n_lo < N; n_lo += kS) {
      const int nw = min(kS, N - n_lo);
      slab_stage<T, false>(sA, k.B(k_lo, n_lo, N), k.CD, kn, nw, AsIs());  // [k][n]
      __syncthreads();
      float acc[kSlabOut] = {};
      slab_mma<T>(acc, Dk, sA, kn);
      slab_each<T>([&](int i, int qq, int n) {
        if (qq >= qn || n >= nw) return;
        float* o = a.dch + ((row0 + q_lo + qq) * H + k.h) * N + n_lo + n;
        *o = first ? acc[i] : *o + acc[i];
      });
      __syncthreads();
    }
  }

  // Inter-chunk: dCw = rnd(dy) rnd(h_in), dC += dCw e^s, ds += sum_n dCw rnd(C) e^s.
  const float* hin = a.hins + (((long long)k.b * k.nc + k.c) * H + k.h) * P * N;
  for (int n_lo = 0; n_lo < N; n_lo += kS) {
    const int nw = min(kS, N - n_lo);
    float acc[kSlabOut] = {};
    for (int p_lo = 0; p_lo < P; p_lo += kS) {
      const int pw = min(kS, P - p_lo);
      slab_stage<T, true>(sA, k.dy(q_lo, p_lo, P), k.Di, qn, pw, AsIs());            // [p][q]
      slab_stage<T, false>(sB, hin + (long long)p_lo * N + n_lo, N, pw, nw, AsIs());  // [p][n]
      __syncthreads();
      slab_mma<T>(acc, sA, sB, pw);
      __syncthreads();
    }
    slab_each<T>([&](int i, int qq, int n) {
      float v = 0.f;
      if (qq < qn && n < nw) {
        const float es = expf(ss[q_lo + qq]);
        float* o = a.dch + ((row0 + q_lo + qq) * H + k.h) * N + n_lo + n;
        *o += acc[i] * es;
        v = acc[i] * (rnd<T>(*k.C(q_lo + qq, n_lo + n, N)) * es);
      }
      Uq[qq * kS + n] = v;
    });
    __syncthreads();
    if (threadIdx.x < kS) {  // the row's sum over n, in order
      float acc2 = rowI[threadIdx.x];
      for (int n = 0; n < nw; ++n) acc2 += Uq[threadIdx.x * kS + n];
      rowI[threadIdx.x] = acc2;
    }
    __syncthreads();
  }
  if (threadIdx.x < qn) {
    const int t = q_lo + threadIdx.x;
    a.dsq[k.scal(t, H)] = rowU[threadIdx.x] + rowI[threadIdx.x];
  }
}

// Launch 6: dB and dC of each group, its heads summed in order, into dxbc.
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
  if (a.P % 4 || a.N % 4 || a.Q <= 0 || a.G <= 0 || a.H % a.G || ssd_smem_bytes(a.Q) > 232448)
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
  if ((err = ssd_cb<T>(a.xbc, a.cb, a.B, a.L, a.Q, a.H, a.P, a.G, a.N, s)) != cudaSuccess)
    return err;
  ssd_bwd_dhin_kernel<T><<<dim3(nc, a.H, a.B), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned pn_blocks = (unsigned)((a.P * a.N + kThreads - 1) / kThreads);
  ssd_bwd_state_pass_kernel<<<dim3(a.H, a.B, pn_blocks), kThreads, 0, s>>>(a, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = ssd_side_smem_bytes<T>(a.Q);
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
// g B nc H P N, dbh and dch B L H N, cb B nc G Q Q.
extern "C" int vmt_ssd_scan_bwd(const float* xbc, const float* dy, const float* s,
                                const float* dt, const float* hins, const float* dhlast,
                                float* g, float* dxbc, float* dbh, float* dch, float* dsq,
                                float* dsk, float* ddt, float* dslast, float* dh0, float* cb,
                                int B, int L, int Q, int H, int P, int G, int N, int is_bf16,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vmt::SsdBwdArgs a{xbc, dy, s, dt, hins, dhlast, nullptr, g, dxbc, dbh, dch,
                          dsq, dsk, ddt, dslast, dh0, cb, B, L, Q, H, P, G, N};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? vmt::ssd_bwd_core<bf16>(a, st) : vmt::ssd_bwd_core<float>(a, st));
}
