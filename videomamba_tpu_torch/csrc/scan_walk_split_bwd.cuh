// Reverse-time walk of the selective scan for Hopper that splits the time
// axis across blocks: the walk of the selective-scan backward
// (selective_scan_bwd.cu, K5), the fused-mixer backward (mixer_bwd.cu, K6)
// and the whole-block backward (block_bwd.cu, K7). The math, the operands
// (ScanBwdArgs) and the reductions are scan_walk_bwd.cuh's; the forward
// split walk is scan_walk_split.cuh. The mixers walk with a z gate and dt
// through softplus; K5's contract also takes no gate and a raw dt (kZ and
// kSoftplus, template arguments), and a null Dskip or delta_bias reads as
// zeros.
//
// Why split: one block of 64 channels walking all L steps from the last
// segment down to the first gives ceil(Di / 64) x batch blocks, 24 at
// VideoMamba-Base, batch 1, on a 132-SM card, each step waiting out two
// dependent chains 1569 times. Of those chains only one crosses a
// segment: the rebuild of the pre-update states starts at each 16-step
// checkpoint, but the cotangent chain
//   dh_n = C_n g2 + s_n,   s_n <- a_n dh_n        (a_n = exp(dt A_n))
// carries s from the end of time (the cotangent of h_last) to the start
// (dh0). It is linear in s, so a chunk of time maps its incoming carry s_in
// to exp(A S_c) s_in + e_c, with S_c the sum of the chunk's dt and e_c its
// carry-out from s_in = 0. Time is cut into chunks of `chunk` steps (a
// multiple of kScanTile, so every chunk starts at a checkpoint; the wrapper
// chooses it so each walking launch fills the card), and the walk runs as
// three launches:
//   (a) chunk cotangents: each (b, 64 channels, chunk c > 0) walks its chunk
//       backwards from s = 0, the cotangent chain alone (no rebuild, no
//       outputs), and stores e_c[d][n] and S_c[d];
//   (b) pass: one thread per (b, d, n) walks the chunks in reverse from the
//       h_last cotangent, s <- exp(A S_c) s + e_c, and overwrites e_c with
//       s, the incoming carry of chunk c - 1;
//   (c) output walk: each (b, 64 channels, chunk) walks its chunk again from
//       its incoming carry with scan_walk_bwd.cuh's rebuild, segment by
//       segment, writing du, ddelta_raw, dz, the per-step dB / dC partials,
//       with kY K7's gated output y, and its own dA, dD and dbias partials
//       (summed over chunks and batch by one launch in a fixed order); chunk
//       0 ends on dh0.
// What is per (t, d) and off the chains (softplus of dt, g silu(z), the dz
// and y gate factors) is computed while a segment is staged, and the choices
// (kY, the state size) are template arguments. No floating-point atomics:
// every value is written by one thread and every sum has a fixed order, so
// two runs are bit-identical. Splitting reassociates the cotangent
// recurrence: a chunk's carry is exp(A S) s + e in place of the step-by-step
// product, within a few fp32 ulps.
//
// What bounds it on the H100 (Base, batch 1, L 1569, fp32): the bytes are
// about 50 MB (u, delta, z, g read; du, ddelta, dz, y written; the
// per-channel-block dB / dC partials), 0.015 ms at 3.35 TB/s; the exps are
// about 3.5 B L Di N (rebuild 1.5, reverse 1, chunk cotangents 1) on the
// MUFU units. The chunks put ceil(Di / 64) x nchunks blocks on the card
// where a walk over all of time has 24, so the walk becomes a matter of
// throughput and occupancy (the output walk's rebuilt states take 32 KB of
// shared memory a block at N = 16).
#pragma once

#include "scan_walk_bwd.cuh"

namespace vmt {

// Scratch of the split reverse walk, in the caller's fp32 scratch: carry
// (batch, nchunks - 1, D, N) and dtsum (batch, nchunks - 1, D), where
// nchunks = ceil(L / chunk); unused (may be null) when nchunks is 1. The
// ScanBwdArgs partials dA_part, dD_part and dbias_part hold
// (batch, nchunks, D[, N]) rows here, one per chunk.
struct SplitBwdArgs {
  float* carry;
  float* dtsum;
  int chunk;  // steps per chunk, a multiple of kScanTile
};

// Phase (a) on chunk blockIdx.y + 1 of batch row blockIdx.z, channels
// blockIdx.x * kBwdThreads + [0, 64): the chunk's carry-out from a zero
// carry, and the sum of its dt. Chunk 0 has none: its carry-out is dh0,
// which the output walk ends on.
template <int N, typename TU, typename TZ, bool kZ, bool kSoftplus>
__global__ void __launch_bounds__(kBwdThreads) split_bwd_chunk_kernel(ScanBwdArgs a,
                                                                       SplitBwdArgs sp) {
  __shared__ float sDt[kScanTile][kBwdThreads];
  __shared__ float sG2[kScanTile][kBwdThreads];
  __shared__ float sC[kScanTile][N];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kBwdThreads + tid;
  const bool active = d < a.D;
  const long long b = blockIdx.z;
  const long long c = blockIdx.y + 1;
  const long long L = a.L;
  const long long D = a.D;
  const long long nc1 = (L + sp.chunk - 1) / sp.chunk - 1;
  const long long t_begin = c * sp.chunk;
  const long long t_end = min(L, t_begin + sp.chunk);

  float A[N], s[N];
  float dbias = 0.f, dtsum = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = active ? a.A[d * N + n] : 0.f;
    s[n] = 0.f;
  }
  if (active && a.delta_bias) dbias = a.delta_bias[d];

  const TU* dt_b = (const TU*)a.delta + b * L * a.ld_delta;
  const TZ* z_b = kZ ? (const TZ*)a.z + b * L * a.ld_z : nullptr;
  const TZ* g_b = (const TZ*)a.g + b * L * a.ld_g;
  const TU* C_b = (const TU*)a.C + b * L * a.ld_C;

  for (long long t0 = t_begin + (t_end - 1 - t_begin) / kScanTile * kScanTile; t0 >= t_begin;
       t0 -= kScanTile) {
    const int steps = (int)min((long long)kScanTile, t_end - t0);
    __syncthreads();  // the previous tile has been consumed
    if (active) {
      float gr[kScanTile];
#pragma unroll
      for (int k = 0; k < kScanTile; ++k) {
        if (k < steps) {
          const long long t = t0 + k;
          sDt[k][tid] = load_f32(dt_b + t * a.ld_delta + d);
          if constexpr (kZ) sG2[k][tid] = load_f32(z_b + t * a.ld_z + d);
          gr[k] = load_f32(g_b + t * a.ld_g + d);
        }
      }
#pragma unroll
      for (int k = 0; k < kScanTile; ++k) {
        if (k < steps) {
          if constexpr (kSoftplus) {
            sDt[k][tid] = softplus_f(sDt[k][tid] + dbias);
          } else {
            sDt[k][tid] += dbias;
          }
          if constexpr (kZ) {
            const float zz = sG2[k][tid];
            sG2[k][tid] = gr[k] * (zz * (1.f / (1.f + expf(-zz))));
          } else {
            sG2[k][tid] = gr[k];
          }
        }
      }
    }
    for (int i = tid; i < steps * N; i += kBwdThreads) {
      const int k = i / N;
      const int n = i - k * N;
      sC[k][n] = load_f32(C_b + (t0 + k) * a.ld_C + n);
    }
    __syncthreads();
    if (!active) continue;
    for (int k = steps - 1; k >= 0; --k) {
      const float dt = sDt[k][tid];
      const float g2 = sG2[k][tid];
      dtsum += dt;
#pragma unroll
      for (int n = 0; n < N; ++n) s[n] = expf(dt * A[n]) * (sC[k][n] * g2 + s[n]);
    }
  }
  if (!active) return;
  float* out = sp.carry + ((b * nc1 + c - 1) * D + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) out[n] = s[n];
  sp.dtsum[(b * nc1 + c - 1) * D + d] = dtsum;
}

constexpr int kBwdPassThreads = 256;
constexpr int kBwdPassBatch = 8;  // chunks whose loads a thread issues together

// Phase (b): thread (b, d, n) turns the h_last cotangent and the chunks'
// carry-outs into each chunk's incoming carry, in place: slot c - 1 holds
// e_c and S_c on entry and the carry into chunk c - 1 on exit.
static __global__ void __launch_bounds__(kBwdPassThreads)
    split_bwd_pass_kernel(const float* __restrict__ A, const float* __restrict__ g_hlast,
                          float* carry, const float* __restrict__ dtsum, int D, int N, int nc1,
                          long long total) {
  const long long i = (long long)blockIdx.x * kBwdPassThreads + threadIdx.x;
  if (i >= total) return;
  const long long bd = i / N;
  const long long b = bd / D;
  const long long d = bd - b * D;
  const long long dn = i - b * D * N;
  const float a = A[d * N + (i - bd * N)];
  float s = g_hlast ? g_hlast[i] : 0.f;
  for (int c0 = nc1 - 1; c0 >= 0; c0 -= kBwdPassBatch) {
    float e[kBwdPassBatch];
    float sum[kBwdPassBatch];
#pragma unroll
    for (int j = 0; j < kBwdPassBatch; ++j) {
      if (c0 - j >= 0) {
        const long long row = b * nc1 + c0 - j;
        e[j] = carry[row * D * N + dn];
        sum[j] = dtsum[row * D + d];
      }
    }
#pragma unroll
    for (int j = 0; j < kBwdPassBatch; ++j) {
      if (c0 - j >= 0) {
        s = expf(a * sum[j]) * s + e[j];
        carry[(b * nc1 + c0 - j) * D * N + dn] = s;
      }
    }
  }
}

template <int N, bool kY>
constexpr size_t split_bwd_smem_bytes() {
  return sizeof(float) * ((size_t)bwd_sub<N>() * N * kBwdThreads  // rebuilt states
                          + (kY ? 5 : 4) * kScanTile * kBwdThreads  // u, dt, g2, dz gate[, y gate]
                          + 2 * kScanTile * N                       // B, C
                          + 2 * bwd_sub<N>() * 2 * N);              // warp partials
}

// Phase (c) on chunk blockIdx.y of batch row blockIdx.z, channels
// blockIdx.x * kBwdThreads + [0, 64): the segment walk of scan_walk_bwd.cuh's
// layout (rebuild, then the cotangent back) over the chunk's segments, from
// the chunk's incoming carry. kY needs kZ.
template <int N, typename TU, typename TZ, typename TO, bool kY, bool kZ, bool kSoftplus>
__global__ void __launch_bounds__(kBwdThreads) split_bwd_output_kernel(ScanBwdArgs a,
                                                                        SplitBwdArgs sp) {
  static_assert(kZ || !kY, "the gated output needs the gate");
  extern __shared__ float smem[];
  constexpr int kSub = bwd_sub<N>();
  constexpr int T = kScanTile * kBwdThreads;
  float* sH = smem;                          // [kSub][N][64]
  float* sU = sH + kSub * N * kBwdThreads;   // [16][64]
  float* sDt = sU + T;
  float* sG2 = sDt + T;                      // g silu(z)
  float* sGz = sG2 + T;                      // g silu'(z): dz = pre sGz
  float* sYz = sGz + T;                      // silu(z): y = pre sYz (kY)
  float* sB = sYz + (kY ? T : 0);            // [16][N]
  float* sC = sB + kScanTile * N;
  float* sRed = sC + kScanTile * N;          // [2][kSub][2N]
  constexpr int V = 2 * N;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int d = blockIdx.x * kBwdThreads + tid;
  const bool active = d < a.D;
  const long long b = blockIdx.z;
  const long long c = blockIdx.y;
  const long long L = a.L;
  const long long D = a.D;
  const long long nseg = (L + kScanTile - 1) / kScanTile;
  const long long nchunks = (L + sp.chunk - 1) / sp.chunk;
  const long long ncb = gridDim.x;
  const long long t_begin = c * sp.chunk;
  const long long t_end = min(L, t_begin + sp.chunk);

  float A[N], s[N], dAacc[N], h[N];
  float dskip = 0.f, dbias = 0.f;
  const float* s_in = c == nchunks - 1
                          ? (a.g_hlast ? a.g_hlast + (b * D + d) * N : nullptr)
                          : sp.carry + ((b * (nchunks - 1) + c) * D + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = active ? a.A[d * N + n] : 0.f;
    s[n] = (active && s_in) ? s_in[n] : 0.f;
    dAacc[n] = 0.f;
  }
  if (active && a.Dskip) dskip = a.Dskip[d];
  if (active && a.delta_bias) dbias = a.delta_bias[d];
  float dDacc = 0.f, dbacc = 0.f;

  const TU* u_b = (const TU*)a.u + b * L * a.ld_u;
  const TU* dt_b = (const TU*)a.delta + b * L * a.ld_delta;
  const TZ* z_b = kZ ? (const TZ*)a.z + b * L * a.ld_z : nullptr;
  const TZ* g_b = (const TZ*)a.g + b * L * a.ld_g;
  const TU* B_b = (const TU*)a.B + b * L * a.ld_B;
  const TU* C_b = (const TU*)a.C + b * L * a.ld_C;
  TO* du_b = (TO*)a.du + b * L * a.ld_du;
  TO* dd_b = (TO*)a.ddelta + b * L * a.ld_ddelta;
  TZ* dz_b = kZ ? (TZ*)a.dz + b * L * a.ld_dz : nullptr;
  float* part_b = a.bc_part + (b * ncb + blockIdx.x) * L * V;

  for (long long seg = (t_end - 1) / kScanTile; seg >= t_begin / kScanTile; --seg) {
    const long long t0 = seg * kScanTile;
    const int steps = (int)min((long long)kScanTile, L - t0);
    __syncthreads();  // the previous segment's staging has been consumed
    if (active) {
      // Raw loads first, all of a segment's in flight together, then the
      // per-(t, d) arithmetic on this thread's own column.
      float zr[kScanTile], gr[kScanTile];
#pragma unroll
      for (int k = 0; k < kScanTile; ++k) {
        if (k < steps) {
          const long long t = t0 + k;
          sDt[k * kBwdThreads + tid] = load_f32(dt_b + t * a.ld_delta + d);
          sU[k * kBwdThreads + tid] = load_f32(u_b + t * a.ld_u + d);
          if constexpr (kZ) zr[k] = load_f32(z_b + t * a.ld_z + d);
          gr[k] = load_f32(g_b + t * a.ld_g + d);
        }
      }
#pragma unroll
      for (int k = 0; k < kScanTile; ++k) {
        if (k < steps) {
          const int o = k * kBwdThreads + tid;
          if constexpr (kSoftplus) {
            sDt[o] = softplus_f(sDt[o] + dbias);
          } else {
            sDt[o] += dbias;
          }
          if constexpr (kZ) {
            const float zz = zr[k];
            const float sig = 1.f / (1.f + expf(-zz));
            sG2[o] = gr[k] * (zz * sig);
            sGz[o] = gr[k] * (sig * (1.f + zz * (1.f - sig)));
            if constexpr (kY) sYz[o] = zz * sig;
          } else {
            sG2[o] = gr[k];
          }
        }
      }
    } else {
      // Zeros keep an idle lane's terms of the warp's dB / dC sums at 0.
#pragma unroll
      for (int k = 0; k < kScanTile; ++k) {
        const int o = k * kBwdThreads + tid;
        sDt[o] = sU[o] = sG2[o] = 0.f;
      }
    }
    for (int i = tid; i < steps * N; i += kBwdThreads) {
      const int k = i / N;
      const int n = i - k * N;
      sB[k * N + n] = load_f32(B_b + (t0 + k) * a.ld_B + n);
      sC[k * N + n] = load_f32(C_b + (t0 + k) * a.ld_C + n);
    }
    __syncthreads();

    for (int sub = kScanTile / kSub - 1; sub >= 0; --sub) {
      const int s0 = sub * kSub;
      const int m = min(kSub, steps - s0);
      if (m <= 0) continue;  // uniform over the block
      // Chain 1: from the segment checkpoint to the part's first step, then
      // through the part, keeping each pre-update state.
      const float* ck = a.ckpt + ((b * nseg + seg) * D + (active ? d : 0)) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = active ? ck[n] : 0.f;
      for (int k = 0; k < s0 + m; ++k) {
        const float dt = sDt[k * kBwdThreads + tid];
        const float du = dt * sU[k * kBwdThreads + tid];
        const int kk = k - s0;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          if (kk >= 0) sH[(kk * N + n) * kBwdThreads + tid] = h[n];
          h[n] = expf(dt * A[n]) * h[n] + du * sB[k * N + n];
        }
      }
      // Chain 2: the cotangent, back through the part.
      for (int kk = m - 1; kk >= 0; --kk) {
        const int k = s0 + kk;
        const int o = k * kBwdThreads + tid;
        const float dt = sDt[o];
        const float uu = sU[o];
        const float g2 = sG2[o];
        const float du = dt * uu;
        float term1 = 0.f, sBv = 0.f, pre = 0.f;
        float vals[V];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float hp = sH[(kk * N + n) * kBwdThreads + tid];
          const float an = expf(dt * A[n]);
          const float bn = sB[k * N + n];
          const float cn = sC[k * N + n];
          const float hn = an * hp + du * bn;
          const float dh = cn * g2 + s[n];
          s[n] = an * dh;
          const float daa = dh * hp * an;
          dAacc[n] += daa * dt;
          term1 += daa * A[n];
          sBv += dh * bn;
          pre += cn * hn;
          vals[n] = dh * du;
          vals[N + n] = hn * g2;
        }
        float ddr = term1 + uu * sBv;
        if constexpr (kSoftplus) ddr *= 1.f - expf(-dt);
        dbacc += ddr;
        dDacc += g2 * uu;
        if (active) {
          const long long t = t0 + k;
          store_as(du_b + t * a.ld_du + d, dt * sBv + g2 * dskip);
          store_as(dd_b + t * a.ld_ddelta + d, ddr);
          if constexpr (kZ) {
            pre += uu * dskip;
            store_as(dz_b + t * a.ld_dz + d, pre * sGz[o]);
            if constexpr (kY) a.y[(b * L + t) * a.ld_y + d] = pre * sYz[o];
          }
        }
        warp_reduce_scatter<V, V, 16>(vals, lane);
        constexpr int R = V >= 32 ? V / 32 : 1;
        const int base = (lane * V) / 32;
        if ((lane * V) % 32 == 0 || V >= 32) {
#pragma unroll
          for (int i = 0; i < R; ++i) sRed[(warp * kSub + kk) * V + base + i] = vals[i];
        }
      }
      __syncthreads();
      for (int i = tid; i < m * V; i += kBwdThreads) {
        const int kk = i / V;
        const int j = i - kk * V;
        part_b[(t0 + s0 + kk) * V + j] = sRed[kk * V + j] + sRed[(kSub + kk) * V + j];
      }
      __syncthreads();
    }
  }

  if (active) {
    const long long row = b * nchunks + c;
#pragma unroll
    for (int n = 0; n < N; ++n) a.dA_part[(row * D + d) * N + n] = dAacc[n];
    a.dD_part[row * D + d] = dDacc;
    a.dbias_part[row * D + d] = dbacc;
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) a.dh0[(b * D + d) * N + n] = s[n];
    }
  }
}

template <int N, typename TU, typename TZ, typename TO, bool kY, bool kZ, bool kSoftplus>
cudaError_t launch_split_bwd_n(const ScanBwdArgs& a, const SplitBwdArgs& sp, int batch,
                               cudaStream_t stream) {
  const int nchunks = (a.L + sp.chunk - 1) / sp.chunk;
  const unsigned groups = (a.D + kBwdThreads - 1) / kBwdThreads;
  cudaError_t err;
  if (nchunks > 1) {
    split_bwd_chunk_kernel<N, TU, TZ, kZ, kSoftplus>
        <<<dim3(groups, nchunks - 1, batch), kBwdThreads, 0, stream>>>(a, sp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long total = (long long)batch * a.D * N;
    split_bwd_pass_kernel<<<(unsigned)((total + kBwdPassThreads - 1) / kBwdPassThreads),
                            kBwdPassThreads, 0, stream>>>(a.A, a.g_hlast, sp.carry, sp.dtsum,
                                                          a.D, N, nchunks - 1, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  constexpr size_t smem = split_bwd_smem_bytes<N, kY>();
  err = cudaFuncSetAttribute(split_bwd_output_kernel<N, TU, TZ, TO, kY, kZ, kSoftplus>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  split_bwd_output_kernel<N, TU, TZ, TO, kY, kZ, kSoftplus>
      <<<dim3(groups, nchunks, batch), kBwdThreads, smem, stream>>>(a, sp);
  return cudaGetLastError();
}

// The three launches (only (c) when L fits one chunk) and the dA / dD /
// dbias sum over chunks and batch (dD, dbias may be null) for the state
// sizes the library is built for (N in {8, 16, 32, 64, 128}). dB and dC stay
// in a.bc_part for launch_reduce_bc. kZ (a.z and a.dz) and kSoftplus
// (a.softplus) must match the operands: the mixers walk with both, K5 with
// any of the four; kY needs a.y.
template <typename TU, typename TZ, typename TO, bool kY = false, bool kZ = true,
          bool kSoftplus = true>
cudaError_t launch_scan_bwd_split(const ScanBwdArgs& a, const SplitBwdArgs& sp, int batch,
                                  int n, float* dA, float* dD, float* dbias,
                                  cudaStream_t stream) {
  if ((a.z != nullptr) != kZ || (a.dz != nullptr) != kZ || (a.softplus != 0) != kSoftplus ||
      (kY && !a.y) || a.L < 1 || sp.chunk < kScanTile ||
      sp.chunk % kScanTile != 0 || (a.L > sp.chunk && (!sp.carry || !sp.dtsum)) ||
      (a.L + sp.chunk - 1) / sp.chunk > 65535 || batch > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  switch (n) {
    case 8:
      err = launch_split_bwd_n<8, TU, TZ, TO, kY, kZ, kSoftplus>(a, sp, batch, stream);
      break;
    case 16:
      err = launch_split_bwd_n<16, TU, TZ, TO, kY, kZ, kSoftplus>(a, sp, batch, stream);
      break;
    case 32:
      err = launch_split_bwd_n<32, TU, TZ, TO, kY, kZ, kSoftplus>(a, sp, batch, stream);
      break;
    case 64:
      err = launch_split_bwd_n<64, TU, TZ, TO, kY, kZ, kSoftplus>(a, sp, batch, stream);
      break;
    case 128:
      err = launch_split_bwd_n<128, TU, TZ, TO, kY, kZ, kSoftplus>(a, sp, batch, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int rows = batch * ((a.L + sp.chunk - 1) / sp.chunk);  // (b, chunk) partial rows
  const long long total = (long long)a.D * n + 2LL * a.D;
  reduce_batch_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      a.dA_part, a.dD_part, a.dbias_part, rows, a.D, n, dA, dD, dbias);
  return cudaGetLastError();
}

// K5's walk and sums (selective_scan_bwd.cu) at operand type T (u, delta,
// z, B, C, g and their gradients) for each gate and softplus choice: the
// split reverse walk, the dA / dD / dbias sums, then the channel-block sum
// of dB / dC. selective_scan_bwd.cu instantiates it for fp32 and
// selective_scan_bwd_bf16.cu for bf16, so the two compile in parallel.
template <typename T>
cudaError_t selective_scan_bwd_walk(const ScanBwdArgs& a, const SplitBwdArgs& sp, int batch,
                                    int n, float* dA, float* dD, float* dbias, T* dB, T* dC,
                                    cudaStream_t s) {
  cudaError_t err;
  if (a.z) {
    err = a.softplus
              ? launch_scan_bwd_split<T, T, T, false, true, true>(a, sp, batch, n, dA, dD, dbias, s)
              : launch_scan_bwd_split<T, T, T, false, true, false>(a, sp, batch, n, dA, dD, dbias,
                                                                   s);
  } else {
    err = a.softplus
              ? launch_scan_bwd_split<T, T, T, false, false, true>(a, sp, batch, n, dA, dD, dbias,
                                                                   s)
              : launch_scan_bwd_split<T, T, T, false, false, false>(a, sp, batch, n, dA, dD,
                                                                    dbias, s);
  }
  if (err != cudaSuccess) return err;
  return launch_reduce_bc<T>(a.bc_part, batch, a.D, a.L, n, dB, n, dC, n, s);
}

}  // namespace vmt
