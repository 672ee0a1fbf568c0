// Reverse-time walk of the selective scan: every gradient of scan_walk.cuh's
// recurrence, the walk of the selective-scan backward (selective_scan_bwd.cu,
// K5). The fused-mixer backward (K6) and the whole-block backward (K7) walk
// with the time-split reverse walk of scan_walk_split_bwd.cuh, which shares
// this file's operands (ScanBwdArgs), warp reduce-scatter and reductions.
//
// Math (videomamba_tpu/ops/pallas/scan.py:401-505), per (b, d), fp32, with
// dt = softplus(delta + bias), a_n = exp(dt A_n), g2 = g silu(z):
//   chain 1 (forward): rebuild the pre-update states h_{t-1} of a segment
//     from its checkpoint (the forward walk's segment-start state);
//   chain 2 (reverse): dh_n = C_n g2 + s_n, s_n <- a_n dh_n (s starts at
//     the cotangent of h_last; its final value is dh0);
//   du     = dt sum_n dh_n B_n + g2 D
//   ddelta = sum_n dh_n h_{t-1,n} a_n A_n + u sum_n dh_n B_n, times
//            (1 - exp(-dt)) under softplus (d softplus = sigmoid)
//   dz     = g (sum_n C_n h_n + u D) sig(z) (1 + z (1 - sig(z)))
//   dA_n  += dh_n h_{t-1,n} a_n dt;  dD += g2 u;  dbias += ddelta_raw
//   dB_n   = sum_d dh_n dt u;  dC_n = sum_d h_n g2   (sums over channels)
//
// Layout and design. One thread owns one (b, d) and its N states, as in the
// forward; a block holds kBwdThreads = 64 channels (two warps). Checkpoints
// are one per kScanTile = 16 steps. A segment is staged in shared memory
// (u, dt, z, g, B, C) and walked back in two halves of kBwdSub = 8 steps:
// each half rebuilds its pre-update states from the segment checkpoint and
// keeps them in shared memory (8 x N x 64 floats: 32 KB at N = 16), since
// 16 x N per thread does not fit in registers. Rebuilding the second half
// first re-runs the first half's 8 steps: 1.5 forward rebuilds per segment
// instead of 1, traded for half the shared memory. At N = 128 the walk goes
// back in quarters of 4 steps (2.5 rebuilds a segment), so its rebuilt
// states keep to 128 KB; its per-thread arrays then spill to local memory.
//
// Reductions without floating-point atomics, so repeated runs are
// bit-identical: dB and dC (2N values a step, summed over channels) are
// reduced over each warp's 32 lanes by a butterfly reduce-scatter (2N - 1
// shuffles for 2N = 32), the two warps are added in a fixed order in shared
// memory, and each channel block writes its own partial row; a second launch
// sums the partials over channel blocks in order. dA, dD and dbias are summed
// over time in each thread's registers and over the batch by a third launch.
//
// What bounds it: the two serial chains per step (latency), as in the
// forward walk; with 64-channel blocks twice as many blocks are in flight as
// in the forward (24 per batch row at d_inner 1536).
#pragma once

#include "scan_walk.cuh"

namespace vmt {

constexpr int kBwdThreads = 64;  // channels per block (two warps)
constexpr int kBwdSub = 8;       // steps per rebuilt half-segment

struct ScanBwdArgs {
  const void* u;  // TU
  long long ld_u;
  const void* delta;  // TU, raw (before bias and softplus)
  long long ld_delta;
  const void* z;  // TZ, may be null
  long long ld_z;
  const void* B;  // TU
  long long ld_B;
  const void* C;  // TU
  long long ld_C;
  const void* g;  // TZ: cotangent of y
  long long ld_g;
  const float* A;           // (D, N)
  const float* Dskip;       // (D,), may be null
  const float* delta_bias;  // (D,), may be null
  const float* ckpt;        // (batch, ceil(L / 16), D, N)
  const float* g_hlast;     // (batch, D, N), may be null
  void* du;                 // TO, rows of ld_du
  long long ld_du;
  void* ddelta;  // TO
  long long ld_ddelta;
  void* dz;  // TZ, null when z is
  long long ld_dz;
  float* bc_part;  // (batch, ceil(D / 64), L, 2N): dB | dC per channel block
  float* dA_part;  // (batch, D, N)
  float* dD_part;  // (batch, D)
  float* dbias_part;  // (batch, D)
  float* dh0;      // (batch, D, N)
  float* y = nullptr;  // the split walk's kY: the forward's gated output, rows of ld_y
  long long ld_y = 0;
  int L;
  int D;
  int softplus;
};

// Butterfly reduce-scatter over a warp: on entry each lane holds V values;
// on exit lane l holds in v[0 .. max(V / 32, 1)) the warp sums of indices
// (l * V) / 32 + [0, max(V / 32, 1)) (for V < 32, lanes sharing an index
// hold the same sum).
template <int V, int C, int O>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[V], int lane) {
  if constexpr (O >= 1) {
    constexpr int kFinal = V >= 32 ? V / 32 : 1;
    if constexpr (C > kFinal) {
      constexpr int H = C / 2;
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      warp_reduce_scatter<V, H, O / 2>(v, lane);
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], O);
      warp_reduce_scatter<V, C, O / 2>(v, lane);
    }
  }
}

// Steps a rebuilt part of a segment holds: half a segment, a quarter at N = 128.
template <int N>
__host__ __device__ constexpr int bwd_sub() {
  return N > 64 ? kBwdSub / 2 : kBwdSub;
}

template <int N>
constexpr size_t scan_bwd_smem_bytes() {
  return sizeof(float) * ((size_t)bwd_sub<N>() * N * kBwdThreads  // rebuilt states
                          + 4 * kScanTile * kBwdThreads           // u, dt, z, g
                          + 2 * kScanTile * N                     // B, C
                          + 2 * bwd_sub<N>() * 2 * N);            // warp partials
}

template <int N, typename TU, typename TZ, typename TO>
__global__ void __launch_bounds__(kBwdThreads) scan_bwd_kernel(ScanBwdArgs a) {
  extern __shared__ float smem[];
  constexpr int kSub = bwd_sub<N>();
  float* sH = smem;                                  // [kSub][N][64]
  float* sU = sH + kSub * N * kBwdThreads;           // [16][64]
  float* sDt = sU + kScanTile * kBwdThreads;
  float* sZ = sDt + kScanTile * kBwdThreads;
  float* sG = sZ + kScanTile * kBwdThreads;
  float* sB = sG + kScanTile * kBwdThreads;          // [16][N]
  float* sC = sB + kScanTile * N;
  float* sRed = sC + kScanTile * N;                  // [2][kSub][2N]
  constexpr int V = 2 * N;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int d = blockIdx.x * kBwdThreads + tid;
  const bool active = d < a.D;
  const long long b = blockIdx.y;
  const long long L = a.L;
  const long long D = a.D;
  const bool has_z = a.z != nullptr;
  const long long nseg = (L + kScanTile - 1) / kScanTile;
  const long long ncb = gridDim.x;

  float A[N], s[N], dAacc[N], h[N];
  float dskip = 0.f, dbias = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = active ? a.A[d * N + n] : 0.f;
    s[n] = (active && a.g_hlast) ? a.g_hlast[(b * D + d) * N + n] : 0.f;
    dAacc[n] = 0.f;
  }
  if (active && a.Dskip) dskip = a.Dskip[d];
  if (active && a.delta_bias) dbias = a.delta_bias[d];
  float dDacc = 0.f, dbacc = 0.f;

  const TU* u_b = (const TU*)a.u + b * L * a.ld_u;
  const TU* dt_b = (const TU*)a.delta + b * L * a.ld_delta;
  const TZ* z_b = has_z ? (const TZ*)a.z + b * L * a.ld_z : nullptr;
  const TZ* g_b = (const TZ*)a.g + b * L * a.ld_g;
  const TU* B_b = (const TU*)a.B + b * L * a.ld_B;
  const TU* C_b = (const TU*)a.C + b * L * a.ld_C;
  TO* du_b = (TO*)a.du + b * L * a.ld_du;
  TO* dd_b = (TO*)a.ddelta + b * L * a.ld_ddelta;
  TZ* dz_b = has_z ? (TZ*)a.dz + b * L * a.ld_dz : nullptr;
  float* part_b = a.bc_part + (b * ncb + blockIdx.x) * L * V;

  for (long long seg = nseg - 1; seg >= 0; --seg) {
    const long long t0 = seg * kScanTile;
    const int steps = (int)min((long long)kScanTile, L - t0);
    __syncthreads();  // the previous segment's staging has been consumed
    for (int k = 0; k < steps; ++k) {
      const long long t = t0 + k;
      float dt = 0.f, uu = 0.f, zz = 0.f, gg = 0.f;
      if (active) {
        dt = load_f32(dt_b + t * a.ld_delta + d) + dbias;
        if (a.softplus) dt = softplus_f(dt);
        uu = load_f32(u_b + t * a.ld_u + d);
        if (has_z) zz = load_f32(z_b + t * a.ld_z + d);
        gg = load_f32(g_b + t * a.ld_g + d);
      }
      sDt[k * kBwdThreads + tid] = dt;
      sU[k * kBwdThreads + tid] = uu;
      sZ[k * kBwdThreads + tid] = zz;
      sG[k * kBwdThreads + tid] = gg;
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
      // Chain 1: from the segment checkpoint to the half's first step, then
      // through the half, keeping each pre-update state.
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
      // Chain 2: the cotangent, back through the half.
      for (int kk = m - 1; kk >= 0; --kk) {
        const int k = s0 + kk;
        const float dt = sDt[k * kBwdThreads + tid];
        const float uu = sU[k * kBwdThreads + tid];
        const float gg = sG[k * kBwdThreads + tid];
        float g2 = gg, zz = 0.f, sig = 0.f;
        if (has_z) {
          zz = sZ[k * kBwdThreads + tid];
          sig = 1.f / (1.f + expf(-zz));
          g2 = gg * (zz * sig);
        }
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
        if (a.softplus) ddr *= 1.f - expf(-dt);
        dbacc += ddr;
        dDacc += g2 * uu;
        if (active) {
          store_as(du_b + (t0 + k) * a.ld_du + d, dt * sBv + g2 * dskip);
          store_as(dd_b + (t0 + k) * a.ld_ddelta + d, ddr);
          if (has_z) {
            pre += uu * dskip;
            store_as(dz_b + (t0 + k) * a.ld_dz + d,
                     gg * pre * (sig * (1.f + zz * (1.f - sig))));
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
        part_b[(t0 + s0 + kk) * V + j] =
            sRed[kk * V + j] + sRed[(kSub + kk) * V + j];
      }
      __syncthreads();
    }
  }

  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a.dA_part[(b * D + d) * N + n] = dAacc[n];
      a.dh0[(b * D + d) * N + n] = s[n];
    }
    a.dD_part[b * D + d] = dDacc;
    a.dbias_part[b * D + d] = dbacc;
  }
}

// dB[b, t, n] and dC[b, t, n]: the channel-block partials summed in order.
template <typename T>
__global__ void reduce_bc_kernel(const float* __restrict__ part, int ncb,
                                 long long L, int N, T* dB, long long ld_dB,
                                 T* dC, long long ld_dC) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int V = 2 * N;
  if (i >= L * V) return;
  const long long b = blockIdx.y;
  const long long t = i / V;
  const int j = (int)(i - t * V);
  const float* p = part + b * ncb * L * V + i;
  float acc = 0.f;
  for (int c = 0; c < ncb; ++c) acc += p[(long long)c * L * V];
  if (j < N) {
    store_as(dB + (b * L + t) * ld_dB + j, acc);
  } else {
    store_as(dC + (b * L + t) * ld_dC + (j - N), acc);
  }
}

// dA (D, N), dD (D,), dbias (D,): the per-batch partials summed in order.
// static: each source that includes this has its own.
static __global__ void reduce_batch_kernel(const float* __restrict__ dA_part,
                                    const float* __restrict__ dD_part,
                                    const float* __restrict__ db_part,
                                    int batch, int D, int N, float* dA,
                                    float* dD, float* dbias) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long DN = (long long)D * N;
  if (i < DN) {
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc += dA_part[b * DN + i];
    dA[i] = acc;
  } else if (i < DN + D) {
    const long long dd = i - DN;
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc += dD_part[b * D + dd];
    if (dD) dD[dd] = acc;
  } else if (i < DN + 2 * D) {
    const long long dd = i - DN - D;
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc += db_part[b * D + dd];
    if (dbias) dbias[dd] = acc;
  }
}

template <int N, typename TU, typename TZ, typename TO>
cudaError_t launch_scan_bwd_n(const ScanBwdArgs& a, int batch, cudaStream_t s) {
  constexpr size_t smem = scan_bwd_smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(scan_bwd_kernel<N, TU, TZ, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.D + kBwdThreads - 1) / kBwdThreads, batch);
  scan_bwd_kernel<N, TU, TZ, TO><<<grid, kBwdThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The reverse walk and the dA / dD / dbias batch sum (dD, dbias may be
// null). dB and dC stay in a.bc_part for launch_reduce_bc.
template <typename TU, typename TZ, typename TO>
cudaError_t launch_scan_bwd(const ScanBwdArgs& a, int batch, int n, float* dA,
                            float* dD, float* dbias, cudaStream_t s) {
  cudaError_t err;
  switch (n) {
    case 8:
      err = launch_scan_bwd_n<8, TU, TZ, TO>(a, batch, s);
      break;
    case 16:
      err = launch_scan_bwd_n<16, TU, TZ, TO>(a, batch, s);
      break;
    case 32:
      err = launch_scan_bwd_n<32, TU, TZ, TO>(a, batch, s);
      break;
    case 64:
      err = launch_scan_bwd_n<64, TU, TZ, TO>(a, batch, s);
      break;
    case 128:
      err = launch_scan_bwd_n<128, TU, TZ, TO>(a, batch, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long long total = (long long)a.D * n + 2LL * a.D;
  reduce_batch_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      a.dA_part, a.dD_part, a.dbias_part, batch, a.D, n, dA, dD, dbias);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce_bc(const float* part, int batch, int D, int L, int n,
                             T* dB, long long ld_dB, T* dC, long long ld_dC,
                             cudaStream_t s) {
  const int ncb = (D + kBwdThreads - 1) / kBwdThreads;
  const long long per_batch = (long long)L * 2 * n;
  const dim3 grid((unsigned)((per_batch + 255) / 256), batch);
  reduce_bc_kernel<T><<<grid, 256, 0, s>>>(part, ncb, L, n, dB, ld_dB, dC, ld_dC);
  return cudaGetLastError();
}

}  // namespace vmt
