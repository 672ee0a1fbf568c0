// Gradients of the selective scan: the math, the operands (ScanBwdArgs) and
// the reductions of the reverse walk, whose launches are the time-split
// reverse walk of scan_walk_split_bwd.cuh (K5 selective_scan_bwd.cu, K6
// mixer_bwd.cu, K7 block_bwd.cu).
//
// Math (videomamba_tpu/ops/pallas/scan.py:401-505), per (b, d), fp32, with
// dt = softplus(delta + bias) (or delta + bias without softplus),
// a_n = exp(dt A_n), g2 = g silu(z) (g without a gate):
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
// Layout. One thread owns one (b, d) and its N states; a block holds
// kBwdThreads = 64 channels (two warps). Checkpoints are one per kScanTile =
// 16 steps. A segment is staged in shared memory and walked back in two
// parts of bwd_sub<N>() = 8 steps (quarters of 4 at N = 128): each part
// rebuilds its pre-update states from the segment checkpoint and keeps them
// in shared memory (8 x N x 64 floats: 32 KB at N = 16), since 16 x N per
// thread does not fit in registers.
//
// Reductions without floating-point atomics, so repeated runs are
// bit-identical: dB and dC (2N values a step, summed over channels) are
// reduced over each warp's 32 lanes by a butterfly reduce-scatter (2N - 1
// shuffles for 2N = 32), the two warps are added in a fixed order in shared
// memory, and each channel block writes its own partial row; a second launch
// (reduce_bc_kernel) sums the partials over channel blocks in order. dA, dD
// and dbias are summed over time in each thread's registers and over the
// partial rows by reduce_batch_kernel.
#pragma once

#include "scan_walk.cuh"

namespace vmt {

constexpr int kBwdThreads = 64;  // channels per block (two warps)
constexpr int kBwdSub = 8;       // steps per rebuilt part of a segment

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
  float* dA_part;  // (batch, nchunks, D, N): a row per (b, chunk) of the split walk
  float* dD_part;  // (batch, nchunks, D)
  float* dbias_part;  // (batch, nchunks, D)
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

// dA (D, N), dD (D,), dbias (D,): the `batch` partial rows summed in order.
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
