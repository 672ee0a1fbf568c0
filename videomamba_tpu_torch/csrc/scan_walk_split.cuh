// Selective-scan forward walk for Hopper that splits the time axis across
// blocks: the walk of the selective-scan kernel (selective_scan.cu, K1), the
// fused mixer (mixer_fused.cu, K3) and the whole-block kernel
// (block_fused.cu, K4). The reverse walk is scan_walk_split_bwd.cuh (K5, K6,
// K7).
//
// The recurrence and the operands are scan_walk.cuh's (ScanArgs, same
// meaning): per (batch b, channel d, state n), in fp32,
//   dt     = softplus(delta[t, d] + delta_bias[d])    (softplus: kSoftplus)
//   h[n]   = exp(dt * A[d, n]) * h[n] + dt * u[t, d] * B[t, n]
//   y[t,d] = (sum_n C[t, n] * h[n] + Dskip[d] * u[t, d]) * silu(z[t, d])
// (the gate: kZ), with z rounded to bf16 first under round_z (K4's bf16
// path), h_last, and with ckpt the state at the start of every
// kScanTile-step segment, ckpt[b][t / kScanTile][d][n], the residual the
// reverse walks rebuild from. The mixers walk with both kZ and kSoftplus;
// K1's contract also takes no gate and a raw dt, and a null Dskip or
// delta_bias reads as zeros.
//
// Why split: the TPU kernels walk time in order inside VMEM because the
// TPU's grid runs in order. One block of 128 channels walking all L steps
// gives ceil(Di / 128) x batch blocks: 12 at VideoMamba-Base, batch 1, on a
// 132-SM card, one warp per scheduler, each step's dependent exp and FMA
// chain waiting out its full latency L times. Here time is cut into chunks
// of `chunk` steps (a multiple of kScanTile, chosen by the wrapper so each
// walking launch holds at least four blocks per SM) and the state is passed
// between chunks, as K12 (ssd_mixer.cu) does for SSD:
//   (a) chunk states: each (b, 128 channels, chunk c < nchunks - 1) walks its
//       chunk from a zero state and stores its end state e_c[d][n] and
//       S_c[d] = sum of the chunk's dt. The chunk's decay is
//       exp(A[d, n] * S_c[d]), one exp per chunk instead of a product
//       carried through every step: the same value up to rounding, and
//       N times less scratch (S_c has no state axis).
//   (b) pass: one thread per (b, d, n) walks the chunks in order,
//       h <- exp(A * S_c) * h + e_c from h0, and overwrites e_c with h, the
//       start state of chunk c + 1.
//   (c) output: each (b, 128 channels, chunk) walks its chunk again from its
//       start state (h0 for chunk 0) and writes y, the checkpoints (chunk
//       starts are segment starts) and, in the last chunk, h_last.
// Phases (a) and (c) are one walk's loop on a chunk: one thread a
// channel, its N states in registers, 16-step tiles staged in shared
// memory. What is per (t, d) and off the state chain (softplus of dt, the
// gate silu(z)) is computed while staging, and y's sum over n runs in four
// partial sums, so a step's chain is the N exps and FMAs. No atomics: every
// value is written by one thread, so two runs are bit-identical. Splitting
// reassociates the recurrence: a chunk start is exp(A S) h + e in place of
// the step-by-step product, within a few fp32 ulps.
//
// What bounds it on the H100 (Base, batch 1, L 1569, fp32): bytes, about
// 39 MB (u, delta, z read and y written once; B, C, the chunk states and
// the checkpoints are small), 0.0117 ms at 3.35 TB/s; phase (a) reads u and
// delta a second time, which L2 (50 MB) mostly holds. Then the exps: two
// walks of B L Di N = 38.6 M expf each on the MUFU units. The chunks put
// 600 blocks (50 chunks of 32 steps x 12 channel groups) on the card where
// a walk over all of time has 12. Measured (H100, PERF.md): the walk then
// waits on the latency of each step's chain more than on the exps (a faster
// __expf saved 8 %, unrolling two steps 16 %), so more warps or more steps
// in flight are what would move it next.
#pragma once

#include "scan_walk.cuh"

namespace vmt {

// Scratch of the split walk, allocated by the wrapper: states
// (batch, nchunks - 1, D, N) and dtsum (batch, nchunks - 1, D), fp32, where
// nchunks = ceil(L / chunk); unused (may be null) when nchunks is 1.
struct SplitArgs {
  float* states;
  float* dtsum;
  int chunk;  // steps per chunk, a multiple of kScanTile
};

// p is a state row of a tensor the wrapper allocated (16-byte aligned).
template <int N>
__device__ __forceinline__ void store_state(float* p, const float (&h)[N]) {
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    *reinterpret_cast<float4*>(p + n) = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  }
}

// Phase (a) (kOut false) or (c) (kOut true) on chunk blockIdx.y of batch row
// blockIdx.z, channels blockIdx.x * kScanThreads + [0, 128). Must be called
// by all kScanThreads threads of the block (it synchronises). kRoundZ,
// kCkpt, kZ (a z gate) and kSoftplus (dt through softplus) are template
// arguments: a runtime test in an older walk's staging loop slowed the fp32
// walk by 29% at VideoMamba-Base (H100).
template <int N, typename TU, typename TZ, typename TY, bool kRoundZ, bool kCkpt, bool kOut,
          bool kZ, bool kSoftplus>
__device__ __forceinline__ void split_walk(const ScanArgs& a, const SplitArgs& s) {
  static_assert(N % 4 == 0, "states move as float4");
  constexpr bool kGate = kOut && kZ;
  __shared__ float sDt[kScanTile][kScanThreads];
  __shared__ float sU[kScanTile][kScanThreads];
  __shared__ float sG[kGate ? kScanTile : 1][kScanThreads];
  __shared__ float sB[kScanTile][N];
  __shared__ float sC[kOut ? kScanTile : 1][N];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kScanThreads + tid;
  const bool active = d < a.D;
  const long long b = blockIdx.z;
  const long long c = blockIdx.y;
  const long long L = a.L;
  const long long nc1 = (L + s.chunk - 1) / s.chunk - 1;  // chunks with a stored state
  const long long t_begin = c * s.chunk;
  const long long t_end = min(L, t_begin + s.chunk);

  float h[N];
  float A[N];
  float dskip = 0.f;
  float dbias = 0.f;
  float dtsum = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = 0.f;
    A[n] = 0.f;
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) A[n] = a.A[(long long)d * N + n];
    if constexpr (kOut) {
      const float* h_start = c == 0 ? a.h0 + (b * a.D + d) * N
                                    : s.states + ((b * nc1 + c - 1) * a.D + d) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = h_start[n];
      if (a.Dskip) dskip = a.Dskip[d];
    }
    if (a.delta_bias) dbias = a.delta_bias[d];
  }

  const TU* u_b = (const TU*)a.u + b * L * a.ld_u;
  const TU* dt_b = (const TU*)a.delta + b * L * a.ld_delta;
  const TZ* z_b = kGate ? (const TZ*)a.z + b * L * a.ld_z : nullptr;
  const TU* B_b = (const TU*)a.B + b * L * a.ld_B;
  const TU* C_b = (const TU*)a.C + b * L * a.ld_C;
  TY* y_b = (TY*)a.y + b * L * a.ld_y;

  for (long long t0 = t_begin; t0 < t_end; t0 += kScanTile) {
    const int steps = (int)min((long long)kScanTile, t_end - t0);
    if constexpr (kCkpt) {
      if (active) {
        const long long nseg = (L + kScanTile - 1) / kScanTile;
        store_state(a.ckpt + ((b * nseg + t0 / kScanTile) * a.D + d) * N, h);
      }
    }
    __syncthreads();  // the previous tile has been consumed
    if (active) {
      // Raw loads first, all of a tile's in flight together, then the
      // per-(t, d) arithmetic on this thread's own column.
#pragma unroll
      for (int k = 0; k < kScanTile; ++k) {
        if (k < steps) {
          const long long t = t0 + k;
          sDt[k][tid] = load_f32(dt_b + t * a.ld_delta + d);
          sU[k][tid] = load_f32(u_b + t * a.ld_u + d);
          if constexpr (kGate) sG[k][tid] = load_f32(z_b + t * a.ld_z + d);
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
          if constexpr (kGate) {
            float zz = sG[k][tid];
            if constexpr (kRoundZ) zz = __bfloat162float(__float2bfloat16_rn(zz));
            sG[k][tid] = zz * (1.f / (1.f + expf(-zz)));
          }
        }
      }
    }
    for (int i = tid; i < steps * N; i += kScanThreads) {
      const int k = i / N;
      const int n = i - k * N;
      sB[k][n] = load_f32(B_b + (t0 + k) * a.ld_B + n);
      if constexpr (kOut) sC[k][n] = load_f32(C_b + (t0 + k) * a.ld_C + n);
    }
    __syncthreads();
    if (!active) continue;

    // Two steps an iteration: the second step's exps do not wait on the
    // first step's state, so they overlap its chain.
#pragma unroll 2
    for (int k = 0; k < steps; ++k) {
      const float dt = sDt[k][tid];
      const float uu = sU[k][tid];
      const float du = dt * uu;
      if constexpr (kOut) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(dt * A[n]) * h[n] + du * sB[k][n];
          acc[n & 3] += sC[k][n] * h[n];
        }
        float yv = (acc[0] + acc[1]) + (acc[2] + acc[3]) + uu * dskip;
        if constexpr (kZ) yv *= sG[k][tid];
        store_as(y_b + (t0 + k) * a.ld_y + d, yv);
      } else {
        dtsum += dt;
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = expf(dt * A[n]) * h[n] + du * sB[k][n];
      }
    }
  }

  if (!active) return;
  if constexpr (kOut) {
    if (c == nc1) store_state(a.h_last + (b * a.D + d) * N, h);
  } else {
    store_state(s.states + ((b * nc1 + c) * a.D + d) * N, h);
    s.dtsum[(b * nc1 + c) * a.D + d] = dtsum;
  }
}

template <int N, typename TU, bool kSoftplus>
__global__ void __launch_bounds__(kScanThreads)
    split_chunk_states_kernel(ScanArgs a, SplitArgs s) {
  split_walk<N, TU, float, float, false, false, false, false, kSoftplus>(a, s);
}

template <int N, typename TU, typename TZ, typename TY, bool kRoundZ, bool kCkpt, bool kZ,
          bool kSoftplus>
__global__ void __launch_bounds__(kScanThreads) split_output_kernel(ScanArgs a, SplitArgs s) {
  split_walk<N, TU, TZ, TY, kRoundZ, kCkpt, true, kZ, kSoftplus>(a, s);
}

constexpr int kPassThreads = 256;
constexpr int kPassBatch = 8;  // chunks whose loads a thread issues together

// Phase (b): thread (b, d, n) turns h0 and the chunk end states into chunk
// starts, in place. The loads of kPassBatch chunks go out before their
// FMAs, so the chain waits on L2 once a batch, not once a chunk.
static __global__ void __launch_bounds__(kPassThreads)
    split_pass_kernel(const float* __restrict__ A, const float* __restrict__ h0,
                      float* states, const float* __restrict__ dtsum, int D, int N,
                      int nc1, long long total) {
  const long long i = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= total) return;
  const long long bd = i / N;
  const long long b = bd / D;
  const long long d = bd - b * D;
  const float a = A[d * N + (i - bd * N)];
  float h = h0[i];
  for (int c0 = 0; c0 < nc1; c0 += kPassBatch) {
    float e[kPassBatch];
    float sum[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      if (c0 + j < nc1) {
        const long long row = b * nc1 + c0 + j;
        e[j] = states[row * D * N + (i - b * D * N)];
        sum[j] = dtsum[row * D + d];
      }
    }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      if (c0 + j < nc1) {
        h = expf(a * sum[j]) * h + e[j];
        states[(b * nc1 + c0 + j) * D * N + (i - b * D * N)] = h;
      }
    }
  }
}

template <int N, typename TU, typename TZ, typename TY, bool kRoundZOk, bool kZ,
          bool kSoftplus>
cudaError_t launch_split_n(const ScanArgs& a, const SplitArgs& s, int batch,
                           cudaStream_t stream) {
  const int nchunks = (a.L + s.chunk - 1) / s.chunk;
  const unsigned groups = (a.D + kScanThreads - 1) / kScanThreads;
  cudaError_t err;
  if (nchunks > 1) {
    split_chunk_states_kernel<N, TU, kSoftplus>
        <<<dim3(groups, nchunks - 1, batch), kScanThreads, 0, stream>>>(a, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long total = (long long)batch * a.D * N;
    split_pass_kernel<<<(unsigned)((total + kPassThreads - 1) / kPassThreads), kPassThreads, 0,
                        stream>>>(a.A, a.h0, s.states, s.dtsum, a.D, N, nchunks - 1, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(groups, nchunks, batch);
  if constexpr (kRoundZOk) {
    if (a.round_z) {
      if (a.ckpt) {
        split_output_kernel<N, TU, TZ, TY, true, true, kZ, kSoftplus>
            <<<grid, kScanThreads, 0, stream>>>(a, s);
      } else {
        split_output_kernel<N, TU, TZ, TY, true, false, kZ, kSoftplus>
            <<<grid, kScanThreads, 0, stream>>>(a, s);
      }
      return cudaGetLastError();
    }
  }
  if (a.ckpt) {
    split_output_kernel<N, TU, TZ, TY, false, true, kZ, kSoftplus>
        <<<grid, kScanThreads, 0, stream>>>(a, s);
  } else {
    split_output_kernel<N, TU, TZ, TY, false, false, kZ, kSoftplus>
        <<<grid, kScanThreads, 0, stream>>>(a, s);
  }
  return cudaGetLastError();
}

// Launches phases (a), (b) and (c) (only (c) when L fits one chunk) for the
// state sizes the library is built for (N in {8, 16, 32, 64, 128}; the
// wrappers pad other sizes with zero lanes). kZ and kSoftplus must match
// a.z and a.softplus (the mixers walk with both, K1 with any of the four);
// round_z (K4's bf16 gate) only where kRoundZOk.
template <typename TU, typename TZ, typename TY, bool kRoundZOk = false, bool kZ = true,
          bool kSoftplus = true>
cudaError_t launch_scan_walk_split(const ScanArgs& a, const SplitArgs& s, int batch, int n,
                                   cudaStream_t stream) {
  if ((a.round_z && (!kRoundZOk || !kZ)) || (a.softplus != 0) != kSoftplus ||
      (a.z != nullptr) != kZ || a.L < 1 || s.chunk < kScanTile ||
      s.chunk % kScanTile != 0 || (a.L > s.chunk && (!s.states || !s.dtsum)) ||
      (a.L + s.chunk - 1) / s.chunk > 65535 || batch > 65535) {
    return cudaErrorInvalidValue;
  }
  switch (n) {
    case 8:
      return launch_split_n<8, TU, TZ, TY, kRoundZOk, kZ, kSoftplus>(a, s, batch, stream);
    case 16:
      return launch_split_n<16, TU, TZ, TY, kRoundZOk, kZ, kSoftplus>(a, s, batch, stream);
    case 32:
      return launch_split_n<32, TU, TZ, TY, kRoundZOk, kZ, kSoftplus>(a, s, batch, stream);
    case 64:
      return launch_split_n<64, TU, TZ, TY, kRoundZOk, kZ, kSoftplus>(a, s, batch, stream);
    case 128:
      return launch_split_n<128, TU, TZ, TY, kRoundZOk, kZ, kSoftplus>(a, s, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K1's walk (selective_scan.cu) at operand type T (u, delta, z, B, C and y)
// for each gate and softplus choice. selective_scan.cu instantiates it for
// fp32 and selective_scan_bf16.cu for bf16, so the two compile in parallel.
template <typename T>
cudaError_t selective_scan_walk(const ScanArgs& a, const SplitArgs& s, int batch, int n,
                                cudaStream_t stream) {
  if (a.z) {
    return a.softplus ? launch_scan_walk_split<T, T, T, false, true, true>(a, s, batch, n, stream)
                      : launch_scan_walk_split<T, T, T, false, true, false>(a, s, batch, n,
                                                                             stream);
  }
  return a.softplus ? launch_scan_walk_split<T, T, T, false, false, true>(a, s, batch, n, stream)
                    : launch_scan_walk_split<T, T, T, false, false, false>(a, s, batch, n,
                                                                            stream);
}

}  // namespace vmt
