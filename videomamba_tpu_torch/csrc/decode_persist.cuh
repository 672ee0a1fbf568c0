// Building blocks of the persistent token-decode stacks (K9 and K15,
// decode_step.cu): a grid barrier, the copy of a block's weight slice into
// shared memory ahead of the barrier (cp.async), activation rows staged by
// bulk copy, and the block products over a batch tile (fp32 FMA register
// tiles, or bf16 mma.sync.m16n8k16 with weight rows as M and batch rows as
// N).
//
// One block runs on each SM for the whole token. A phase reads what the
// previous phase wrote on other SMs, so it starts after grid_sync and reads
// those activations through L2 (bulk copies, ld.global.cg), never from a
// stale L1 line.
// Every value has one writer and every sum a fixed order: repeats are
// bit-identical.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "add_norm.cuh"

namespace vmt {
namespace dec {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowPad = 16;    // bytes after each weight row in shared memory
constexpr int kActPad = 8;     // floats after each staged activation row
constexpr int kMmaRows = 32;   // weight rows per pass of the mma product
// Polls of a barrier before the kernel traps: about a second, far beyond any
// token, so a fault ends the launch with an error instead of hanging it.
constexpr long long kSpinLimit = 1LL << 22;

// The thread that arrives at and polls the grid barrier, in a warp that
// issues no asynchronous copy or prefetch, so its release fence waits for
// nothing in flight.
constexpr int kSyncThread = kThreads - 32;

// The grid barrier: one arrive counter that only grows (no launch resets
// it; each starts from the value the previous one left, grid_base). Each
// block adds one with
// release semantics and waits until the counter reaches its target with
// acquire semantics: writes made before the barrier by any block are
// visible after it. Once the whole block is done with the phase, the
// barrier's thread arrives and polls while the other warps run between():
// the next weight copies, so their cost hides under the barrier's latency.
template <typename F>
__device__ __forceinline__ void grid_sync(unsigned* counter, unsigned& target, F between) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x / 32 != kSyncThread / 32) {
    between();
  } else if (threadIdx.x == kSyncThread) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
    unsigned v;
    long long spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
      if (++spins > kSpinLimit) __trap();  // a fault, not a hang
    } while ((int)(v - target) < 0);
  }
  __syncthreads();
}

// The counter's value as the launch starts: the word after the counter,
// where the previous launch on the stream left it (grid_close). Launches on
// one stream run in order, so this holds under CUDA graph replay too, with
// no value from the host. Only the barrier's thread needs it; it reads it
// before its first arrive.
__device__ __forceinline__ unsigned grid_base(const unsigned* counter) {
  return threadIdx.x == kSyncThread ? __ldcg(counter + 1) : 0u;
}

// After the last grid barrier, block 0 leaves the counter's final value for
// the next launch: every block has arrived at that barrier, so every block
// has read the base already.
__device__ __forceinline__ void grid_close(unsigned* counter, unsigned target) {
  if (blockIdx.x == 0 && threadIdx.x == kSyncThread) counter[1] = target;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most one committed group (the next phase's) is in flight.
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy nrows rows of row_bytes each (source rows src_stride bytes apart;
// all three multiples of 16) into shared memory, rows dst_stride bytes
// apart, with cp.async from every warp but the barrier's. The caller
// commits the group.
__device__ __forceinline__ void copy_rows(void* dst_, const void* src_, int nrows, int row_bytes,
                                          long long src_stride, int dst_stride) {
  char* dst = (char*)dst_;
  const char* src = (const char*)src_;
  const int per_row = row_bytes / 16;
  const int total = nrows * per_row;
  if (threadIdx.x >= kSyncThread) return;
  for (int i = threadIdx.x; i < total; i += kSyncThread) {
    const int r = i / per_row, c = i - r * per_row;
    cp_async16(dst + (long long)r * dst_stride + c * 16, src + r * src_stride + c * 16);
  }
}

// Ask L2 for [p, p + bytes): small operands the next phase reads once.
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
  if (threadIdx.x >= kSyncThread) return;
  const char* c = (const char*)p;
  for (long long o = threadIdx.x * 128LL; o < bytes; o += kSyncThread * 128LL)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The block's transaction barrier for bulk copies, initialised once.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Wait for the current phase (parity) of a transaction barrier.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  long long spins = 0;
  do {
    if (++spins > kSpinLimit) __trap();  // a fault, not a hang
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Lane 0 of a warp: order the block's earlier accesses (and what the grid
// barrier acquired) before the bulk copies that follow, and announce their
// bytes on bar.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("fence.proxy.async;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Bulk (TMA) copies global -> shared of activations that other SMs wrote
// before the last grid barrier: warp 0 announces the bytes and issues the
// n copies that copy(i, dst, src, bytes) describes (16-byte aligned,
// multiples of 16 bytes); every thread waits for them on the block's
// transaction barrier. Call with the whole block, after a
// __syncthreads when dst was in use.
template <typename F>
__device__ __forceinline__ void bulk_load(uint64_t* bar, unsigned& parity, unsigned bytes,
                                          int n, F copy) {
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) mbar_expect(bar, bytes);
    __syncwarp();
    for (int i = threadIdx.x; i < n; i += 32) {
      float* dst;
      const float* src;
      unsigned size;
      copy(i, dst, src, size);
      bulk_copy(dst, src, size, bar);
    }
  }
  mbar_wait(bar, parity);
  parity ^= 1;
}

__device__ __forceinline__ float ld_state(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void st_state(void* p, long long i, float v, int bf) {
  if (bf) {
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// The balanced split of n units over the grid: block j takes [lo, hi).
__device__ __forceinline__ void block_span(int n, int& lo, int& hi) {
  lo = (int)((long long)n * blockIdx.x / gridDim.x);
  hi = (int)((long long)n * (blockIdx.x + 1) / gridDim.x);
}

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Stage a batch tile of activation rows into act (BT rows, lda floats
// apart; rows from nb on are zeros): v[b][k] = src[b][k0 + k] for k < K (a
// multiple of 4), rows b0 .. b0 + nb, src rows ld_src floats apart, by bulk
// copy. res_out, when given, gets v at columns [e_lo, e_hi) of rows ld_src
// apart. norm 1 (RMS) or 2 (LayerNorm) normalises each row over its first
// kn columns (the rest are zero lanes a padded width adds, which nw and nb_
// keep at zero) with weight nw (and shift nb_), one warp a row; then the
// values are rounded to TW, the weight dtype, as the product's input.
template <typename TW>
__device__ void stage_act(float* act, int lda, int BT, int b0, int nb, int K, const float* src,
                          long long ld_src, int k0, int norm, int kn, const float* nw,
                          const float* nb_,
                          float eps, float* stats, float* res_out, int e_lo, int e_hi,
                          uint64_t* bar, unsigned& parity) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the last users of act are done
  for (int i = threadIdx.x; i < (BT - nb) * K; i += kThreads)
    act[(long long)(nb + i / K) * lda + i % K] = 0.f;
  bulk_load(bar, parity, (unsigned)(nb * K * 4), nb,
            [&](int i, float*& d, const float*& s, unsigned& size) {
              d = act + (long long)i * lda;
              s = src + (long long)(b0 + i) * ld_src + k0;
              size = (unsigned)(K * 4);
            });
  if (res_out) {
    const int w = e_hi - e_lo;
    for (int i = threadIdx.x; i < nb * w; i += kThreads) {
      const int bb = i / w, e = e_lo + i % w;
      res_out[(long long)(b0 + bb) * ld_src + e] = act[(long long)bb * lda + e];
    }
  }
  if (norm) {
    const float inv_k = 1.f / (float)kn;
    for (int bb = warp; bb < nb; bb += kWarps) {
      const float* row = act + (long long)bb * lda;
      float s = 0.f;
      for (int k = lane; k < kn; k += 32) s += norm == 1 ? row[k] * row[k] : row[k];
      s = warp_sum(s);
      float mean = 0.f, var;
      if (norm == 1) {
        var = s * inv_k;
      } else {
        mean = s * inv_k;
        float s2 = 0.f;
        for (int k = lane; k < kn; k += 32) s2 += (row[k] - mean) * (row[k] - mean);
        var = warp_sum(s2) * inv_k;
      }
      if (lane == 0) {
        stats[2 * bb] = mean;
        stats[2 * bb + 1] = 1.f / sqrtf(var + eps);
      }
    }
    __syncthreads();
  }
  if (norm || sizeof(TW) == 2) {
    const int n4 = K / 4;
    for (int i = threadIdx.x; i < nb * n4; i += kThreads) {
      const int bb = i / n4, k = 4 * (i - bb * n4);
      float4* p = reinterpret_cast<float4*>(act + (long long)bb * lda + k);
      float4 v = *p;
      if (norm) {
        const float mean = stats[2 * bb], inv = stats[2 * bb + 1];
        v.x = (v.x - mean) * inv * nw[k];
        v.y = (v.y - mean) * inv * nw[k + 1];
        v.z = (v.z - mean) * inv * nw[k + 2];
        v.w = (v.w - mean) * inv * nw[k + 3];
        if (nb_) {
          v.x += nb_[k]; v.y += nb_[k + 1]; v.z += nb_[k + 2]; v.w += nb_[k + 3];
        }
      }
      v.x = rnd<TW>(v.x); v.y = rnd<TW>(v.y); v.z = rnd<TW>(v.z); v.w = rnd<TW>(v.w);
      *p = v;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void load4w(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4w(const bf16* p, float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = __bfloat162float(h[i]);
}

// res[r * BT + b] = sum_k act[b][k] w[r][k] for r < nrows, b < BT, k < K (a
// multiple of 4), on fp32 FMA. Warps: RB row blocks of RW rows x (8 / RB)
// splits of K. A lane sums its columns (4 adjacent, every 128th group) in
// order, the warp's lanes in a butterfly, then the K splits in order.
// red: 8 x RW x BT floats.
template <typename TW, int BT, int RW>
__device__ void gemv_fma(const TW* w, int ldw, int nrows, const float* act, int lda, int K,
                         int RB, float* red, float* res) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int WK = kWarps / RB, rb = warp % RB, wk = warp / RB;
  const int n4 = K / 4;
  const int lo = (int)((long long)n4 * wk / WK), hi = (int)((long long)n4 * (wk + 1) / WK);
  for (int r0 = 0; r0 < nrows; r0 += RB * RW) {
    const int rbase = r0 + rb * RW;
    float acc[RW][BT];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[r][b] = 0.f;
    for (int q = lo + lane; q < hi; q += 32) {
      float wv[RW][4];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int row = min(rbase + r, nrows - 1);
        load4w(w + (long long)row * ldw + 4 * q, wv[r]);
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float4 a = *reinterpret_cast<const float4*>(act + (long long)b * lda + 4 * q);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float s = acc[r][b];
          s = fmaf(a.x, wv[r][0], s);
          s = fmaf(a.y, wv[r][1], s);
          s = fmaf(a.z, wv[r][2], s);
          s = fmaf(a.w, wv[r][3], s);
          acc[r][b] = s;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float s = warp_sum(acc[r][b]);
        if (lane == 0) red[(warp * RW + r) * BT + b] = s;
      }
    __syncthreads();
    for (int i = threadIdx.x; i < RB * RW * BT; i += kThreads) {
      const int rr = i / BT, b = i - rr * BT;
      const int row = r0 + rr;
      if (row < nrows) {
        float s = 0.f;
        for (int k = 0; k < WK; ++k) s += red[((k * RB + rr / RW) * RW + rr % RW) * BT + b];
        res[row * BT + b] = s;
      }
    }
    __syncthreads();
  }
}

template <typename TW, int BT>
__device__ void gemv_fma_rw(const TW* w, int ldw, int nrows, const float* act, int lda, int K,
                            int RB, int RW, float* red, float* res) {
  switch (RW) {
    case 1: gemv_fma<TW, BT, 1>(w, ldw, nrows, act, lda, K, RB, red, res); break;
    case 2: gemv_fma<TW, BT, 2>(w, ldw, nrows, act, lda, K, RB, red, res); break;
    case 3: gemv_fma<TW, BT, 3>(w, ldw, nrows, act, lda, K, RB, red, res); break;
    default: gemv_fma<TW, BT, 4>(w, ldw, nrows, act, lda, K, RB, red, res); break;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The product of gemv_fma on the tensor cores, bf16 weights: weight rows
// are M (32 a pass, two m16 tiles), batch rows N (BT = 8 or 16), K (a
// multiple of 16) split over the 8 warps in order; each warp's fp32 sums go
// to red (8 x 32 x BT floats) and are added in warp order. The staged
// activations are bf16 values held as fp32, so packing them is exact.
template <int BT>
__device__ void gemv_mma(const bf16* w, int ldw, int nrows, const float* act, int lda, int K,
                         float* red, float* res) {
  constexpr int NT = BT / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n16 = K / 16;
  const int lo = n16 * warp / kWarps, hi = n16 * (warp + 1) / kWarps;
  for (int r0 = 0; r0 < nrows; r0 += kMmaRows) {
    float c[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[m][n][i] = 0.f;
    const bool two = r0 + 16 < nrows;
    for (int s = lo; s < hi; ++s) {
      const int k0 = s * 16 + 2 * t;
      uint32_t b[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* ar = act + (long long)(n * 8 + g) * lda + k0;
        const float2 v0 = *reinterpret_cast<const float2*>(ar);
        const float2 v1 = *reinterpret_cast<const float2*>(ar + 8);
        b[n][0] = pack_bf16(v0.x, v0.y);
        b[n][1] = pack_bf16(v1.x, v1.y);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !two) break;
        const int ra = min(r0 + m * 16 + g, nrows - 1), rb = min(r0 + m * 16 + g + 8, nrows - 1);
        const bf16* wa = w + (long long)ra * ldw + k0;
        const bf16* wb = w + (long long)rb * ldw + k0;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(wa);
        a[1] = *reinterpret_cast<const uint32_t*>(wb);
        a[2] = *reinterpret_cast<const uint32_t*>(wa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(wb + 8);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(c[m][n], a, b[n][0], b[n][1]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* o = red + ((long long)warp * kMmaRows + m * 16 + g) * BT + n * 8 + 2 * t;
        o[0] = c[m][n][0];
        o[1] = c[m][n][1];
        o[8 * BT] = c[m][n][2];
        o[8 * BT + 1] = c[m][n][3];
      }
    __syncthreads();
    for (int i = threadIdx.x; i < kMmaRows * BT; i += kThreads) {
      const int rr = i / BT, b = i - rr * BT;
      const int row = r0 + rr;
      if (row < nrows) {
        float s = 0.f;
        for (int k = 0; k < kWarps; ++k) s += red[((long long)k * kMmaRows + rr) * BT + b];
        res[row * BT + b] = s;
      }
    }
    __syncthreads();
  }
}

// One product of a phase: the mma form when the plan asks for it (bf16
// weights, BT >= 8, K a multiple of 16), else FMA tiles.
template <typename TW, int BT>
__device__ __forceinline__ void gemv(const TW* w, int ldw, int nrows, const float* act, int lda,
                                     int K, int RB, int RW, int mma, float* red, float* res) {
  if constexpr (sizeof(TW) == 2 && BT >= 8) {
    if (mma) {
      gemv_mma<BT>(w, ldw, nrows, act, lda, K, red, res);
      return;
    }
  }
  gemv_fma_rw<TW, BT>(w, ldw, nrows, act, lda, K, RB, RW, red, res);
}

}  // namespace dec
}  // namespace vmt
