// Matrix products on Hopper's tensor cores fed by TMA: the five projection
// products of K14's backward (ssd_pmixer_bwd.cu), which the TPU kernel runs
// in its body (videomamba_tpu/ops/pallas/ssd_block.py:655, 692, 696, 855,
// 859). Three layouts, named by how A and B are stored:
//
//   kNT: C = A B^T, A (M, K) and B (N, K), both contraction-contiguous
//        (K-major): zx = hidden Win^T. C is written in the operands' dtype.
//   kNN: C = A B, A (M, K) K-major, B (K, N) with N contiguous (MN-major):
//        dgated = dout Wout, dhidden = dzx Win. C fp32.
//   kTN: C = A^T B, A (K, M) and B (K, N), both MN-major: a weight gradient,
//        the contraction over the B L rows (dWout, dWin). C fp32.
//
// Every product sums in fp32. bf16 operands go to wgmma as they are (its
// descriptors take MN-major 16-bit tiles through the transpose bits), so a
// product of two bf16 values is exact and only the order of the fp32 sums
// differs from an FMA tile's. fp32 operands run as three TF32 products:
// each value a = hi + lo with hi = tf32(a) and lo = tf32(a - hi)
// (cvt.rna.tf32.f32), and the tile sums hi hi' + hi lo' + lo hi' in fp32.
// The dropped lo lo' term and lo's own rounding are about 2^-22 of a product,
// the order of fp32's rounding, where one TF32 product keeps about 2^-11
// (tests/test_torch_tf32_split.py holds both against the 2e-5 bar at K14's
// contraction lengths). The tensor cores' fp32 sums truncate, so each
// k-tile's TF32 products start from zero and are added into registers in
// fp32 after it. wgmma takes TF32 tiles K-major only, so the fp32 path
// stages each raw tile and splits it itself: A's values into registers, in
// wgmma's register layout for A, and B's into K-major hi and lo tiles in
// shared memory. The transpose that NN's B and both TN operands need
// happens in that pass, where every value is read once.
//
// Design. One block computes a 128 x 128 tile of C: a producer warpgroup
// and two consumer warpgroups, each taking 64 rows with wgmma m64n128 (64
// fp32 sums a thread in registers). A k-tile is 128 bytes deep (64 bf16 or
// 32 fp32 values), so each operand's tile is 128 shared-memory rows of 128
// bytes (16 KB) in TMA's 128-byte swizzle: one box {64 or 32, 128} K-major
// or two (bf16) or four (fp32) square boxes MN-major. The tiles go through a
// ring of 4 stages filled by one TMA thread and released by the consumers
// on mbarriers (128 KB). bf16 keeps one k-tile of wgmma in flight. fp32
// adds two buffers of B's hi and lo tiles (64 KB), so B's split of k-tile
// t overlaps the products of t - 1; its consumers hold 64 sums, 64 partial
// sums and A's 32 split values in flight, so the producer hands them its
// registers (setmaxnreg: 232 a consumer thread, 40 a producer thread).
// 128 x 128 gives 325 blocks to zx at VideoMamba-Base-m2 (B L = 1569).
// Shared memory bounds the fp32 path: each k-tile moves about 190 KB
// through it (TMA's writes, B's split, wgmma's reads of B three times).
//
// Edges. TMA fills rows and columns past the ends with zeros and the
// epilogue masks its stores, so ragged B L, widths and K take the same tiles.
// An operand whose address or row stride is not a multiple of 16 bytes (a
// Di = H P that is no multiple of 8 at bf16, or an E no multiple of 4)
// cannot be described to TMA: such a product runs the staging variant
// (kTma = false), whose producer warpgroup loads the same tiles element by
// element into the same shared-memory layout.
//
// The weight gradients (kTN) contract over B L rows onto few output tiles
// (72 for dWout at Base-m2), so they split the contraction into up to
// kMaxSplits slices when a model of the waves and of the extra bytes says
// it pays; the slices' fp32 tiles are summed in slice order by a second
// launch. No floating-point atomics: repeated calls are bit-identical.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "add_norm.cuh"

namespace vmt {
namespace hg {

enum Layout : int { kNT = 0, kNN = 1, kTN = 2 };

constexpr int kTileM = 128, kTileN = 128;  // a block's tile of C
constexpr int kRowBytes = 128;             // a shared-memory row: the swizzle span
constexpr int kTileBytes = 128 * kRowBytes;
constexpr int kConsumers = 256;            // two warpgroups, 64 rows of C each
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kMaxSplits = 4;               // contraction slices of a kTN product

template <typename T>
struct Ring {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kDepth = kRowBytes / (int)sizeof(T);  // k values a k-tile
  static constexpr int kStages = 4;
  static constexpr int kSplitBufs = kBf16 ? 0 : 2;  // fp32: B's hi and lo tiles
  static constexpr int kSmem =
      (2 * kStages + 2 * kSplitBufs) * kTileBytes + 16 * kStages + 1024;  // + alignment
};

struct Operand {
  const void* ptr;
  long long ld;      // elements between stored rows
  int inner, outer;  // stored extents: the contiguous one, then the other
};

struct Args {
  Operand a, b;
  void* c;        // (M, N), rows of ldc: the operands' dtype (kNT) or fp32
  long long ldc;
  float* part;    // gridDim.z > 1: gridDim.z slices of (M, N) fp32
  int M, N, K;
  int ktiles, per_split;
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Wait for the phase of parity `parity` to complete; trap (a fault, not a
// hang) if it has not within about two seconds.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: the box of `map` at (inner, outer) coordinates (c0, c1) into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define VMT_HG_D8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VMT_HG_D64                                                                        \
  VMT_HG_D8(0), VMT_HG_D8(8), VMT_HG_D8(16), VMT_HG_D8(24), VMT_HG_D8(32), VMT_HG_D8(40), \
      VMT_HG_D8(48), VMT_HG_D8(56)
#define VMT_HG_REGS                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "    \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "     \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, this warpgroup's) += A (64 x 16) B (16 x 128), bf16; kTA /
// kTB: the operand is MN-major.
template <int kTA, int kTB>
__device__ __forceinline__ void mma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VMT_HG_REGS
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : VMT_HG_D64
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB)
      : "memory");
}

// d = A (64 x 8) B (8 x 128) + (accumulate ? d : 0), TF32, A from registers
// (a: this thread's four values of its warp's 16 x 8 slice), B K-major.
__device__ __forceinline__ void mma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " VMT_HG_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : VMT_HG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

#undef VMT_HG_REGS
#undef VMT_HG_D64
#undef VMT_HG_D8

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from reading the sums before the wgmma that writes them
// has completed.
__device__ __forceinline__ void fence_sums(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keep A's registers, which a wgmma in flight reads, from being reused
// before it completes.
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][2][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(a[i / 8][(i / 4) % 2][i % 4])::"memory");
}

// Byte offset of (row, byte) in a tile of 128-byte rows as TMA's 128-byte
// swizzle lays it out: the 16-byte chunk index XOR row % 8.
__device__ __forceinline__ int tile_off(int row, int byte) {
  return row * kRowBytes + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// The stored coordinates (inner, outer) of element e of row `row` of an
// operand's k-tile at (mn0, k0). K-major: rows are m (or n), e runs over k.
// MN-major: 128 / kDepth blocks of kDepth k-rows, e runs over m (or n).
template <int kDepth, bool kMN>
__device__ __forceinline__ void tile_coords(int row, int e, int mn0, int k0, int& ci, int& co) {
  if constexpr (kMN) {
    ci = mn0 + (row / kDepth) * kDepth + e;
    co = k0 + row % kDepth;
  } else {
    ci = k0 + e;
    co = mn0 + row;
  }
}

// TMA loads of one operand's k-tile (the map's box: {kDepth, 128} K-major,
// {kDepth, kDepth} MN-major).
template <int kDepth, bool kMN>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                          int mn0, int k0) {
  if constexpr (kMN) {
#pragma unroll
    for (int j = 0; j < 128 / kDepth; ++j)
      tma_load(dst + j * kDepth * kRowBytes, map, bar, mn0 + j * kDepth, k0);
  } else {
    tma_load(dst, map, bar, k0, mn0);
  }
}

// The staging variant's load of the same k-tile, by the 128 producer
// threads, element by element (any address and row stride).
template <typename T, bool kMN>
__device__ __forceinline__ void stage_tile(const Operand& op, uint8_t* dst, int mn0, int k0,
                                           int pt) {
  constexpr int kDepth = Ring<T>::kDepth;
  const T* src = (const T*)op.ptr;
  for (int i = pt; i < 128 * kDepth; i += 128) {
    const int row = i / kDepth, e = i % kDepth;
    int ci, co;
    tile_coords<kDepth, kMN>(row, e, mn0, k0, ci, co);
    const T v = (ci < op.inner && co < op.outer) ? src[(long long)co * op.ld + ci]
                                                 : from_f32<T>(0.f);
    *(T*)(dst + tile_off(row, e * (int)sizeof(T))) = v;
  }
}

__device__ __forceinline__ float tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// Element (r, k) of a raw fp32 k-tile: r its row of C's tile (m or n), k
// in [0, 32). K-major tiles keep r's 32 k values in row r; MN-major tiles
// keep 4 blocks of 32 k-rows of 32 values of r.
template <bool kMN>
__device__ __forceinline__ float raw_at(const uint8_t* raw, int r, int k) {
  if constexpr (kMN) return *(const float*)(raw + tile_off((r >> 5) * 32 + k, (r & 31) * 4));
  return *(const float*)(raw + tile_off(r, k * 4));
}

// Split B's raw fp32 k-tile (128 rows of n by 32 k) into its hi and lo TF32
// tiles, K-major, for wgmma. 256 consumer threads, four 16-byte chunks
// each; the shared-memory reads and writes are free of bank conflicts.
template <bool kMN>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* hi, uint8_t* lo,
                                           int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int q = it * kConsumers + tid;
    // row (n) and 16-byte chunk (4 k values): a warp's lanes take 32 rows
    // (MN-major) or 4 rows of 8 chunks (K-major)
    const int r = kMN ? q & 127 : q >> 3, c = kMN ? q >> 7 : q & 7;
    float v[4];
    if constexpr (kMN) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = raw_at<true>(raw, r, 4 * c + j);
    } else {
      const float4 w = *(const float4*)(raw + tile_off(r, c * 16));
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    }
    float h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = tf32(v[j]);
      l[j] = tf32(v[j] - h[j]);
    }
    const int off = tile_off(r, c * 16);
    *(float4*)(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
    *(float4*)(lo + off) = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// This thread's A values of a raw fp32 k-tile, split: a[kk][0] hi, a[kk][1]
// lo, for the k8 step kk, in wgmma's register layout for TF32 A (its warp's
// 16 rows; lane / 4 and lane / 4 + 8, columns lane % 4 and lane % 4 + 4).
template <bool kMN>
__device__ __forceinline__ void split_frags(const uint8_t* raw, int row0, uint32_t (&a)[4][2][4]) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + lane / 4, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = raw_at<kMN>(raw, r + 8 * (j & 1), 8 * kk + t + 4 * (j >> 1));
      const float h = tf32(v);
      a[kk][0][j] = __float_as_uint(h);
      a[kk][1][j] = __float_as_uint(tf32(v - h));
    }
  }
}

// The consumer warps release a ring stage: one arrival a warp.
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(bar);
}

template <typename TO>
__device__ __forceinline__ void store_pair(TO* c, long long ldc, int M, int N, int row, int col,
                                          float v0, float v1, bool vec) {
  if (row >= M || col >= N) return;
  TO* p = c + (long long)row * ldc + col;
  if (vec && col + 1 < N) {
    if constexpr (sizeof(TO) == 2) {
      *(__nv_bfloat162*)p = __floats2bfloat162_rn(v0, v1);
    } else {
      *(float2*)p = make_float2(v0, v1);
    }
    return;
  }
  p[0] = from_f32<TO>(v0);
  if (col + 1 < N) p[1] = from_f32<TO>(v1);
}

// This warpgroup's 64 x 128 sums: wgmma's accumulator layout, d[4 j + q] at
// row 16 warp + lane / 4 + 8 (q / 2), column 8 j + 2 (lane % 4) + q % 2.
template <typename TO>
__device__ __forceinline__ void store_tile(const float (&d)[64], TO* c, long long ldc, int M,
                                           int N, int row0, int col0) {
  const bool vec = ldc % 2 == 0 && (uintptr_t)c % (2 * sizeof(TO)) == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_pair(c, ldc, M, N, row0 + 8 * h, col0 + 8 * j, d[4 * j + 2 * h],
                 d[4 * j + 2 * h + 1], vec);
  }
}

template <typename T, int kLayout, bool kTma, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    product_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const Args args) {
  using R = Ring<T>;
  constexpr int kDepth = R::kDepth, kStages = R::kStages;
  constexpr bool kAMN = kLayout == kTN, kBMN = kLayout != kNT;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw0 = saddr(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw0);
  // Stage s: A's tile at s 2 kTileBytes, B's after it; fp32: B's split
  // buffers; then the full and empty barriers of each stage.
  const uint32_t split0 = base + 2 * kStages * kTileBytes;
  const uint32_t bars = split0 + 2 * R::kSplitBufs * kTileBytes;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int kt0 = blockIdx.z * args.per_split;
  const int nkt = min(args.ktiles - kt0, args.per_split);  // >= 1 (the host's split)

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), kTma ? 1 : 128);
      bar_init(empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: fill the ring
    // fp32: hand registers to the consumers (168 a thread at launch; 40
    // here, 232 there)
    if constexpr (!R::kBf16) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int pt = threadIdx.x - kConsumers;
    if (!kTma || pt == 0) {
      for (int t = 0; t < nkt; ++t) {
        const int s = t % kStages;
        bar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        const int k0 = (kt0 + t) * kDepth;
        const uint32_t sa = base + 2 * s * kTileBytes, sb = sa + kTileBytes;
        if constexpr (kTma) {
          bar_expect(full(s), 2 * kTileBytes);
          load_tile<kDepth, kAMN>(&map_a, sa, full(s), m0, k0);
          load_tile<kDepth, kBMN>(&map_b, sb, full(s), n0, k0);
        } else {
          stage_tile<T, kAMN>(args.a, gbase + (sa - base), m0, k0, pt);
          stage_tile<T, kBMN>(args.b, gbase + (sb - base), n0, k0, pt);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          bar_arrive(full(s));
        }
      }
    }
  } else {  // the consumers
    if constexpr (!R::kBf16) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = threadIdx.x / 128;  // rows [64 wg, 64 wg + 64) of the tile
    const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
    // bf16: the wgmma sums d run over all of K. fp32: d holds one k-tile's
    // products and is added into acc in fp32 after each k-tile, since the
    // tensor cores' own fp32 sums truncate (over K = 3200 they drift by 2e-5
    // of the largest element on the card, the fp32 bar).
    float d[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = acc[i] = 0.f;
    uint32_t a[4][2][4];  // fp32: A's split values of a k-tile, in flight
    for (int t = 0; t < nkt; ++t) {
      const int s = t % kStages;
      bar_wait(full(s), (t / kStages) & 1);
      const uint32_t sa = base + 2 * s * kTileBytes, sb = sa + kTileBytes;
      if constexpr (R::kBf16) {
        // A's 64 rows: K-major, rows 64 wg on; MN-major, the 64-wide block
        // wg. A k16 step: 32 bytes along a K-major row, 16 rows of an
        // MN-major tile.
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) {
          const uint32_t pa = sa + wg * 64 * kRowBytes + (kAMN ? kk * 16 * kRowBytes : kk * 32);
          const uint32_t pb = sb + (kBMN ? kk * 16 * kRowBytes : kk * 32);
          mma_bf16<kAMN, kBMN>(d, desc(pa, kAMN ? 64 * kRowBytes : 16, 8 * kRowBytes),
                               desc(pb, kBMN ? 64 * kRowBytes : 16, 8 * kRowBytes));
        }
        wg_commit();
        wg_wait<1>();  // k-tile t - 1's products are done: release its stage
        if (t > 0) release(empty((t - 1) % kStages));
      } else {
        // B's split of k-tile t (while t - 1's products run), then A's into
        // registers once t - 1's have released theirs.
        const uint32_t sp = split0 + (t & 1) * 2 * kTileBytes;  // B hi, B lo
        split_tile<kBMN>(gbase + (sb - base), gbase + (sp - base),
                         gbase + (sp - base) + kTileBytes, threadIdx.x);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        wg_wait<0>();  // this warpgroup's products of k-tile t - 1
        fence_sums(d);
        fence_frags(a);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
        split_frags<kAMN>(gbase + (sa - base), wg * 64 + warp * 16, a);
        release(empty(s));
        // Both warpgroups: B's split of t is written and t - 1's products,
        // which read the other buffer, are done (the next split may reuse it).
        asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 8; ++kk) {
          const uint64_t bhi = desc(sp + kk * 32, 16, 8 * kRowBytes);
          const uint64_t blo = desc(sp + kTileBytes + kk * 32, 16, 8 * kRowBytes);
          mma_tf32(d, a[kk][0], bhi, kk > 0);
          mma_tf32(d, a[kk][0], blo, 1);
          mma_tf32(d, a[kk][1], bhi, 1);
        }
        wg_commit();
      }
    }
    wg_wait<0>();
    fence_sums(d);
    if constexpr (!R::kBf16) {
      fence_frags(a);
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] += acc[i];
    }

    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4, col0 = n0 + 2 * (lane & 3);
    if (gridDim.z > 1) {
      store_tile(d, args.part + (long long)blockIdx.z * args.M * args.N, args.N, args.M,
                 args.N, row0, col0);
    } else {
      store_tile(d, (TO*)args.c, args.ldc, args.M, args.N, row0, col0);
    }
  }
}

// c[m, n] = sum over s of part[s][m, n], in slice order.
template <typename TO>
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, int M, int N,
                                  TO* __restrict__ c, long long ldc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long count = (long long)M * N;
  if (i >= count) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[s * count + i];
  c[(i / N) * ldc + i % N] = from_f32<TO>(acc);
}

// ----------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

template <typename T>
inline bool tma_describes(const Operand& op) {
  return (uintptr_t)op.ptr % 16 == 0 && (op.ld * (long long)sizeof(T)) % 16 == 0;
}

template <typename T>
inline cudaError_t make_map(CUtensorMap* map, const Operand& op, bool mn_major) {
  constexpr int kDepth = Ring<T>::kDepth;
  const cuuint64_t dims[2] = {(cuuint64_t)op.inner, (cuuint64_t)op.outer};
  const cuuint64_t strides[1] = {(cuuint64_t)op.ld * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)kDepth, (cuuint32_t)(mn_major ? kDepth : 128)};
  const cuuint32_t unit[2] = {1, 1};
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const CUresult res = encode(
      map, Ring<T>::kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(op.ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Contraction slices of a product: 1 but for kTN, whose slice count (at most
// kMaxSplits, each slice at least one k-tile) has the least modelled time:
// waves of blocks at one an SM times each block's k-tiles, plus the bytes of
// the ordered sum. The model's rates are round figures for the card; the
// choice depends on the shape and the SM count only, so repeats match.
inline int splits_for(int layout, bool bf16, int M, int N, int K, int sms) {
  if (layout != kTN) return 1;
  const int depth = bf16 ? 64 : 32;
  const long long tiles =
      (long long)((M + kTileM - 1) / kTileM) * ((N + kTileN - 1) / kTileN);
  const int ktiles = (K + depth - 1) / depth;
  const double ktile_s = bf16 ? 0.4e-6 : 1.2e-6;  // one block's k-tile
  const double sum_s_per_byte = 1.0 / 2.5e12;
  int best = 1;
  double best_s = 1e30;
  for (int s = 1; s <= kMaxSplits && s <= ktiles; ++s) {
    const int per = (ktiles + s - 1) / s;
    if ((s - 1) * per >= ktiles) break;
    const double waves = (double)((tiles * s + sms - 1) / sms);
    const double t = waves * per * ktile_s + (s > 1 ? (s + 1) * 4.0 * M * N * sum_s_per_byte : 0);
    if (t < best_s) {
      best_s = t;
      best = s;
    }
  }
  return best;
}

template <typename T, int kLayout, typename TO>
inline cudaError_t launch(const Args& args, dim3 grid, bool tma, cudaStream_t st) {
  CUtensorMap ma{}, mb{};
  cudaError_t err;
  if (tma) {
    if ((err = make_map<T>(&ma, args.a, kLayout == kTN)) != cudaSuccess) return err;
    if ((err = make_map<T>(&mb, args.b, kLayout != kNT)) != cudaSuccess) return err;
  }
  const auto kernel = tma ? product_kernel<T, kLayout, true, TO> : product_kernel<T, kLayout, false, TO>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Ring<T>::kSmem)) != cudaSuccess)
    return err;
  kernel<<<grid, kThreads, Ring<T>::kSmem, st>>>(ma, mb, args);
  return cudaGetLastError();
}

// C (M, N) with rows of ldc for `layout` (see the top of this file); A and B
// stored with rows of lda and ldb, the operands' dtype T; C in T for kNT,
// else fp32. part: kMaxSplits M N floats of scratch for kTN, null otherwise.
template <typename T>
cudaError_t product(int layout, const T* A, long long lda, const T* B, long long ldb, void* C,
                    long long ldc, int M, int N, int K, float* part, cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (layout == kTN && !part) return cudaErrorInvalidValue;
  Operand a{A, lda, layout == kTN ? M : K, layout == kTN ? K : M};
  Operand b{B, ldb, layout == kNT ? K : N, layout == kNT ? N : K};
  int dev = 0, sms = 132;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int ktiles = (K + Ring<T>::kDepth - 1) / Ring<T>::kDepth;
  const int splits = splits_for(layout, Ring<T>::kBf16, M, N, K, sms);
  const int per = (ktiles + splits - 1) / splits;
  const Args args{a, b, C, ldc, part, M, N, K, ktiles, per};
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN, splits);
  const bool tma = tma_describes<T>(a) && tma_describes<T>(b);
  switch (layout) {
    case kNT: err = launch<T, kNT, T>(args, grid, tma, st); break;
    case kNN: err = launch<T, kNN, float>(args, grid, tma, st); break;
    case kTN: err = launch<T, kTN, float>(args, grid, tma, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long count = (long long)M * N;
  sum_splits_kernel<float><<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      part, splits, M, N, (float*)C, ldc);
  return cudaGetLastError();
}

}  // namespace hg
}  // namespace vmt
