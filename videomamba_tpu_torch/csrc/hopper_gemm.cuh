// Matrix products on Hopper's tensor cores fed by TMA: the five projection
// products of K14's backward (ssd_pmixer_bwd.cu), which the TPU kernel runs
// in its body (videomamba_tpu/ops/pallas/ssd_block.py:655, 692, 696, 855,
// 859), and, at bf16, the forward's in_proj and out_proj of K4
// (block_fused.cu) and of K14 (ssd_pmixer.cu), which the TPU kernels also
// run in their bodies (block_fused.py, ssd_block.py:286, 323). Three
// layouts, named by how A and B are stored:
//
//   kNT: C = A B^T, A (M, K) and B (N, K), both contraction-contiguous
//        (K-major): zx = hidden Win^T, K4's xz = normed Win^T and out =
//        y Wout^T. C is written in the operands' dtype, or in fp32 where
//        the caller asks (K4's xz, which its walk reads in fp32).
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
// Design. One block computes 128 kMB x 128 tiles of C: a producer
// warpgroup and two consumer warpgroups, each taking 64 kMB rows with kMB
// wgmma m64n128 per k16 step (64 fp32 sums a thread per m64 block, in
// registers). kMB is 2 for the bf16 NT products (the serving forward's
// in_proj and out_proj, and zx): a 256 x 128 tile reads 48 KB a k-tile for
// 4.2 MFLOP, where 128 x 128 reads 32 KB for 2.1, a quarter less traffic
// from L2 a FLOP (at the serving shapes 10-15 % less time on the H100).
// The other layouts and fp32 keep kMB 1.
// A k-tile is 128 bytes deep (64 bf16 or 32 fp32 values), so each 128 rows
// of an operand's tile are 128 shared-memory rows of 128 bytes (16 KB) in
// TMA's 128-byte swizzle: one box {64 or 32, 128} K-major or two (bf16) or
// four (fp32) square boxes MN-major. The tiles go through a ring of 4
// stages filled by one TMA thread and released by the consumers on
// mbarriers (192 KB at kMB 2, 128 KB at kMB 1). bf16 keeps one k-tile of
// wgmma in flight. fp32 adds two buffers of B's hi and lo tiles (64 KB), so
// B's split of k-tile t overlaps the products of t - 1; its consumers hold
// 64 sums, 64 partial sums and A's 32 split values in flight, and bf16 at
// kMB 2 holds 128 sums, so the producer hands them its registers
// (setmaxnreg: 232 a consumer thread, 40 a producer thread). Shared memory bounds the fp32
// path: each k-tile moves about 190 KB through it (TMA's writes, B's
// split, wgmma's reads of B three times).
//
// Persistent walk. One block an SM walks C's tiles (and a kTN product's
// contraction slices) in the order tile = blockIdx.x + i gridDim.x, N
// fastest: the blocks in flight share a few row panels of A, and the
// weight operand B (4.7 MB at Base's in_proj) stays in L2 whole. The ring's
// stage and phase run on across tiles, so the producer loads the next
// tile's first k-tiles while the consumers store this tile's sums, and a
// launch pays for its prologue once an SM, not once a tile (K4's in_proj
// at K = 768 has 12 k-tiles a tile, and its fp32 epilogue writes 128 KB a
// 256 x 128 tile).
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
//
// What bounds each product on the H100: its operations. At the serving
// cells' shape (4 streams of L 12,545: 50,180 rows, bf16, H100 SXM 700 W),
// in time against the least time at 989 TFLOP/s (bytes at 3.35 TB/s):
// K4's in_proj (N 3072, K 768, fp32 C) 0.423 ms against 0.239 (0.209),
// K14's in_proj (N 3200) 0.406 against 0.249 (0.120), either out_proj (N
// 768, K 1536) 0.182 against 0.120 (0.070): 57-66 % of the peak, where
// cuBLAS takes 0.33, 0.35-0.38 and 0.17 ms. What is left is the traffic
// from L2 into shared memory (48 KB a k-tile of 256 x 128) and the
// epilogue, which no other warpgroup's products cover.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <atomic>

#include "add_norm.cuh"

namespace vmt {
namespace hg {

enum Layout : int { kNT = 0, kNN = 1, kTN = 2 };

constexpr int kTileN = 128;                // a block's tile of C: 128 kMB x 128
constexpr int kRowBytes = 128;             // a shared-memory row: the swizzle span
constexpr int kTileBytes = 128 * kRowBytes;  // 128 rows of an operand's k-tile
constexpr int kConsumers = 256;            // two warpgroups, 64 kMB rows of C each
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kMaxSplits = 4;               // contraction slices of a kTN product
constexpr int kMaxDevices = 64;             // devices the host caches know

// m64 blocks a consumer warpgroup takes: 2 for bf16 NT (A K-major), else 1.
template <typename T, int kLayout>
constexpr int m_blocks() {
  return sizeof(T) == 2 && kLayout == kNT ? 2 : 1;
}

template <typename T, int kMB>
struct Ring {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kDepth = kRowBytes / (int)sizeof(T);  // k values a k-tile
  static constexpr int kTileM = 128 * kMB;                   // rows of C a tile
  static constexpr int kABytes = kMB * kTileBytes;           // A's k-tile
  static constexpr int kStageBytes = kABytes + kTileBytes;   // and B's
  static constexpr int kStages = 4;
  static constexpr int kSplitBufs = kBf16 ? 0 : 2;  // fp32: B's hi and lo tiles
  // Consumers need more than launch_bounds' 168 registers a thread.
  static constexpr bool kMoreRegs = !kBf16 || kMB > 1;
  static constexpr int kSmem =
      kStages * kStageBytes + 2 * kSplitBufs * kTileBytes + 16 * kStages + 1024;  // + alignment
};

struct Operand {
  const void* ptr;
  long long ld;      // elements between stored rows
  int inner, outer;  // stored extents: the contiguous one, then the other
};

struct Args {
  Operand a, b;
  void* c;        // (M, N), rows of ldc: fp32, or the operands' dtype (kNT)
  long long ldc;
  float* part;    // splits > 1: splits slices of (M, N) fp32
  int M, N, K;
  int ktiles, per_split;
  int tiles_m, tiles_n, splits;  // the walk: tiles_m tiles_n splits work items
};

// Work item i of the persistent walk: C's tile (m0, n0) of contraction
// slice z, N fastest.
__device__ __forceinline__ void work_item(const Args& a, int tile_m, int i, int& m0, int& n0,
                                          int& z) {
  const int n = i % a.tiles_n, r = i / a.tiles_n;
  n0 = n * kTileN;
  m0 = (r % a.tiles_m) * tile_m;
  z = r / a.tiles_m;
}

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

// TMA loads of one operand's k-tile of 128 kBlocks rows (the map's box:
// {kDepth, 128} K-major, {kDepth, kDepth} MN-major, where kBlocks is 1).
template <int kDepth, bool kMN, int kBlocks>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                          int mn0, int k0) {
  if constexpr (kMN) {
    static_assert(kBlocks == 1, "MN-major tiles are 128 rows");
#pragma unroll
    for (int j = 0; j < 128 / kDepth; ++j)
      tma_load(dst + j * kDepth * kRowBytes, map, bar, mn0 + j * kDepth, k0);
  } else {
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) tma_load(dst + j * kTileBytes, map, bar, k0, mn0 + 128 * j);
  }
}

// The staging variant's load of the same k-tile, by the 128 producer
// threads, element by element (any address and row stride).
template <typename T, bool kMN, int kBlocks>
__device__ __forceinline__ void stage_tile(const Operand& op, uint8_t* dst, int mn0, int k0,
                                           int pt) {
  constexpr int kDepth = kRowBytes / (int)sizeof(T);
  const T* src = (const T*)op.ptr;
  for (int i = pt; i < 128 * kBlocks * kDepth; i += 128) {
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// This warpgroup's 64 x 128 sums: wgmma's accumulator layout, d[4 j + q] at
// row 16 warp + lane / 4 + 8 (q / 2), column 8 j + 2 (lane % 4) + q % 2.
// Where the tile's 128 columns lie inside C and rows of C start on 16
// bytes, neighbouring lanes swap halves of column blocks j and j + 1 (one
// shuffle a value), so each lane stores 4 consecutive values and a warp's
// store covers whole 32-byte sectors of 8 rows (bf16: one sector a row, not
// two halves; fp32: two a row) with half the store instructions.
template <typename TO>
__device__ __forceinline__ void store_tile(const float (&d)[64], TO* c, long long ldc, int M,
                                           int N, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  if (col0 - 2 * (lane & 3) + kTileN <= N && ldc % 4 == 0 && (uintptr_t)c % 16 == 0) {
    const bool odd = lane & 1;  // odd lanes store block j + 1, even lanes block j
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      TO* const p = c + (long long)row * ldc + col0 + (odd ? 6 : 0);
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const float* a = &d[4 * j + 2 * h];        // block j: columns 2 (lane % 4) + {0, 1}
        const float* b = &d[4 * (j + 1) + 2 * h];  // block j + 1
        if constexpr (sizeof(TO) == 2) {
          const uint32_t wa = pack_bf16x2(a[0], a[1]), wb = pack_bf16x2(b[0], b[1]);
          const uint32_t r = __shfl_xor_sync(0xffffffffu, odd ? wa : wb, 1);
          if (row < M) *(uint2*)(p + 8 * j) = odd ? make_uint2(r, wb) : make_uint2(wa, r);
        } else {
          const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : b[0], 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : b[1], 1);
          if (row < M)
            *(float4*)(p + 8 * j) =
                odd ? make_float4(r0, r1, b[0], b[1]) : make_float4(a[0], a[1], r0, r1);
        }
      }
    }
    return;
  }
  const bool vec = ldc % 2 == 0 && (uintptr_t)c % (2 * sizeof(TO)) == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_pair(c, ldc, M, N, row0 + 8 * h, col0 + 8 * j, d[4 * j + 2 * h],
                 d[4 * j + 2 * h + 1], vec);
  }
}

template <typename T, int kLayout, int kMB, bool kTma, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    product_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const Args args) {
  using R = Ring<T, kMB>;
  constexpr int kDepth = R::kDepth, kStages = R::kStages;
  constexpr bool kAMN = kLayout == kTN, kBMN = kLayout != kNT;
  static_assert(kMB == 1 || !kAMN, "an MN-major A takes 64 rows a warpgroup");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw0 = saddr(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw0);
  // Stage s: A's tile at s kStageBytes, B's after it; fp32: B's split
  // buffers; then the full and empty barriers of each stage.
  const uint32_t split0 = base + kStages * R::kStageBytes;
  const uint32_t bars = split0 + 2 * R::kSplitBufs * kTileBytes;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int items = args.tiles_m * args.tiles_n * args.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), kTma ? 1 : 128);
      bar_init(empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Both sides walk the same work items; `it` counts k-tiles over all of
  // them, so a stage's phase runs on from one tile to the next.
  if (threadIdx.x >= kConsumers) {  // the producer: fill the ring
    // hand registers to the consumers (168 a thread at launch; 40 here,
    // 232 there)
    if constexpr (R::kMoreRegs) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int pt = threadIdx.x - kConsumers;
    if (!kTma || pt == 0) {
      int it = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        int m0, n0, z;
        work_item(args, R::kTileM, i, m0, n0, z);
        const int kt0 = z * args.per_split;
        const int nkt = min(args.ktiles - kt0, args.per_split);  // >= 1 (the host's split)
        for (int t = 0; t < nkt; ++t, ++it) {
          const int s = it % kStages;
          bar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          const int k0 = (kt0 + t) * kDepth;
          const uint32_t sa = base + s * R::kStageBytes, sb = sa + R::kABytes;
          if constexpr (kTma) {
            bar_expect(full(s), R::kStageBytes);
            load_tile<kDepth, kAMN, kMB>(&map_a, sa, full(s), m0, k0);
            load_tile<kDepth, kBMN, 1>(&map_b, sb, full(s), n0, k0);
          } else {
            stage_tile<T, kAMN, kMB>(args.a, gbase + (sa - base), m0, k0, pt);
            stage_tile<T, kBMN, 1>(args.b, gbase + (sb - base), n0, k0, pt);
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            bar_arrive(full(s));
          }
        }
      }
    }
  } else {  // the consumers
    if constexpr (R::kMoreRegs) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = threadIdx.x / 128;  // rows [64 kMB wg, 64 kMB (wg + 1)) of the tile
    const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
    // bf16: the wgmma sums d run over all of K. fp32: d holds one k-tile's
    // products and is added into acc in fp32 after each k-tile, since the
    // tensor cores' own fp32 sums truncate (over K = 3200 they drift by 2e-5
    // of the largest element on the card, the fp32 bar).
    float d[kMB][64], acc[64];
    uint32_t a[4][2][4];  // fp32: A's split values of a k-tile, in flight
    int it = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      int m0, n0, z;
      work_item(args, R::kTileM, i, m0, n0, z);
      const int kt0 = z * args.per_split;
      const int nkt = min(args.ktiles - kt0, args.per_split);
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        acc[j] = 0.f;
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) d[mb][j] = 0.f;
      }
      for (int t = 0; t < nkt; ++t, ++it) {
        const int s = it % kStages;
        bar_wait(full(s), (it / kStages) & 1);
        const uint32_t sa = base + s * R::kStageBytes, sb = sa + R::kABytes;
        if constexpr (R::kBf16) {
          // A's 64-row blocks: K-major, rows 64 (kMB wg + mb) on; MN-major,
          // the 64-wide block wg. A k16 step: 32 bytes along a K-major row,
          // 16 rows of an MN-major tile.
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kDepth / 16; ++kk) {
            const uint32_t pb = sb + (kBMN ? kk * 16 * kRowBytes : kk * 32);
            const uint64_t db = desc(pb, kBMN ? 64 * kRowBytes : 16, 8 * kRowBytes);
#pragma unroll
            for (int mb = 0; mb < kMB; ++mb) {
              const uint32_t pa = sa + (wg * kMB + mb) * 64 * kRowBytes +
                                  (kAMN ? kk * 16 * kRowBytes : kk * 32);
              mma_bf16<kAMN, kBMN>(d[mb], desc(pa, kAMN ? 64 * kRowBytes : 16, 8 * kRowBytes),
                                   db);
            }
          }
          wg_commit();
          wg_wait<1>();  // k-tile it - 1's products are done: release its stage
          if (t > 0) release(empty((it - 1) % kStages));
        } else {
          // B's split of k-tile it (while it - 1's products run), then A's
          // into registers once it - 1's have released theirs.
          const uint32_t sp = split0 + (it & 1) * 2 * kTileBytes;  // B hi, B lo
          split_tile<kBMN>(gbase + (sb - base), gbase + (sp - base),
                           gbase + (sp - base) + kTileBytes, threadIdx.x);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          wg_wait<0>();  // this warpgroup's products of k-tile it - 1
          fence_sums(d[0]);
          fence_frags(a);
#pragma unroll
          for (int j = 0; j < 64; ++j) acc[j] += d[0][j];
          split_frags<kAMN>(gbase + (sa - base), wg * 64 + warp * 16, a);
          release(empty(s));
          // Both warpgroups: B's split of it is written and it - 1's
          // products, which read the other buffer, are done (the next split
          // may reuse it).
          asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kDepth / 8; ++kk) {
            const uint64_t bhi = desc(sp + kk * 32, 16, 8 * kRowBytes);
            const uint64_t blo = desc(sp + kTileBytes + kk * 32, 16, 8 * kRowBytes);
            mma_tf32(d[0], a[kk][0], bhi, kk > 0);
            mma_tf32(d[0], a[kk][0], blo, 1);
            mma_tf32(d[0], a[kk][1], bhi, 1);
          }
          wg_commit();
        }
      }
      wg_wait<0>();
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) fence_sums(d[mb]);
      if constexpr (R::kBf16) {
        release(empty((it - 1) % kStages));  // the tile's last k-tile
      } else {
        fence_frags(a);
#pragma unroll
        for (int j = 0; j < 64; ++j) d[0][j] += acc[j];
      }

      // The stores are issued and left to drain while the next tile's
      // products run.
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        const int row0 = m0 + (wg * kMB + mb) * 64 + warp * 16 + lane / 4;
        const int col0 = n0 + 2 * (lane & 3);
        if (args.splits > 1) {
          store_tile(d[mb], args.part + (long long)z * args.M * args.N, args.N, args.M, args.N,
                     row0, col0);
        } else {
          store_tile(d[mb], (TO*)args.c, args.ldc, args.M, args.N, row0, col0);
        }
      }
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
  constexpr int kDepth = kRowBytes / (int)sizeof(T);
  const cuuint64_t dims[2] = {(cuuint64_t)op.inner, (cuuint64_t)op.outer};
  const cuuint64_t strides[1] = {(cuuint64_t)op.ld * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)kDepth, (cuuint32_t)(mn_major ? kDepth : 128)};
  const cuuint32_t unit[2] = {1, 1};
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const CUresult res = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(op.ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The current device and its SM count, read from the runtime once a device.
inline cudaError_t device_sms(int& dev, int& sms) {
  static std::atomic<int> known[kMaxDevices];
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < kMaxDevices && (sms = known[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if (dev < kMaxDevices) known[dev].store(sms, std::memory_order_relaxed);
  return cudaSuccess;
}

// Contraction slices of a product: 1 but for kTN, whose slice count (at most
// kMaxSplits, each slice at least one k-tile) has the least modelled time:
// waves of work items at one an SM times each item's k-tiles, plus the
// bytes of the ordered sum. The model's rates are round figures for the
// card; the choice depends on the shape and the SM count only, so repeats
// match. (kTN tiles are 128 x 128.)
inline int splits_for(int layout, bool bf16, int M, int N, int K, int sms) {
  if (layout != kTN) return 1;
  const int depth = bf16 ? 64 : 32;
  const long long tiles = (long long)((M + 127) / 128) * ((N + kTileN - 1) / kTileN);
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

// One launch of the persistent walk: min(work items, SMs) blocks. The
// kernels' shared-memory opt-in is made once a device.
template <typename T, int kLayout, int kMB, typename TO>
inline cudaError_t launch(Args args, int dev, int sms, bool tma, cudaStream_t st) {
  using R = Ring<T, kMB>;
  CUtensorMap ma{}, mb{};
  cudaError_t err;
  if (tma) {
    if ((err = make_map<T>(&ma, args.a, kLayout == kTN)) != cudaSuccess) return err;
    if ((err = make_map<T>(&mb, args.b, kLayout != kNT)) != cudaSuccess) return err;
  }
  args.tiles_m = (args.M + R::kTileM - 1) / R::kTileM;
  args.tiles_n = (args.N + kTileN - 1) / kTileN;
  const auto kernel = tma ? product_kernel<T, kLayout, kMB, true, TO>
                          : product_kernel<T, kLayout, kMB, false, TO>;
  static std::atomic<unsigned long long> opted[2];  // a bit a device, by tma
  const unsigned long long bit = dev < kMaxDevices ? 1ull << dev : 0;
  if (!bit || !(opted[tma].load(std::memory_order_relaxed) & bit)) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    R::kSmem)) != cudaSuccess)
      return err;
    opted[tma].fetch_or(bit, std::memory_order_relaxed);
  }
  const long long items = (long long)args.tiles_m * args.tiles_n * args.splits;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kernel<<<grid, kThreads, R::kSmem, st>>>(ma, mb, args);
  return cudaGetLastError();
}

// C (M, N) with rows of ldc for `layout` (see the top of this file); A and B
// stored with rows of lda and ldb, the operands' dtype T; C fp32 for kNN and
// kTN, and for kNT fp32 when c_f32, else T. part: kMaxSplits M N floats of
// scratch for kTN, null otherwise.
template <typename T>
cudaError_t product(int layout, const T* A, long long lda, const T* B, long long ldb, void* C,
                    long long ldc, int M, int N, int K, float* part, cudaStream_t st,
                    bool c_f32 = false) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (layout == kTN && !part) return cudaErrorInvalidValue;
  Operand a{A, lda, layout == kTN ? M : K, layout == kTN ? K : M};
  Operand b{B, ldb, layout == kNT ? K : N, layout == kNT ? N : K};
  int dev = 0, sms = 132;
  cudaError_t err;
  if ((err = device_sms(dev, sms)) != cudaSuccess) return err;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kDepth = kRowBytes / (int)sizeof(T);
  const int ktiles = (K + kDepth - 1) / kDepth;
  const int splits = splits_for(layout, kBf16, M, N, K, sms);
  const int per = (ktiles + splits - 1) / splits;
  const Args args{a, b, C, ldc, part, M, N, K, ktiles, per, 0, 0, splits};
  const bool tma = tma_describes<T>(a) && tma_describes<T>(b);
  constexpr int kMbNT = m_blocks<T, kNT>();
  switch (layout) {
    case kNT:
      err = c_f32 ? launch<T, kNT, kMbNT, float>(args, dev, sms, tma, st)
                  : launch<T, kNT, kMbNT, T>(args, dev, sms, tma, st);
      break;
    case kNN: err = launch<T, kNN, 1, float>(args, dev, sms, tma, st); break;
    case kTN: err = launch<T, kTN, 1, float>(args, dev, sms, tma, st); break;
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
