// The Mamba-2 (SSD) chunk walk shared by the mixer kernel (ssd_mixer.cu, K12),
// the projected mixer (ssd_pmixer.cu, K14) and the bare scan (K11's forward,
// vmt_ssd_scan in ssd_mixer.cu): conv + SiLU over the [x B C] slab, the
// state-passing chunk walk, the D skip, the silu(z) gate and the gated
// RMSNorm, from an in_proj output zx to the gated rows. Defined in
// ssd_mixer.cu for T = float and bf16.
#pragma once

#include <type_traits>

#include "add_norm.cuh"
#include "mixer_parts.cuh"

namespace vmt {

// Rows of (B, L, .) operands are batch-major: row r = b * L + t.
struct SsdArgs {
  const void* zx;          // (B * L, ld_zx) T: z at column 0, [x B C] at Di
  long long ld_zx;
  void* out;               // (B * L, Di) T: the gated rows
  const float* conv_state; // (B, CD, W), already rounded to T
  const float* conv_w;     // (CD, W)
  const float* conv_b;     // (CD,)
  const float* s;          // (B, Lp, H): per-chunk inclusive cumsum of dt * A
  const float* dt;         // (B, Lp, H): post-softplus dt, 0 on padded rows
  const float* Dskip;      // (H,) or null: no D skip
  const float* norm_w;     // (Di,) or null: no gated RMSNorm
  const float* h0;         // (B, H, P, N)
  float* h_last;           // (B, H, P, N)
  float* cy;               // scratch (B * L, CD): the conv after SiLU
  float* y;                // (B * L, Di): y before the gate (the backward's yd)
  float* hin;              // (B, nc, H, P, N): chunk states, then entry states (hins)
  float* cb;               // scratch (B, nc, G, Q, Q): each chunk's causal C B^T tiles
  int B, L, Q, H, P, G, N, W;
  float eps;
};

// Chunk rows the chunk kernels stage in shared memory at a time, and the
// width of the head-dim (P) and state (N) tiles they stage.
constexpr int kSsdSlab = 64;

// v rounded to the compute dtype T (bf16, or no rounding at fp32).
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The chunk kernels' 64 x 64 tile products (kSsdSlab rows and columns, 256
// threads): out[m][n] += sum_k A[k][m] B[k][n], both operands staged in
// shared memory contraction-major, in the compute dtype's staging type
// SlabT<T> (fp32, or bf16: the operands are rounded to T before every
// product, so a bf16 product is exact and only the fp32 sums' order is the
// tile's). fp32 multiplies on FMA, each thread a 4 x 4 tile at (m0, n0) =
// (4 (t / 16), 4 (t % 16)), two float4 shared loads for 16 FMAs (a warp's
// neighbouring threads hold neighbouring columns, so an output written to
// a row-major matrix goes out coalesced); bf16 on
// tensor cores (mma.sync m16n8k16, fp32 accumulate): 8 warps as 2 x 4, each
// a 32 x 16 tile, fragments by ldmatrix .trans (mixer_parts.cuh's
// mma_frag_a / mma_frag_b). Either way a thread holds 16 fp32 outputs;
// slab_each names their (m, n).
constexpr int kSlabThreads = 256;
constexpr int kSlabOut = 16;  // outputs a thread holds

template <typename T>
using SlabT = typename std::conditional<sizeof(T) == 2, bf16, float>::type;

// Row stride of a staged tile, in elements: bf16 rows padded to 16-byte
// multiples off the 128-byte period (ldmatrix reads 8 rows conflict-free).
template <typename T>
__host__ __device__ constexpr int slab_ld() {
  return sizeof(T) == 2 ? kSsdSlab + 8 : kSsdSlab;
}

template <typename T>
__host__ __device__ constexpr int slab_elems() {
  return kSsdSlab * slab_ld<T>();
}

// Calls f(i, m, n) for each of this thread's outputs: acc[i] is (m, n).
template <typename T, typename F>
__device__ __forceinline__ void slab_each(F f) {
  if constexpr (sizeof(T) == 2) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(mi * 8 + ni * 4 + e, wm + mi * 16 + lane / 4 + (e / 2) * 8,
            wn + ni * 8 + 2 * (lane % 4) + e % 2);
  } else {
    const int m0 = (threadIdx.x / 16) * 4, n0 = (threadIdx.x % 16) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(i * 4 + j, m0 + i, n0 + j);
  }
}

// acc += A^T B over contraction rows [0, kd) (bf16: rounded up to 16; the
// staged rows past kd are zero).
template <typename T>
__device__ __forceinline__ void slab_mma(float (&acc)[kSlabOut], const SlabT<T>* A,
                                         const SlabT<T>* B, int kd) {
  constexpr int ld = slab_ld<T>();
  if constexpr (sizeof(T) == 2) {
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
    for (int ks = 0; ks < kd; ks += 16) {
      uint32_t a[2][4], b[2][2];
      mma_frag_a<true>(a[0], A, ld, ks, wm);
      mma_frag_a<true>(a[1], A, ld, ks, wm + 16);
      mma_frag_b<true>(b[0], b[1], B, ld, ks, wn);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int o = mi * 8 + ni * 4;
          float d[4] = {acc[o], acc[o + 1], acc[o + 2], acc[o + 3]};
          mma_bf16_16816(d, a[mi], b[ni]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[o + e] = d[e];
        }
    }
  } else {
    const int m0 = (threadIdx.x / 16) * 4, n0 = (threadIdx.x % 16) * 4;
    for (int k = 0; k < kd; ++k) {
      const float4 a = ld4(A + k * ld + m0), b = ld4(B + k * ld + n0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i * 4 + j] += av[i] * bv[j];
    }
  }
}

template <typename S>
__device__ __forceinline__ S to_slab(float v) {
  if constexpr (sizeof(S) == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// Stages a (rows, cols) block of a row-major fp32 matrix (src, row stride
// ld) into a 64 x 64 tile, zero past rows and cols: kTrans, S[c][r] (its
// columns become the contraction), else S[r][c]. Each value is f(r, c, v)
// converted to the staging type (bf16 rounds it once). Reads go 16 bytes a
// load where src and ld allow: kTrans gives each thread 8 columns of one
// row, a warp 32 rows, so its scattered shared stores hit 32 banks.
template <typename T, bool kTrans, typename F>
__device__ __forceinline__ void slab_stage(SlabT<T>* S, const float* src, long long ld, int rows,
                                           int cols, F f) {
  using St = SlabT<T>;
  constexpr int sld = slab_ld<T>();
  const bool vec = ld % 4 == 0 && ((uintptr_t)src & 15u) == 0;
  if constexpr (kTrans) {
    for (int i = threadIdx.x; i < kSsdSlab * 8; i += kSlabThreads) {
      const int r = i % kSsdSlab, c0 = (i / kSsdSlab) * 8;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (r < rows) {
        const float* p = src + r * ld + c0;
        if (vec && c0 + 8 <= cols) {
          const float4 lo = ld4(p), hi = ld4(p + 4);
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (c0 + j < cols) v[j] = p[j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c0 + j < cols) v[j] = f(r, c0 + j, v[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) S[(c0 + j) * sld + r] = to_slab<St>(v[j]);
    }
  } else {
    for (int i = threadIdx.x; i < kSsdSlab * 16; i += kSlabThreads) {
      const int r = i / 16, c0 = (i % 16) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) {
        const float* p = src + r * ld + c0;
        if (vec && c0 + 4 <= cols) {
          const float4 q = ld4(p);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + j < cols) v[j] = p[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < cols) v[j] = f(r, c0 + j, v[j]);
      }
      if constexpr (sizeof(St) == 2) {
        const uint2 w = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
        *reinterpret_cast<uint2*>(S + r * sld + c0) = w;
      } else {
        *reinterpret_cast<float4*>(S + r * sld + c0) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// The staging rule of a plain operand: v rounded to T (the final conversion
// to the staging type does it for bf16).
struct AsIs {
  __device__ __forceinline__ float operator()(int, int, float v) const { return v; }
};

// Shared memory of the chunk-output kernel, the largest of the forward
// walk: three 64 x 64 staging tiles (m, x, and C and the entry state of an
// N tile share two) in the staging type, s and dt (Q,). It grows with
// neither P nor N.
template <typename T>
inline size_t ssd_out_smem_bytes(int Q) {
  return sizeof(SlabT<T>) * 3 * (size_t)slab_elems<T>() + sizeof(float) * 2 * (size_t)Q;
}

// Shared memory of the reverse walk's tile launches (ssd_core_bwd.cu), the
// largest chunk-kernel blocks: four staging tiles, one fp32 64 x 64 tile, s
// and dt (Q,), four per-row vectors and one per-thread vector.
template <typename T>
inline size_t ssd_side_smem_bytes(int Q) {
  return sizeof(SlabT<T>) * 4 * (size_t)slab_elems<T>() +
         sizeof(float) * ((size_t)kSsdSlab * kSsdSlab + 2 * (size_t)Q + 4 * kSsdSlab +
                          kSlabThreads);
}

// The gate of every chunk kernel: its largest block (fp32 staging) fits
// one block's 227 KB of shared memory.
inline size_t ssd_smem_bytes(int Q) {
  const size_t fwd = ssd_out_smem_bytes<float>(Q), bwd = ssd_side_smem_bytes<float>(Q);
  return fwd > bwd ? fwd : bwd;
}

// Causal 64 x 64 tile pairs (q slab >= k slab) of a chunk of Q rows.
inline int ssd_cb_tiles(int Q) {
  const int n = (Q + kSsdSlab - 1) / kSsdSlab;
  return n * (n + 1) / 2;
}

// cudaErrorInvalidValue for shapes the walk does not take: P and N
// multiples of 4, G dividing H, the chunk tiles in one block.
cudaError_t ssd_check(const SsdArgs& a);

// Launch: a.cb[b, c, g] = the causal tiles of C B^T over rows of a.cy
// (rnd(C) rnd(B) summed over n in order: the same fp32 values at fp32
// whichever kernel reads them). The forward's chunk-output launch and the
// backward's tile launches read these instead of building C B^T per head.
template <typename T>
cudaError_t ssd_cb(const float* cy, float* cb, int B, int L, int Q, int H, int P, int G, int N,
                   cudaStream_t stream);

template <typename T>
cudaError_t ssd_core(const SsdArgs& a, cudaStream_t stream);

// The walk alone (K11's forward): launches 2-5 of ssd_core over a.cy, which
// holds x, B and C (post-SiLU or the caller's inputs) as fp32 rows of CD.
template <typename T>
cudaError_t ssd_walk(const SsdArgs& a, cudaStream_t stream);

// The gate and the norm alone (launch 6): a.out = rnd(norm(a.y * silu(z))).
template <typename T>
cudaError_t ssd_gate(const SsdArgs& a, cudaStream_t stream);

}  // namespace vmt
