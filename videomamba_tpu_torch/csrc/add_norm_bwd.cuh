// Backward of the residual add + RMSNorm / LayerNorm row kernel, shared by
// K8 (fused_add_norm_bwd.cu) and the last launch of K7 (block_bwd.cu).
//
// Per row, in fp32:
//   r = x + residual;  rms: inv = 1/sqrt(mean(r^2) + eps), nrm = r inv
//                      layer: cen = r - mean(r), inv = 1/sqrt(mean(cen^2) + eps),
//                      nrm = cen inv
//   dweight += g nrm;  dbias += g;  dn = g weight
//   rms:   dr = dn inv - r inv^3 sum(dn r) / D
//   layer: dc = dn inv - cen inv^3 sum(dn cen) / D;  dr = dc - mean(dc)
//   prenorm: dr += g_res;  dx = dr (x's dtype), dresidual = dr (its dtype)
//
// What bounds it on the H100: device memory (three or four rows read, two
// written, a few flops an element). So the layout is chosen to keep enough
// bytes in flight and to read and write each element once:
// - A group of `threads` threads holds a row in registers: each thread owns
//   up to 24 elements of it (16 at one element a vector), as vectors of
//   `vec` elements (16-byte loads and stores: 4 fp32, or 8 bf16 when every
//   row array is bf16; a bf16 array beside fp32 ones moves 8 bytes a
//   vector; vec 1 for a D no multiple of the vector or a pointer the vector
//   cannot start at). A thread issues all of its row's loads (x, residual,
//   g_n and g_r) before the first reduction, so a row costs one trip to
//   device memory, and keeps cen, dn and g_r across the passes. One warp
//   takes a row up to D = 768 (reductions by shuffles alone), 2-8 warps a
//   wider one (a shared word a warp, the group meeting at its own named
//   barrier); a block holds as many row groups as fill 256 threads.
// - dweight and dbias: each thread owns fixed columns and adds its rows'
//   terms into its row group's own row of shared memory (its own columns,
//   no barrier) while the block walks rows with a grid stride; registers
//   are kept for the row. At the end the block's groups are added in group
//   order into one partial row a block (about two blocks an SM: at most 264
//   partial rows). A second launch sums them over columns and slices of
//   rows, in a fixed tree (add_norm_bwd_sum_kernel). No floating-point
//   atomics: two runs on the same inputs are bit-identical.
// - A block's shared memory is all dynamic: its groups' dweight / dbias
//   rows, then, for groups wider than a warp, their reduction words
//   (norm_bwd_smem_floats). It stays within the 48 KB a launch may take
//   without opting in, so no function attribute is set.
// - Rows wider than 256 threads x 24 elements (D > 6144; 4096 at one
//   element a vector), or whose sums and reduction words pass 48 KB
//   (6128 < D <= 6144), are streamed: one row a block of 256 threads, the
//   row read again from device memory (from L2, in practice) in each pass,
//   the block's dweight / dbias sums kept in its own partial row.
// The host plans the launch (ops/kernels/fused_add_norm.py norm_bwd_plan,
// which K8's and K7's wrappers pass in); launch_add_norm_bwd checks it.
#pragma once

#include "add_norm.cuh"

namespace vmt {

constexpr int kNormBwdRowElems = 24;       // row elements a thread holds in registers
constexpr int kNormBwdRowElemsScalar = 16; // the same at one element a vector
constexpr int kNormBwdSmemFloats = 12288;  // a block's dynamic shared memory (48 KB)
constexpr int kNormBwdMaxThreads = 256;    // threads a row group, at most
constexpr int kNormBwdSumCols = 8;         // columns a block of the column sum
constexpr int kNormBwdSumSlices = 32;      // slices of partial rows a column sum adds
constexpr int kNormBwdMaxWarps = kNormBwdMaxThreads / 32;
constexpr int kNormBwdRedFloats = 4 * kNormBwdMaxWarps;  // a wide group's reduction words

// Row elements a thread holds at this vector width (a scalar row keeps
// fewer: its per-element addressing costs registers).
__host__ __device__ constexpr int norm_bwd_row_elems(int vec) {
  return vec == 1 ? kNormBwdRowElemsScalar : kNormBwdRowElems;
}

// A row-pass block's dynamic shared memory in floats: `rows` dweight /
// dbias rows of 2 x D, then the reduction words when a group is wider
// than a warp (one warp reduces by shuffles alone).
__host__ __device__ constexpr long long norm_bwd_smem_floats(int rows, int threads, int D) {
  return 2LL * rows * D + (threads > 32 ? kNormBwdRedFloats : 0);
}

// How a row pass is laid out (the wrapper's norm_bwd_plan, field by field).
struct NormBwdPlan {
  int vec;      // elements a vector: 1, 4 or 8
  int threads;  // threads a row (a multiple of 32, at most kNormBwdMaxThreads)
  int rows;     // rows a block
  int blocks;   // grid of the row pass; part holds blocks x 2 x D floats
  int stream;   // 1: the row is streamed from device memory in each pass
};

// --- vectors of V elements of T, as fp32 ------------------------------------

__device__ __forceinline__ float bf16_lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // each rounded to nearest even
  return *reinterpret_cast<const unsigned int*>(&h);
}

// p must be aligned to V * sizeof(T) bytes (V = 8 fp32: 16 bytes).
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  if constexpr (V == 1) {
    out[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 v = reinterpret_cast<const float4*>(p)[h];
      out[4 * h] = v.x;
      out[4 * h + 1] = v.y;
      out[4 * h + 2] = v.z;
      out[4 * h + 3] = v.w;
    }
  } else if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(u.x);
    out[1] = bf16_hi(u.x);
    out[2] = bf16_lo(u.y);
    out[3] = bf16_hi(u.y);
  } else {
    static_assert(V == 8, "bf16 vectors are 4 or 8 elements");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[2 * k] = bf16_lo(w[k]);
      out[2 * k + 1] = bf16_hi(w[k]);
    }
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      reinterpret_cast<float4*>(p)[h] =
          make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    }
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else {
    static_assert(V == 8, "bf16 vectors are 4 or 8 elements");
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                              pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Sum of v over a row's group of `threads` threads (every thread gets it):
// shuffles within the warp, then, for a group wider than a warp, one shared
// word a warp added in warp order, the group's own threads meeting at named
// barrier 1 + grp. `slot` (kNormBwdMaxWarps words) is this reduction's own,
// so a fast thread's next write never meets a slow thread's read of it.
template <int kThreads>
__device__ __forceinline__ float group_sum(float v, int threads, int grp, float* slot) {
  v = warp_sum(v);
  if constexpr (kThreads == 32) {
    return v;
  } else {
    const int nw = threads >> 5;
    if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
    named_sync(1 + grp, threads);
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += slot[grp * nw + w];
    return s;
  }
}

// Rows in registers (D <= threads x norm_bwd_row_elems(V)). g_n is the
// cotangent of the normed output (TN), g_r that of the returned residual
// (TG, may be null); residual and dres may be null. kThreads 32: one warp
// a row, compiled as such (the slots' offsets are then constants); 0:
// `threads_arg` (> 32) threads a row. blockDim.x / threads row groups a
// block, each with its own dweight / dbias row in dynamic shared memory
// (rows x 2 x D floats, each thread adding into its own columns; then
// kNormBwdRedFloats reduction words when kThreads is 0); at the end the
// groups' rows are added in group order into the block's partial row,
// part[blockIdx.x][0][:] dweight, [1][:] dbias.
template <typename TX, typename TR, typename TG, typename TN, int V, int kThreads>
__global__ void __launch_bounds__(kNormBwdMaxThreads, 2) add_norm_bwd_rows_kernel(
    const TX* __restrict__ x, const TR* __restrict__ residual,
    const float* __restrict__ weight, const TN* __restrict__ g_n,
    const TG* __restrict__ g_r, TX* __restrict__ dx, TR* __restrict__ dres,
    float* __restrict__ part, long long M, int D, int threads_arg, float eps, int is_rms) {
  constexpr int S = norm_bwd_row_elems(V) / V;  // vectors a thread holds
  extern __shared__ float4 norm_bwd_smem[];
  const int threads = kThreads ? kThreads : threads_arg;
  const int rows = blockDim.x / threads;
  const int grp = threadIdx.x / threads;
  const int t = threadIdx.x % threads;
  const int nvec = D / V;
  const float inv_d = 1.f / (float)D;
  float* acc = reinterpret_cast<float*>(norm_bwd_smem);
  float* accw = acc + (long long)grp * 2 * D;  // this group's dweight sums, then dbias
  float* accb = accw + D;
  float* red = acc + (long long)rows * 2 * D;  // read only when kThreads is 0
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = t + s * threads;
    if (j < nvec) {
      const float z[V] = {};
      store_vec<V>(accw + j * V, z);
      store_vec<V>(accb + j * V, z);
    }
  }
  for (long long row = (long long)blockIdx.x * rows + grp; row < M;
       row += (long long)gridDim.x * rows) {
    const long long off = row * D;
    float cen[S][V], dn[S][V], gr[S][V];
    // Every load of the row first: x (+ residual) into cen, g_n into dn,
    // g_r into gr.
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = t + s * threads;
      if (j < nvec) {
        const long long at = off + (long long)j * V;
        load_vec<V>(x + at, cen[s]);
        load_vec<V>(g_n + at, dn[s]);
        if (g_r) {
          load_vec<V>(g_r + at, gr[s]);
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c) gr[s][c] = 0.f;
        }
        if (residual) {
          float rv[V];
          load_vec<V>(residual + at, rv);
#pragma unroll
          for (int c = 0; c < V; ++c) cen[s][c] += rv[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) cen[s][c] = dn[s][c] = gr[s][c] = 0.f;
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int c = 0; c < V; ++c) sum += is_rms ? cen[s][c] * cen[s][c] : cen[s][c];
    }
    sum = group_sum<kThreads>(sum, threads, grp, red);
    float inv;
    if (is_rms) {
      inv = 1.f / sqrtf(sum * inv_d + eps);
    } else {
      const float mean = sum * inv_d;
      float s2 = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool live = t + s * threads < nvec;  // padding stays 0
#pragma unroll
        for (int c = 0; c < V; ++c) {
          cen[s][c] = live ? cen[s][c] - mean : 0.f;
          s2 += cen[s][c] * cen[s][c];
        }
      }
      const float s2_all = group_sum<kThreads>(s2, threads, grp, red + kNormBwdMaxWarps);
      inv = 1.f / sqrtf(s2_all * inv_d + eps);
    }
    float dot = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = t + s * threads;
      if (j >= nvec) continue;
      float w[V], aw[V], ab[V];
      load_vec<V>(weight + (long long)j * V, w);
      load_vec<V>(accw + j * V, aw);
      load_vec<V>(accb + j * V, ab);
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float gv = dn[s][c];
        aw[c] += gv * (cen[s][c] * inv);
        ab[c] += gv;
        dn[s][c] = gv * w[c];
        dot += dn[s][c] * cen[s][c];
      }
      store_vec<V>(accw + j * V, aw);
      store_vec<V>(accb + j * V, ab);
    }
    dot = group_sum<kThreads>(dot, threads, grp, red + 2 * kNormBwdMaxWarps);
    const float coef = inv * inv * inv * dot * inv_d;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int c = 0; c < V; ++c) dn[s][c] = dn[s][c] * inv - cen[s][c] * coef;  // dr (rms), dc
    }
    if (!is_rms) {
      float sdc = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (t + s * threads < nvec) {
#pragma unroll
          for (int c = 0; c < V; ++c) sdc += dn[s][c];
        }
      }
      const float mean_dc =
          group_sum<kThreads>(sdc, threads, grp, red + 3 * kNormBwdMaxWarps) * inv_d;
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int c = 0; c < V; ++c) dn[s][c] -= mean_dc;
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = t + s * threads;
      if (j >= nvec) continue;
#pragma unroll
      for (int c = 0; c < V; ++c) dn[s][c] += gr[s][c];
      store_vec<V>(dx + off + (long long)j * V, dn[s]);
      if (dres) store_vec<V>(dres + off + (long long)j * V, dn[s]);
    }
  }
  // The block's partial row: its row groups' sums added in group order.
  __syncthreads();
  float* pw = part + (long long)blockIdx.x * 2 * D;
  for (int i = threadIdx.x; i < 2 * D; i += blockDim.x) {
    float v = acc[i];
    for (int g = 1; g < rows; ++g) v += acc[(long long)g * 2 * D + i];
    pw[i] = v;
  }
}

// A row too wide for registers: one row a block (blockDim.x threads), read
// again from device memory in each pass; the block's dweight / dbias sums
// accumulate in its own partial row of part (each thread its own columns).
template <typename TX, typename TR, typename TG, typename TN, int V>
__global__ void __launch_bounds__(kNormBwdMaxThreads) add_norm_bwd_stream_kernel(
    const TX* __restrict__ x, const TR* __restrict__ residual,
    const float* __restrict__ weight, const TN* __restrict__ g_n,
    const TG* __restrict__ g_r, TX* __restrict__ dx, TR* __restrict__ dres,
    float* __restrict__ part, long long M, int D, float eps, int is_rms) {
  __shared__ float red[4][kNormBwdMaxWarps];
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int nvec = D / V;
  const float inv_d = 1.f / (float)D;
  float* accw = part + (long long)blockIdx.x * 2 * D;
  float* accb = accw + D;
  for (int j = t; j < nvec; j += threads) {
    const float z[V] = {};
    store_vec<V>(accw + (long long)j * V, z);
    store_vec<V>(accb + (long long)j * V, z);
  }
  for (long long row = blockIdx.x; row < M; row += gridDim.x) {
    const long long off = row * D;
    auto load_r = [&](int j, float* v) {
      load_vec<V>(x + off + (long long)j * V, v);
      if (residual) {
        float rv[V];
        load_vec<V>(residual + off + (long long)j * V, rv);
#pragma unroll
        for (int c = 0; c < V; ++c) v[c] += rv[c];
      }
    };
    float sum = 0.f;
#pragma unroll 4
    for (int j = t; j < nvec; j += threads) {
      float v[V];
      load_r(j, v);
#pragma unroll
      for (int c = 0; c < V; ++c) sum += is_rms ? v[c] * v[c] : v[c];
    }
    sum = group_sum<0>(sum, threads, 0, red[0]);
    float inv, mean = 0.f;
    if (is_rms) {
      inv = 1.f / sqrtf(sum * inv_d + eps);
    } else {
      mean = sum * inv_d;
      float s2 = 0.f;
#pragma unroll 4
      for (int j = t; j < nvec; j += threads) {
        float v[V];
        load_r(j, v);
#pragma unroll
        for (int c = 0; c < V; ++c) s2 += (v[c] - mean) * (v[c] - mean);
      }
      inv = 1.f / sqrtf(group_sum<0>(s2, threads, 0, red[1]) * inv_d + eps);
    }
    // cen, g_n and weight of vector j, recomputed from device memory in
    // the same order in each pass.
    auto operands = [&](int j, float* cen, float* g, float* w) {
      load_r(j, cen);
      load_vec<V>(g_n + off + (long long)j * V, g);
      load_vec<V>(weight + (long long)j * V, w);
      if (!is_rms) {
#pragma unroll
        for (int c = 0; c < V; ++c) cen[c] -= mean;
      }
    };
    float dot = 0.f;
#pragma unroll 2
    for (int j = t; j < nvec; j += threads) {
      float cen[V], g[V], w[V], aw[V], ab[V];
      operands(j, cen, g, w);
      load_vec<V>(accw + (long long)j * V, aw);
      load_vec<V>(accb + (long long)j * V, ab);
#pragma unroll
      for (int c = 0; c < V; ++c) {
        aw[c] += g[c] * (cen[c] * inv);
        ab[c] += g[c];
        dot += (g[c] * w[c]) * cen[c];
      }
      store_vec<V>(accw + (long long)j * V, aw);
      store_vec<V>(accb + (long long)j * V, ab);
    }
    dot = group_sum<0>(dot, threads, 0, red[2]);
    const float coef = inv * inv * inv * dot * inv_d;
    auto dr_at = [&](int j, float* dr) {
      float cen[V], g[V], w[V];
      operands(j, cen, g, w);
#pragma unroll
      for (int c = 0; c < V; ++c) dr[c] = (g[c] * w[c]) * inv - cen[c] * coef;
    };
    float mean_dc = 0.f;
    if (!is_rms) {
      float sdc = 0.f;
#pragma unroll 2
      for (int j = t; j < nvec; j += threads) {
        float dc[V];
        dr_at(j, dc);
#pragma unroll
        for (int c = 0; c < V; ++c) sdc += dc[c];
      }
      mean_dc = group_sum<0>(sdc, threads, 0, red[3]) * inv_d;
    }
#pragma unroll 2
    for (int j = t; j < nvec; j += threads) {
      float dr[V];
      dr_at(j, dr);
#pragma unroll
      for (int c = 0; c < V; ++c) dr[c] -= mean_dc;
      if (g_r) {
        float gv[V];
        load_vec<V>(g_r + off + (long long)j * V, gv);
#pragma unroll
        for (int c = 0; c < V; ++c) dr[c] += gv[c];
      }
      store_vec<V>(dx + off + (long long)j * V, dr);
      if (dres) store_vec<V>(dres + off + (long long)j * V, dr);
    }
  }
}

// dweight, dbias (D,) = the partial rows of part (P x 2D) summed: block
// (kNormBwdSumCols columns) x (kNormBwdSumSlices slices); slice k adds rows
// k, k + 32, ... in order, then the slices add in a fixed tree (16, 8, 4,
// 2, 1 apart). The order depends on nothing but P, so the bits do not
// depend on which row-pass block finished last. dbias may be null.
static __global__ void __launch_bounds__(kNormBwdSumCols * kNormBwdSumSlices)
    add_norm_bwd_sum_kernel(const float* __restrict__ part, int P, int D,
                            float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float s[kNormBwdSumSlices][kNormBwdSumCols + 1];
  const int c = threadIdx.x % kNormBwdSumCols;
  const int k = threadIdx.x / kNormBwdSumCols;
  const long long col = (long long)blockIdx.x * kNormBwdSumCols + c;
  const long long width = 2LL * D;
  float acc = 0.f;
  if (col < width) {
#pragma unroll 4
    for (int p = k; p < P; p += kNormBwdSumSlices) acc += part[(long long)p * width + col];
  }
  s[k][c] = acc;
  __syncthreads();
#pragma unroll
  for (int h = kNormBwdSumSlices / 2; h > 0; h >>= 1) {
    if (k < h) s[k][c] += s[k + h][c];
    __syncthreads();
  }
  if (k == 0 && col < width) {
    if (col < D) {
      dw[col] = s[0][c];
    } else if (db) {
      db[col - D] = s[0][c];
    }
  }
}

inline bool aligned_to(const void* p, int bytes) {
  return p == nullptr || ((unsigned long long)p % (unsigned long long)bytes) == 0;
}

// The vector width the types allow: 8 when every row array is bf16, else 4.
template <typename TX, typename TR, typename TG, typename TN>
constexpr int norm_bwd_vec() {
  return (sizeof(TX) == 2 && sizeof(TR) == 2 && sizeof(TG) == 2 && sizeof(TN) == 2) ? 8 : 4;
}

template <typename TX, typename TR, typename TG, typename TN, int V>
cudaError_t launch_add_norm_bwd_v(const TX* x, const TR* residual, const float* weight,
                                  const TN* g_n, const TG* g_r, TX* dx, TR* dres,
                                  float* part, long long M, int D, float eps, int is_rms,
                                  const NormBwdPlan& p, cudaStream_t s) {
  if (p.stream) {
    add_norm_bwd_stream_kernel<TX, TR, TG, TN, V><<<p.blocks, p.threads, 0, s>>>(
        x, residual, weight, g_n, g_r, dx, dres, part, M, D, eps, is_rms);
  } else {
    const size_t smem = (size_t)norm_bwd_smem_floats(p.rows, p.threads, D) * sizeof(float);
    if (p.threads == 32) {
      add_norm_bwd_rows_kernel<TX, TR, TG, TN, V, 32><<<p.blocks, p.rows * 32, smem, s>>>(
          x, residual, weight, g_n, g_r, dx, dres, part, M, D, 32, eps, is_rms);
    } else {
      add_norm_bwd_rows_kernel<TX, TR, TG, TN, V, 0>
          <<<p.blocks, p.rows * p.threads, smem, s>>>(x, residual, weight, g_n, g_r, dx, dres,
                                                      part, M, D, p.threads, eps, is_rms);
    }
  }
  return cudaGetLastError();
}

// The row pass over M rows at plan p, then the ordered sum of its partials
// (part holds p.blocks x 2 x D floats) into dweight and dbias (may be
// null). p.vec must be 1 or the types' vector width, divide D, and every
// row array (and weight) must start on a vector boundary; else
// cudaErrorInvalidValue and nothing runs.
template <typename TX, typename TR, typename TG, typename TN = TX>
cudaError_t launch_add_norm_bwd(const TX* x, const TR* residual, const float* weight,
                                const TN* g_n, const TG* g_r, TX* dx, TR* dres,
                                float* dweight, float* dbias, float* part, long long M, int D,
                                float eps, int is_rms, const NormBwdPlan& p, cudaStream_t s) {
  if (M == 0) return cudaSuccess;
  constexpr int kV = norm_bwd_vec<TX, TR, TG, TN>();
  const bool fits = p.vec == 1 ||
      (p.vec == kV && D % kV == 0 && aligned_to(x, kV * sizeof(TX)) &&
       aligned_to(dx, kV * sizeof(TX)) && aligned_to(residual, kV * sizeof(TR)) &&
       aligned_to(dres, kV * sizeof(TR)) && aligned_to(g_n, kV * sizeof(TN)) &&
       aligned_to(g_r, kV * sizeof(TG)) && aligned_to(weight, 16) && aligned_to(part, 16));
  const long long slots = p.vec > 0 ? norm_bwd_row_elems(p.vec) / p.vec : 0;
  const bool shape = p.threads >= 32 && p.threads % 32 == 0 && p.threads <= kNormBwdMaxThreads &&
                     p.blocks >= 1 && p.rows >= 1 &&
                     (p.stream ? p.rows == 1
                               : (long long)p.threads * slots * p.vec >= D &&
                                     p.rows * p.threads <= kNormBwdMaxThreads &&
                                     norm_bwd_smem_floats(p.rows, p.threads, D) <=
                                         kNormBwdSmemFloats);
  if (!fits || !shape) return cudaErrorInvalidValue;
  cudaError_t err;
  if (p.vec == 1) {
    err = launch_add_norm_bwd_v<TX, TR, TG, TN, 1>(x, residual, weight, g_n, g_r, dx, dres, part,
                                                   M, D, eps, is_rms, p, s);
  } else {
    err = launch_add_norm_bwd_v<TX, TR, TG, TN, kV>(x, residual, weight, g_n, g_r, dx, dres,
                                                    part, M, D, eps, is_rms, p, s);
  }
  if (err != cudaSuccess) return err;
  const long long cols = 2LL * D;
  add_norm_bwd_sum_kernel<<<(unsigned)((cols + kNormBwdSumCols - 1) / kNormBwdSumCols),
                            kNormBwdSumCols * kNormBwdSumSlices, 0, s>>>(part, p.blocks, D,
                                                                         dweight, dbias);
  return cudaGetLastError();
}

}  // namespace vmt
