// Backward of the residual add + RMSNorm / LayerNorm row kernel, shared by
// K8 (fused_add_norm_bwd.cu) and the last launches of K7 (block_bwd.cu).
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
// Layout: one warp per row, as in the forward (add_norm.cuh); a block of up
// to kNormWarps warps walks rows with a grid stride. Each warp keeps its row
// (r, then g, then dc) and its own dweight / dbias sums in shared memory, so
// x, the residual and g are read once and dx, dresidual written once; a row
// too wide for that (D > 14528) is read again for each pass instead. The
// warps' sums are added in a fixed order into one partial row per block, and
// a second launch sums the blocks' partials in order: no floating-point
// atomics, so repeated runs are bit-identical.
#pragma once

#include "add_norm.cuh"

namespace vmt {

constexpr int kNormBwdMaxBlocks = 4 * 132;

__host__ __device__ inline int norm_bwd_blocks(long long M) {
  const long long want = (M + kNormWarps - 1) / kNormWarps;
  return (int)(want < kNormBwdMaxBlocks ? (want > 0 ? want : 1) : kNormBwdMaxBlocks);
}

// g_n is the cotangent of the normed output, in TN (x's dtype for K8, fp32
// for K7); g_r the cotangent of the returned residual (TG), may be null.
// blockDim.x / 32 rows a block. With kStream (a row whose four fp32 arrays
// do not fit in shared memory) the block is one warp: r and g are
// recomputed from device memory in each pass, in the same order (so the
// same bits), and the dweight / dbias sums accumulate in the block's own
// partial row of part.
template <typename TX, typename TR, typename TG, typename TN = TX, bool kStream = false>
__global__ void __launch_bounds__(kNormWarps * 32) add_norm_bwd_kernel(
    const TX* __restrict__ x, const TR* __restrict__ residual,
    const float* __restrict__ weight, const TN* __restrict__ g_n,
    const TG* __restrict__ g_r, TX* __restrict__ dx, TR* __restrict__ dres,
    float* __restrict__ part, long long M, int D, float eps, int is_rms) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* r = smem + (long long)warp * 4 * D;
  float* g = r + D;
  float* accw = kStream ? part + (long long)blockIdx.x * 2 * D : g + D;
  float* accb = accw + D;
  for (int i = lane; i < D; i += 32) {
    accw[i] = 0.f;
    accb[i] = 0.f;
  }
  const float inv_d = 1.f / (float)D;
  for (long long row = (long long)blockIdx.x * warps + warp; row < M;
       row += (long long)gridDim.x * warps) {
    const TX* xr = x + row * D;
    const TR* rr = residual ? residual + row * D : nullptr;
    auto load = [&](int i) { return rr ? to_f32(xr[i]) + to_f32(rr[i]) : to_f32(xr[i]); };
    float s = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float v = load(i);
      if constexpr (!kStream) r[i] = v;
      s += is_rms ? v * v : v;
    }
    s = warp_sum(s);
    float inv, mean = 0.f;
    if (is_rms) {
      inv = 1.f / sqrtf(s * inv_d + eps);
    } else {
      mean = s * inv_d;
      float s2 = 0.f;
      for (int i = lane; i < D; i += 32) {
        const float c = (kStream ? load(i) : r[i]) - mean;
        if constexpr (!kStream) r[i] = c;  // r now holds cen
        s2 += c * c;
      }
      inv = 1.f / sqrtf(warp_sum(s2) * inv_d + eps);
    }
    // cen (the row itself under RMSNorm), from shared memory or recomputed.
    auto cen = [&](int i) {
      if constexpr (kStream) {
        return is_rms ? load(i) : load(i) - mean;
      } else {
        return r[i];
      }
    };
    const TN* gr = g_n + row * D;
    float dot = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float gv = to_f32(gr[i]);
      const float v = cen(i);
      accw[i] += gv * (v * inv);
      accb[i] += gv;
      const float dn = gv * weight[i];
      if constexpr (!kStream) g[i] = dn;
      dot += dn * v;
    }
    dot = warp_sum(dot);
    const float coef = inv * inv * inv * dot * inv_d;
    // dn, then under LayerNorm dc, from shared memory or recomputed.
    auto dn_at = [&](int i) {
      if constexpr (kStream) {
        return to_f32(gr[i]) * weight[i];
      } else {
        return g[i];
      }
    };
    float mean_dc = 0.f;
    if (!is_rms) {
      float sdc = 0.f;
      for (int i = lane; i < D; i += 32) {
        const float dc = dn_at(i) * inv - cen(i) * coef;
        if constexpr (!kStream) g[i] = dc;
        sdc += dc;
      }
      mean_dc = warp_sum(sdc) * inv_d;
    }
    const TG* grr = g_r ? g_r + row * D : nullptr;
    TX* dxr = dx + row * D;
    TR* drr = dres ? dres + row * D : nullptr;
    for (int i = lane; i < D; i += 32) {
      float dr;
      if (is_rms) {
        dr = dn_at(i) * inv - cen(i) * coef;
      } else if constexpr (kStream) {
        dr = (dn_at(i) * inv - cen(i) * coef) - mean_dc;
      } else {
        dr = g[i] - mean_dc;
      }
      if (grr) dr += to_f32(grr[i]);
      dxr[i] = from_f32<TX>(dr);
      if (drr) drr[i] = from_f32<TR>(dr);
    }
  }
  if constexpr (kStream) return;  // the block's one warp summed into its own row
  __syncthreads();
  // Warps' sums in a fixed order: part[block][0][:] dweight, [1][:] dbias.
  float* pw = part + (long long)blockIdx.x * 2 * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float sw = 0.f, sb = 0.f;
    for (int w = 0; w < warps; ++w) {
      sw += smem[(long long)w * 4 * D + 2 * D + i];
      sb += smem[(long long)w * 4 * D + 3 * D + i];
    }
    pw[i] = sw;
    pw[D + i] = sb;
  }
}

// dweight, dbias (D,) = the blocks' partial rows summed in order; dbias may
// be null (RMSNorm).
static __global__ void add_norm_bwd_sum_kernel(const float* __restrict__ part,
                                               int blocks, int D,
                                               float* __restrict__ dw,
                                               float* __restrict__ db) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * D) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += part[(long long)b * 2 * D + e];
  if (e < D) {
    dw[e] = acc;
  } else if (db) {
    db[e - D] = acc;
  }
}

// The row pass over M rows and the ordered sum of its partials (part holds
// norm_bwd_blocks(M) x 2 x D floats). Any D: four rows a block up to
// D = 3632, fewer above (up to 227 KB of shared memory), one streamed row a
// block above 14528.
template <typename TX, typename TR, typename TG, typename TN = TX>
cudaError_t launch_add_norm_bwd(const TX* x, const TR* residual, const float* weight,
                                const TN* g_n, const TG* g_r, TX* dx, TR* dres,
                                float* dweight, float* dbias, float* part,
                                long long M, int D, float eps, int is_rms,
                                cudaStream_t s) {
  const int warps = norm_rows_per_block(D, 4);
  cudaError_t err;
  if (warps == 0) {
    add_norm_bwd_kernel<TX, TR, TG, TN, true><<<norm_bwd_blocks(M), 32, 0, s>>>(
        x, residual, weight, g_n, g_r, dx, dres, part, M, D, eps, is_rms);
  } else {
    const size_t smem = (size_t)warps * 4 * D * sizeof(float);
    err = cudaFuncSetAttribute(add_norm_bwd_kernel<TX, TR, TG, TN, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    add_norm_bwd_kernel<TX, TR, TG, TN, false><<<norm_bwd_blocks(M), warps * 32, smem, s>>>(
        x, residual, weight, g_n, g_r, dx, dres, part, M, D, eps, is_rms);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  add_norm_bwd_sum_kernel<<<(2 * D + 255) / 256, 256, 0, s>>>(part, norm_bwd_blocks(M), D,
                                                              dweight, dbias);
  return cudaGetLastError();
}

}  // namespace vmt
