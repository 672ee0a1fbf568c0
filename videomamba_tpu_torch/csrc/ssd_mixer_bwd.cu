// Mamba-2 (SSD) mixer backward for Hopper (K13): every gradient of K12's
// span (conv + SiLU over the [x B C] slab, the SSD chunk walk, the D skip,
// the silu(z) gate and the gated RMSNorm) from its checkpoints.
//
// Replaces the Pallas kernels videomamba_tpu/ops/pallas/ssd_scan.py
// (_ssd_mixer_bwd_padded -> _ssd_mixer_bwd_kernel per head, and
// _ssd_mixer_bwd_merged -> _ssd_mixer_bwd_merged_kernel). From the in_proj
// output zx, the forward's entry states hins and pre-gate y (yd), and the
// cotangent dout of the gated rows:
//   cy    = silu(conv over [window || raw x B C] + bias), recomputed (fp32)
//   gate  = yd silu(z); xn = gate r, r = rsqrt(mean(gate^2) + eps)
//   dnorm = sum_rows dout xn;  dgate = dxn r - gate r^3 / Di sum(dxn gate)
//   dyd   = dgate silu(z);     dz = dgate yd silu'(z);  dD = sum dyd x_f
//   dx, dB, dC, ds, ddt, dh0 = the reverse chunk walk (ssd_core_bwd.cu) at dy = dyd
//   dcpre = d[x B C] silu'(pre); draw, dconv_w, dconv_b, dconv_state from it
//   dzx   = [dz | draw | 0 in the dt columns], in zx's dtype
// as the TPU kernels compute them (fp32 throughout, the cotangents rounded
// once on the way out). dt's own gradient leaves through ddt: dt enters the
// span post-softplus, so softplus and dt_bias are autograd's, outside.
//
// Design. The TPU kernel walks the chunks in reverse with the state's
// cotangent in VMEM and every row's work in one grid step. Here the span is
// launches on one stream through fp32 scratch the caller allocates:
//   1. the conv + SiLU recompute (K12's launch 1, keeping the pre-SiLU sums);
//   2. the epilogue backward, a block for 16 rows (every head of a row, the
//      norm's sums across the block), with the dnorm and dD sums of its rows
//      as per-block partials;
//   3. the reverse chunk walk (ssd_core_bwd.cu, six launches: C B^T once a
//      group, then the per-head tiles on the slab product, mma.sync at bf16);
//   4. silu' of the conv, then the conv backward (K6's conv kernels,
//      mixer_bwd.cuh): draw, the window's gradient, and the taps' and bias'
//      gradients in ordered 256-row slices.
// The caller sums the per-block partials with torch in a fixed order: no
// atomics, so repeated runs give bit-identical gradients.
//
// What bounds it on the H100: the reverse walk's tile products (operations:
// fp32 FMA at fp32, bf16 tensor cores at bf16), then the row passes' bytes
// (about 0.4 GB at VideoMamba-Base-m2, B = 4).
#include "mixer_bwd.cuh"
#include "ssd_core_bwd.cuh"

namespace {

constexpr int kEpiThreads = 256;

// The sum of v over the block, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = vmt::warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < kEpiThreads / 32; ++w) tot += red[w];
  return tot;
}

// Launch 2: the gate and norm backward for kSsdEpiRows rows a block.
template <typename T, typename TD>
__global__ void __launch_bounds__(kEpiThreads) ssd_epilogue_bwd_kernel(vmt::SsdMixerBwdArgs a) {
  extern __shared__ float sm[];
  const int Di = a.H * a.P, CD = Di + 2 * a.G * a.N;
  float* acc_nw = sm;        // [Di]
  float* acc_dD = sm + Di;   // [Di]
  float* red = sm + 2 * Di;  // [warps]
  const long long rows = (long long)a.B * a.L;
  const long long r0 = (long long)blockIdx.x * vmt::kSsdEpiRows;
  const long long r1 = min(rows, r0 + vmt::kSsdEpiRows);
  for (int d = threadIdx.x; d < Di; d += kEpiThreads) {
    acc_nw[d] = 0.f;
    acc_dD[d] = 0.f;
  }
  for (long long r = r0; r < r1; ++r) {
    const T* zr = (const T*)a.zx + r * a.ld_zx;
    const TD* dr = (const TD*)a.dout + r * Di;
    const float* yr = a.yd + r * Di;
    float inv = 1.f, dot = 0.f;
    if (a.norm_w) {
      float ss = 0.f, dd = 0.f;
      for (int d = threadIdx.x; d < Di; d += kEpiThreads) {
        const float z = vmt::to_f32(zr[d]);
        const float gate = yr[d] * (z / (1.f + expf(-z)));
        ss += gate * gate;
        dd += vmt::to_f32(dr[d]) * a.norm_w[d] * gate;
      }
      inv = rsqrtf(block_sum(ss, red) / (float)Di + a.eps);
      dot = block_sum(dd, red);
    }
    T* dzr = (T*)a.dzx + r * a.ld_dzx;
    for (int d = threadIdx.x; d < Di; d += kEpiThreads) {
      const float z = vmt::to_f32(zr[d]);
      const float sig = 1.f / (1.f + expf(-z));
      const float silu = z * sig;
      const float gate = yr[d] * silu;
      const float dout = vmt::to_f32(dr[d]);
      float dgate = dout;
      if (a.norm_w) {
        acc_nw[d] += dout * (gate * inv);
        dgate = dout * a.norm_w[d] * inv - gate * (inv * inv * inv / (float)Di) * dot;
      }
      const float dyd = dgate * silu;
      a.dyd[r * Di + d] = dyd;
      acc_dD[d] += dyd * a.cy[r * CD + d];
      dzr[d] = vmt::from_f32<T>(dgate * yr[d] * (sig * (1.f + z * (1.f - sig))));
    }
    for (int j = threadIdx.x; j < a.zero_cols; j += kEpiThreads)
      dzr[Di + CD + j] = vmt::from_f32<T>(0.f);
  }
  for (int d = threadIdx.x; d < Di; d += kEpiThreads) {
    a.part_nw[(long long)blockIdx.x * Di + d] = acc_nw[d];
    a.part_dD[(long long)blockIdx.x * Di + d] = acc_dD[d];
  }
}

// dcpre = d[x B C] silu'(pre), in place.
__global__ void dsilu_kernel(float* __restrict__ g, const float* __restrict__ pre,
                             long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) g[i] *= dsilu(pre[i]);
}

}  // namespace

namespace vmt {

template <typename T>
cudaError_t ssd_mixer_bwd(const SsdMixerBwdArgs& a, cudaStream_t s) {
  const int Di = a.H * a.P, CD = Di + 2 * a.G * a.N;
  const long long rows = (long long)a.B * a.L;
  cudaError_t err = conv_silu<T, float>((const T*)a.zx + Di, a.ld_zx, a.conv_state, a.conv_w,
                                        a.conv_b, a.cy, a.B, a.L, CD, a.W, s, a.cpre);
  if (err != cudaSuccess) return err;
  const unsigned epi_blocks = (unsigned)((rows + kSsdEpiRows - 1) / kSsdEpiRows);
  const size_t epi_smem = sizeof(float) * (2 * (size_t)Di + kEpiThreads / 32);
  if (a.dout_f32) {
    if ((err = cudaFuncSetAttribute(ssd_epilogue_bwd_kernel<T, float>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)epi_smem)) != cudaSuccess)
      return err;
    ssd_epilogue_bwd_kernel<T, float><<<epi_blocks, kEpiThreads, epi_smem, s>>>(a);
  } else {
    if ((err = cudaFuncSetAttribute(ssd_epilogue_bwd_kernel<T, T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)epi_smem)) != cudaSuccess)
      return err;
    ssd_epilogue_bwd_kernel<T, T><<<epi_blocks, kEpiThreads, epi_smem, s>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const SsdBwdArgs core{a.cy, a.dyd, a.s, a.dt, a.hins, a.dhlast, a.Dskip, a.g, a.dxbc,
                        a.dbh, a.dch, a.dsq, a.dsk, a.ddt, a.dslast, a.dh0, a.cb,
                        a.B, a.L, a.Q, a.H, a.P, a.G, a.N};
  if ((err = ssd_bwd_core<T>(core, s)) != cudaSuccess) return err;
  const long long count = rows * CD;
  dsilu_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(a.dxbc, a.cpre, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 dx_grid((unsigned)(((long long)a.L * CD + 255) / 256), a.B);
  conv_dx_kernel<T, float><<<dx_grid, 256, 0, s>>>(a.dxbc, a.conv_w, (T*)a.dzx + Di, a.ld_dzx,
                                                   a.L, CD, a.W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_dstate_kernel<float><<<(unsigned)(((long long)a.B * CD + 255) / 256), 256, 0, s>>>(
      a.dxbc, a.conv_w, a.dconv_state, a.B, a.L, CD, a.W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int slices = tn_slices(rows);
  conv_dw_kernel<T><<<dim3((CD + 255) / 256, slices), 256, 0, s>>>(
      a.dxbc, (const T*)a.zx + Di, a.ld_zx, a.conv_state, a.conv_part, a.B, a.L, CD, a.W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_dw_sum_kernel<<<(unsigned)(((long long)(a.W + 1) * CD + 255) / 256), 256, 0, s>>>(
      a.conv_part, slices, CD, a.W, a.dconv_w, a.dconv_b);
  return cudaGetLastError();
}

template cudaError_t ssd_mixer_bwd<float>(const SsdMixerBwdArgs&, cudaStream_t);
template cudaError_t ssd_mixer_bwd<bf16>(const SsdMixerBwdArgs&, cudaStream_t);

}  // namespace vmt

// zx (B * L rows of ld_zx) and dout (B, L, H P): fp32 or bf16 (is_bf16);
// dzx (B * L rows of ld_dzx) in that dtype gets [dz | d[x B C] | H zeros].
// conv_state (B, CD, W) rounded to that dtype, conv_w (CD, W), conv_b (CD,),
// s and dt (B, Lp, H), Dskip (H,), norm_w (H P,) or null, hins (B, nc, H, P,
// N), yd (B, L, H P), dhlast (B, H, P, N) or null: fp32, contiguous. Writes
// dh0, dconv_state (B, CD, W), dconv_w, dconv_b, the per-block partials of
// dnorm_w and of dyd x (ceil(B L / 16), H P), and the scan's dsq, dsk, ddt
// (B, Lp, H) and dslast (B, nc, ceil(Q / 64), H). Scratch (fp32): cy, cpre
// and dxbc B L CD, dyd B L H P, g B nc H P N, dbh and dch B L H N, conv_part
// ceil(B L / 256) (W + 1) CD, cb B nc G Q Q.
extern "C" int vmt_ssd_mixer_bwd(
    const void* zx, long long ld_zx, const void* dout, void* dzx, long long ld_dzx,
    const float* conv_state, const float* conv_w, const float* conv_b, const float* s,
    const float* dt, const float* Dskip, const float* norm_w, const float* hins,
    const float* yd, const float* dhlast, float* dh0, float* dconv_state, float* dconv_w,
    float* dconv_b, float* part_nw, float* part_dD, float* cy, float* cpre, float* dyd,
    float* dxbc, float* g, float* dbh, float* dch, float* dsq, float* dsk, float* ddt,
    float* dslast, float* conv_part, float* cb, int B, int L, int Q, int H, int P, int G,
    int N, int W, float eps, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vmt::SsdMixerBwdArgs a{zx, ld_zx, dout, 0, dzx, ld_dzx, H, conv_state, conv_w, conv_b,
                               s, dt, Dskip, norm_w, hins, yd, dhlast, dh0, dconv_state,
                               dconv_w, dconv_b, part_nw, part_dD, cy, cpre, dyd, dxbc, g,
                               dbh, dch, dsq, dsk, ddt, dslast, conv_part, cb,
                               B, L, Q, H, P, G, N, W, eps};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? vmt::ssd_mixer_bwd<vmt::bf16>(a, st)
                       : vmt::ssd_mixer_bwd<float>(a, st));
}
