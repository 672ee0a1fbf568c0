// Fused Mamba-1 mixer core for Hopper: everything between in_proj and
// out_proj.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/mixer_fused.py
// (mixer_fused_pallas -> _mixer_fused_jit -> _mixer_kernel /
// _mixer_kernel_pipelined):
//   conv_out = silu(causal depthwise conv over [conv_state[..., 1:] || x] + b)
//   x_dbl    = conv_out @ W_x^T                     (dt | B | C columns)
//   delta    = x_dbl[:, :R] @ W_dt^T
//   y, h     = selective scan walk (softplus(delta + dt_bias), D-skip,
//              silu(z) gate), the walk of scan_walk.cuh
//
// On the TPU one kernel holds all of this, because the x_proj contraction
// crosses every channel while the walk is parallel over channels and VMEM
// holds a whole time block of both. On Hopper a block sees 227 KB of shared
// memory, so the span runs as four launches on one stream: conv, two
// products, walk. conv_out, x_dbl and delta make one round trip through
// device memory each (about 20 MB at VideoMamba-Base, batch 1).
//
// What bounds it on the H100: the walk, which is latency-bound at batch 1
// (see selective_scan.cu). The products are small (0.2 GFLOP each at Base)
// and run as plain fp32 FMA tiles; the conv is one memory pass. The conv and
// the tiles are in mixer_parts.cuh, shared with the whole-block kernel.
#include "mixer_parts.cuh"
#include "scan_walk.cuh"

// x, z: (batch, L, Di) rows of stride ld_x / ld_z; conv_state (batch, Di, W),
// conv_w (Di, W), conv_b (Di,), x_proj_w (R + 2N, Di), dt_proj_w (Di, R),
// dt_bias, Dskip (Di,), A (Di, N), h0 / h_last (batch, Di, N), y (batch, L,
// Di): all fp32 and contiguous. conv_out and delta (batch * L * Di) and x_dbl
// (batch * L * (R + 2N)) are fp32 scratch the caller allocates.
extern "C" int vmt_mixer_fused(
    const float* x, long long ld_x, const float* z, long long ld_z,
    const float* conv_state, const float* conv_w, const float* conv_b,
    const float* x_proj_w, const float* dt_proj_w, const float* dt_bias,
    const float* A, const float* Dskip, const float* h0, float* y,
    float* h_last, float* conv_out, float* x_dbl, float* delta, int batch,
    int L, int Di, int W, int R, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)batch * L;
  const int P = R + 2 * N;

  err = vmt::conv_silu<float>(x, ld_x, conv_state, conv_w, conv_b, conv_out,
                              batch, L, Di, W, s);
  if (err != cudaSuccess) return (int)err;

  err = vmt::gemm_nt(conv_out, Di, x_proj_w, Di, x_dbl, P, (int)rows, P, Di, s);
  if (err != cudaSuccess) return (int)err;
  err = vmt::gemm_nt(x_dbl, P, dt_proj_w, R, delta, Di, (int)rows, Di, R, s);
  if (err != cudaSuccess) return (int)err;

  vmt::ScanArgs a;
  a.u = conv_out;
  a.ld_u = Di;
  a.delta = delta;
  a.ld_delta = Di;
  a.z = z;
  a.ld_z = ld_z;
  a.B = x_dbl + R;
  a.ld_B = P;
  a.C = x_dbl + R + N;
  a.ld_C = P;
  a.A = A;
  a.Dskip = Dskip;
  a.delta_bias = dt_bias;
  a.h0 = h0;
  a.y = y;
  a.ld_y = Di;
  a.h_last = h_last;
  a.L = L;
  a.D = Di;
  a.softplus = 1;
  return (int)vmt::launch_scan_walk(a, batch, N, s);
}
