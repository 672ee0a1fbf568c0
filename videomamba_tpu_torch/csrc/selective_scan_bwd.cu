// Selective-scan backward (K5) for Hopper.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/scan.py
// (scan_bwd_pallas -> _scan_bwd_kernel): every gradient of the selective
// scan (du, ddelta, dA, dB, dC, dD, dz, dbias, dh0), rebuilt from the
// forward's segment checkpoints (selective_scan.cu with ckpt). Three launches
// on one stream: the reverse walk (scan_walk_bwd.cuh, which holds the math,
// the design and what bounds it), the channel-block sum of dB / dC, and the
// batch sum of dA / dD / dbias. No floating-point atomics: the sums run in a
// fixed order, so repeated runs are bit-identical.
//
// u, delta, z, B, C, g and du, ddelta, dz, dB, dC share one dtype (fp32, or
// bf16: inputs widened on load, gradients rounded once on store); A, D,
// delta_bias, the checkpoints, g_hlast, dA, dD, dbias and dh0 are fp32.
#include "scan_walk_bwd.cuh"

extern "C" int vmt_selective_scan_bwd(
    const void* u, long long ld_u, const void* delta, long long ld_delta,
    const void* z, long long ld_z, const void* Bm, long long ld_B,
    const void* Cm, long long ld_C, const void* g, long long ld_g,
    const float* A, const float* Dskip, const float* delta_bias,
    const float* ckpt, const float* g_hlast, void* du, void* ddelta, void* dz,
    void* dB, void* dC, float* dA, float* dD, float* dbias, float* dh0,
    float* bc_part, float* dA_part, float* dD_part, float* dbias_part,
    int batch, int L, int D, int N, int softplus, int is_bf16, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  vmt::ScanBwdArgs a;
  a.u = u;
  a.ld_u = ld_u;
  a.delta = delta;
  a.ld_delta = ld_delta;
  a.z = z;
  a.ld_z = ld_z;
  a.B = Bm;
  a.ld_B = ld_B;
  a.C = Cm;
  a.ld_C = ld_C;
  a.g = g;
  a.ld_g = ld_g;
  a.A = A;
  a.Dskip = Dskip;
  a.delta_bias = delta_bias;
  a.ckpt = ckpt;
  a.g_hlast = g_hlast;
  a.du = du;
  a.ld_du = D;
  a.ddelta = ddelta;
  a.ld_ddelta = D;
  a.dz = dz;
  a.ld_dz = D;
  a.bc_part = bc_part;
  a.dA_part = dA_part;
  a.dD_part = dD_part;
  a.dbias_part = dbias_part;
  a.dh0 = dh0;
  a.L = L;
  a.D = D;
  a.softplus = softplus;
  const cudaStream_t s = (cudaStream_t)stream;
  using bf = vmt::bf16;
  if (is_bf16) {
    err = vmt::launch_scan_bwd<bf, bf, bf>(a, batch, N, dA, dD, dbias, s);
    if (err != cudaSuccess) return (int)err;
    return (int)vmt::launch_reduce_bc<bf>(bc_part, batch, D, L, N, (bf*)dB, N,
                                          (bf*)dC, N, s);
  }
  err = vmt::launch_scan_bwd<float, float, float>(a, batch, N, dA, dD, dbias, s);
  if (err != cudaSuccess) return (int)err;
  return (int)vmt::launch_reduce_bc<float>(bc_part, batch, D, L, N, (float*)dB,
                                           N, (float*)dC, N, s);
}
