// Selective-scan backward (K5) for Hopper.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/scan.py
// (scan_bwd_pallas -> _scan_bwd_kernel): every gradient of the selective
// scan (du, ddelta, dA, dB, dC, dD, dz, dbias, dh0), rebuilt from the
// forward's segment checkpoints (selective_scan.cu with ckpt). The walk is
// the time-split reverse walk of scan_walk_split_bwd.cuh, which K6 and K7
// share (the math and the reductions are scan_walk_bwd.cuh's), with the gate
// and softplus of dt as template arguments: chunk cotangents, a reverse pass
// over the chunks, the output walk, the sum of the dA / dD / dbias partial
// rows, then the channel-block sum of dB / dC. No floating-point atomics:
// the sums run in a fixed order, so repeated runs are bit-identical.
//
// What bounds it on the H100 (Base, batch 1, L 1569, Di 1536, N 16, fp32):
// bytes, about 78 MB (u, delta, z, g read; du, ddelta, dz written; the
// checkpoints and the per-channel-block dB / dC partials), 0.0233 ms at
// 3.35 TB/s. A walk over all of time runs ceil(D / 64) x batch blocks (24
// at Base, batch 1), each step waiting out two dependent chains L times;
// chunks of time (ops/kernels/scan.py walk_bwd_chunk) put ceil(D / 64) x
// nchunks blocks on the card, and the walk then waits on its exps (about
// 3.5 B L D N: rebuild 1.5, reverse 1, chunk cotangents 1) and occupancy.
//
// u, delta, z, B, C, g and du, ddelta, dz, dB, dC share one dtype (fp32, or
// bf16: inputs widened on load, gradients rounded once on store; the bf16
// walk is compiled in selective_scan_bwd_bf16.cu); A, D, delta_bias, the
// checkpoints, g_hlast, dA, dD, dbias, dh0 and the scratch are fp32. carry
// (batch, nchunks - 1, D, N) and dtsum (batch, nchunks - 1, D) are the split
// walk's scratch (SplitBwdArgs); dA_part (batch, nchunks, D, N), dD_part and
// dbias_part (batch, nchunks, D) its partial rows.
#include "scan_walk_split_bwd.cuh"

// bf16 is instantiated in selective_scan_bwd_bf16.cu.
extern template cudaError_t vmt::selective_scan_bwd_walk<vmt::bf16>(
    const vmt::ScanBwdArgs&, const vmt::SplitBwdArgs&, int, int, float*, float*, float*,
    vmt::bf16*, vmt::bf16*, cudaStream_t);
template cudaError_t vmt::selective_scan_bwd_walk<float>(const vmt::ScanBwdArgs&,
                                                         const vmt::SplitBwdArgs&, int, int,
                                                         float*, float*, float*, float*, float*,
                                                         cudaStream_t);

extern "C" int vmt_selective_scan_bwd(
    const void* u, long long ld_u, const void* delta, long long ld_delta,
    const void* z, long long ld_z, const void* Bm, long long ld_B,
    const void* Cm, long long ld_C, const void* g, long long ld_g,
    const float* A, const float* Dskip, const float* delta_bias,
    const float* ckpt, const float* g_hlast, void* du, void* ddelta, void* dz,
    void* dB, void* dC, float* dA, float* dD, float* dbias, float* dh0,
    float* bc_part, float* dA_part, float* dD_part, float* dbias_part,
    float* carry, float* dtsum, int chunk, int batch, int L, int D, int N, int softplus,
    int is_bf16, int device, void* stream) {
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
  const vmt::SplitBwdArgs sp{carry, dtsum, chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? vmt::selective_scan_bwd_walk<vmt::bf16>(
                             a, sp, batch, N, dA, dD, dbias, (vmt::bf16*)dB, (vmt::bf16*)dC, s)
                       : vmt::selective_scan_bwd_walk<float>(a, sp, batch, N, dA, dD, dbias,
                                                             (float*)dB, (float*)dC, s));
}
