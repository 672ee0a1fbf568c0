// Selective scan (Mamba-1 S6 recurrence) for Hopper.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/scan.py
// (scan_chunked_pallas -> _scan_kernel). The walk itself is in
// scan_walk.cuh; the fused mixer and the whole-block kernel walk with the
// time-split walk of scan_walk_split.cuh instead.
//
// What bounds it on the H100: the time walk is a serial chain of L steps per
// channel, so at batch 1 the kernel is latency-bound (grid ceil(D/128) x B:
// 12 blocks at VideoMamba-Base widths on a 132-SM card). Per step each
// thread does N exps and 2N FMAs; the bytes moved (u, delta, z, y once, B/C
// once per block) are far below the memory roofline. The design keeps the
// state in registers and stages each time tile's loads together, so the
// chain waits on arithmetic rather than on device memory.
//
// u, delta, z, B, C and y share one dtype (fp32, or bf16 widened on load and
// y rounded once on store); with ckpt non-null the segment-start states are
// stored for the backward (selective_scan_bwd.cu).
#include "scan_walk.cuh"

extern "C" int vmt_selective_scan(
    const void* u, long long ld_u, const void* delta, long long ld_delta,
    const void* z, long long ld_z, const void* Bm, long long ld_B,
    const void* Cm, long long ld_C, const float* A, const float* Dskip,
    const float* delta_bias, const float* h0, void* y, long long ld_y,
    float* h_last, float* ckpt, int batch, int L, int D, int N, int softplus,
    int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  vmt::ScanArgs a;
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
  a.A = A;
  a.Dskip = Dskip;
  a.delta_bias = delta_bias;
  a.h0 = h0;
  a.y = y;
  a.ld_y = ld_y;
  a.h_last = h_last;
  a.ckpt = ckpt;
  a.L = L;
  a.D = D;
  a.softplus = softplus;
  const cudaStream_t s = (cudaStream_t)stream;
  using bf = vmt::bf16;
  return (int)(is_bf16 ? vmt::launch_scan_walk_t<bf, bf, bf>(a, batch, N, s)
                       : vmt::launch_scan_walk_t<float, float, float>(a, batch, N, s));
}
