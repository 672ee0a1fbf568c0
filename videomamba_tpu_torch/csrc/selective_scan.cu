// Selective scan (Mamba-1 S6 recurrence) for Hopper.
//
// Replaces the Pallas kernel videomamba_tpu/ops/pallas/scan.py
// (scan_chunked_pallas -> _scan_kernel). The walk is the time-split walk of
// scan_walk_split.cuh, which K3 and K4 share: chunk states, a pass over the
// chunks, the output walk, with the gate (z) and softplus of dt as template
// arguments, since K1 also takes no gate and a raw dt.
//
// What bounds it on the H100 (Base, batch 1, L 1569, Di 1536, N 16, fp32):
// bytes, about 39 MB (u, delta, z read and y written once; B, C, the chunk
// states and the checkpoints are small), 0.0117 ms at 3.35 TB/s. A walk
// over all of time runs ceil(D / 128) x batch blocks (12 at Base, batch 1,
// on a 132-SM card), each step's dependent exp and FMA chain waiting out its
// full latency L times; cutting time into chunks (ops/kernels/scan.py
// walk_chunk) puts 600 blocks on the card, and the walk then waits on each
// step's chain and on the exps of its two passes over time.
//
// u, delta, z, B, C and y share one dtype (fp32, or bf16 widened on load and
// y rounded once on store; the bf16 walk is compiled in
// selective_scan_bf16.cu); with ckpt non-null the segment-start states are
// stored for the backward (selective_scan_bwd.cu). states and dtsum are the
// split walk's scratch (SplitArgs), allocated by the wrapper.
#include "scan_walk_split.cuh"

// bf16 is instantiated in selective_scan_bf16.cu.
extern template cudaError_t vmt::selective_scan_walk<vmt::bf16>(const vmt::ScanArgs&,
                                                                const vmt::SplitArgs&, int, int,
                                                                cudaStream_t);
template cudaError_t vmt::selective_scan_walk<float>(const vmt::ScanArgs&, const vmt::SplitArgs&,
                                                     int, int, cudaStream_t);

extern "C" int vmt_selective_scan(
    const void* u, long long ld_u, const void* delta, long long ld_delta,
    const void* z, long long ld_z, const void* Bm, long long ld_B,
    const void* Cm, long long ld_C, const float* A, const float* Dskip,
    const float* delta_bias, const float* h0, void* y, long long ld_y,
    float* h_last, float* ckpt, float* states, float* dtsum, int chunk, int batch, int L,
    int D, int N, int softplus, int is_bf16, int device, void* stream) {
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
  const vmt::SplitArgs s{states, dtsum, chunk};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? vmt::selective_scan_walk<vmt::bf16>(a, s, batch, N, st)
                       : vmt::selective_scan_walk<float>(a, s, batch, N, st));
}
