// One decode token through the whole layer stack for Hopper: Mamba-1 (K9)
// and, further down, Mamba-2 (K15), each one persistent launch a token.
//
// Replaces the Pallas kernels videomamba_tpu/ops/pallas/decode_step.py
// (decode_stack_pallas -> _decode_kernel, decode_stack_pallas_m2 ->
// _decode_kernel_m2). Per Mamba-1 layer k, for a token (B, E):
//   residual' = hidden + residual                          fp32
//   normed    = rms / layer norm(residual'), rounded to the weight dtype
//   xz        = normed Win_k^T; x_raw, z = split           fp32
//   x         = silu(conv over [conv_state_k[1:] || x_raw] + b); the window
//               rolls to [conv_state_k[1:] || x_raw]
//   x_dbl     = x Wx_k^T;  dt = softplus(x_dbl[:R] Wdt_k^T + dt_bias)
//   h_k       = exp(dt A) h_k + dt x B;  y = (C h_k + D x) silu(z)
//   hidden    = y Wout_k^T                                  fp32
// With bf16 weights every product's input (normed, x, x_dbl, y) is rounded
// to bf16 and the sum is fp32 (decode_step.py:134-184); fp32 weights take
// fp32 products. The states are stored in their own dtype; hidden and the
// residual stay fp32 for the model's final norm.
//
// What the trace showed (scripts/compare_m2_serving.py --model decode on
// the earlier design of four launches a layer, H100): not device memory.
// At B = 1 the host took 0.6 ms to submit a token's 96 launches, each launch
// waited for the one before it to drain before it loaded a weight, x_proj
// and dt_proj ran on 10 and 12 blocks, and at B = 80 every weight was walked
// once per 8 batch rows with serial sums (57x the byte bound).
//
// Design. One cooperative launch a token, one block of 256 threads on each
// SM. A layer is four phases (K15: three) separated by a grid barrier
// (decode_persist.cuh): in (norm + in_proj + conv), x_proj, state (dt_proj +
// the state update + gate) and out (out_proj, plus the residual add for the
// next layer). Each block owns a fixed slice of every phase: balanced row
// ranges of in_proj and out_proj, units of x_proj rows (8, or 2 above 16
// batch rows) by a piece of its K (the pieces' partial sums are added in
// piece order by the state phase), groups of 8 channels (K15: 4 (head, p)
// rows) for the state. Weights never wait on activations: while one thread
// of the block waits at the barrier that ends phase p, the other warps
// issue cp.async copies of the block's slice of phase p + 2's weights into
// the end of its weight area that phase p used (with the first tile's
// states, A, D, dt_bias and R_k for the state and out phases, and L2
// prefetches of the conv's operands), so a slice streams in under two
// barriers and the phase between; the copies' issue cost hides under the
// barrier. Activations (written by other SMs) come in by bulk copy (TMA,
// completion on an mbarrier) in batch tiles of up to 16 rows, and every
// weight in shared memory is used for every row of the tile: each weight
// crosses device memory once a token at any batch. The sums are fp32 FMA
// register tiles, or for bf16 weights from the plan's batch size on
// mma.sync.m16n8k16 (weight rows M, batch rows N). The host validates,
// plans (ops/kernels/decode_step.py decode_plan) and allocates once per
// session and submits one launch a token.
//
// Residual: R_0 = token and R_{k+1} = out_k + R_k; layer k normalises R_k,
// which lives in res[(k + 1) % 2] (the in phase of layer 0 copies the token
// there), the out phase of layer k < K - 1 writes R_{k+1} to res[k % 2] and
// the last one writes its sums to hid. So the final residual is in
// res[K % 2] and every value has one writer.
#include <string.h>

#include "decode_persist.cuh"
#include "scan_walk.cuh"

namespace {

using vmt::bf16;
namespace dec = vmt::dec;

// The schedule ops/kernels/decode_step.py decode_plan computes; the same
// order as its PLAN_FIELDS.
struct Plan {
  int bt;        // batch tile: rows staged per pass (a template argument too)
  int wtot;      // bytes of the two weight regions
  int off_act, off_red, off_res, off_misc, off_bar, smem;  // shared memory layout, bytes
  int lda;       // staged activation row stride, floats
  int in_rb, in_rw, in_mma;  // in_proj: warps' row blocks, rows a warp, mma
  int xp_kp, xp_kw, xp_rb, xp_rw;  // x_proj (K9): K pieces, their width, warps
  int out_rb, out_rw, out_mma;
  int in_cap, out_cap;  // rows of in_proj / out_proj a block holds at once
  int xp_rg;             // x_proj (K9): rows a unit
};
constexpr int kPlanInts = 22;

template <typename TW>
__host__ __device__ constexpr int row_pad() {
  return dec::kRowPad / (int)sizeof(TW);
}

__device__ __forceinline__ int up4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ char* region(char* smem, const Plan& pl, int gp, int bytes) {
  return (gp & 1) ? smem + pl.wtot - bytes : smem;
}

__device__ __forceinline__ float silu(float v) { return v * (1.f / (1.f + expf(-v))); }

// A later piece of a slice larger than its region (shapes far above the
// presets'): copied once the previous piece is used, and waited for.
template <typename TW>
__device__ void load_piece(TW* wsm, const TW* src, int rows, int K) {
  __syncthreads();
  dec::copy_rows((char*)wsm, (const char*)src, rows, K * (int)sizeof(TW),
                 (long long)K * sizeof(TW), K * (int)sizeof(TW) + dec::kRowPad);
  dec::cp_commit();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Shared memory, the activation copies' transaction barrier and each
// thread's view of its phase, and whether the current phase's weights
// (a cp.async group) have been waited for.
struct Block {
  float* act;
  float* red;
  float* res;
  float* misc;
  uint64_t* bar;
  unsigned parity;
  bool waited;
};

__device__ __forceinline__ Block make_block(char* smem, const Plan& pl) {
  uint64_t* bar = (uint64_t*)(smem + pl.off_bar);
  dec::mbar_init(bar);
  return Block{(float*)(smem + pl.off_act), (float*)(smem + pl.off_red),
               (float*)(smem + pl.off_res), (float*)(smem + pl.off_misc), bar, 0u, false};
}

// Wait (once a phase) until the current phase's weights have landed: the
// next phase's group may stay in flight.
__device__ __forceinline__ void wait_weights(Block& blk) {
  if (blk.waited) return;
  dec::cp_wait_prev();
  __syncthreads();
  blk.waited = true;
}

// The in phase's epilogue for one (row j, batch row b): rows j in [conv_lo,
// conv_lo + C) are conv channels: the conv into cy (rows ld_cy apart) and
// the window (B, C, W) rolled; every other row's sum goes to raw[b * ld_raw
// + j - raw_off].
template <typename TW>
__device__ __forceinline__ void in_epilogue(float acc, int j, long long b, int conv_lo, int C,
                                            int W, const TW* conv_w, const float* conv_b,
                                            void* conv_state, int s_bf16, float* cy, int ld_cy,
                                            float* raw, int ld_raw, int raw_off) {
  const int ch = j - conv_lo;
  if (ch < 0 || ch >= C) {
    raw[b * ld_raw + (j - raw_off)] = acc;
    return;
  }
  const TW* cw = conv_w + (long long)ch * W;
  const long long cs = (b * C + ch) * W;
  // The TPU kernel's order: window taps 1 .. W-1 oldest first, x_raw last.
  float c = W > 1 ? dec::ld_state(conv_state, cs + 1, s_bf16) * vmt::to_f32(cw[0])
                  : acc * vmt::to_f32(cw[0]);
#pragma unroll 4
  for (int w = 1; w < W; ++w) {
    const float tap = w == W - 1 ? acc : dec::ld_state(conv_state, cs + w + 1, s_bf16);
    c += tap * vmt::to_f32(cw[w]);
  }
  c += conv_b[ch];
  cy[b * ld_cy + ch] = silu(c);
#pragma unroll 4
  for (int w = 0; w < W - 1; ++w)
    dec::st_state(conv_state, cs + w, dec::ld_state(conv_state, cs + w + 1, s_bf16), s_bf16);
  dec::st_state(conv_state, cs + W - 1, acc, s_bf16);
}

// The in phase: each batch tile of R_k staged and normed (layer 0 also
// copies the token to res_out, its columns), the block's rows [lo, hi) of
// in_proj (in shared memory at wsm), then in_epilogue. Shared by K9 and K15.
template <typename TW, int BT>
__device__ void in_phase(Block& blk, const Plan& pl, TW* wsm, const TW* in_w, int lo, int hi,
                         int B, int E, int En, const float* src, float* res_out,
                         const float* norm_w,
                         const float* norm_b, float eps, int is_rms, int conv_lo, int C, int W,
                         const TW* conv_w, const float* conv_b, void* conv_state, int s_bf16,
                         float* cy, int ld_cy, float* raw, int ld_raw, int raw_off) {
  int e_lo, e_hi;
  dec::block_span(E, e_lo, e_hi);
  const int rows = hi - lo;
  if (rows <= 0) {  // a block with no rows still copies its columns of the token
    if (res_out)
      for (int i = threadIdx.x; i < B * (e_hi - e_lo); i += dec::kThreads) {
        const long long at = (long long)(i / (e_hi - e_lo)) * E + e_lo + i % (e_hi - e_lo);
        res_out[at] = src[at];
      }
    return;
  }
  for (int p0 = lo; p0 < hi; p0 += pl.in_cap) {  // one piece unless the slice is too large
    const int np = min(pl.in_cap, hi - p0);
    if (p0 > lo) load_piece(wsm, in_w + (long long)p0 * E, np, E);
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      dec::stage_act<TW>(blk.act, pl.lda, BT, b0, nb, E, src, E, 0, is_rms ? 1 : 2, En,
                         norm_w, norm_b, eps, blk.misc, p0 == lo ? res_out : nullptr, e_lo,
                         e_hi, blk.bar, blk.parity);
      wait_weights(blk);
      dec::gemv<TW, BT>(wsm, E + row_pad<TW>(), np, blk.act, pl.lda, E, pl.in_rb, pl.in_rw,
                        pl.in_mma, blk.red, blk.res);
      for (int i = threadIdx.x; i < np * nb; i += dec::kThreads) {
        const int r = i / nb, bb = i - r * nb;
        in_epilogue<TW>(blk.res[r * BT + bb], p0 + r, b0 + bb, conv_lo, C, W, conv_w, conv_b,
                        conv_state, s_bf16, cy, ld_cy, raw, ld_raw, raw_off);
      }
    }
  }
}

// The out phase over staged rows of src (B, K) fp32, optionally normed (RMS
// with weight nw: K15's gated norm): the block's rows [lo, hi) of out_proj
// at wsm; row m's sum s goes to rnext[b, m] = s + rcur[b, m] (R_{k+1}), or,
// at the last layer (rcur null), to hid[b, m]. The first tile's rcur
// columns [lo & ~3, up4(hi)) came with the weights, to rsm.
template <typename TW, int BT>
__device__ void out_phase(Block& blk, const Plan& pl, TW* wsm, const TW* w, int lo, int hi,
                          int B, int E, int K, const float* src, const float* nw, float eps,
                          const float* rcur, const float* rsm, float* rnext, float* hid) {
  for (int p0 = lo; p0 < hi; p0 += pl.out_cap) {  // one piece unless the slice is too large
    const int np = min(pl.out_cap, hi - p0);
    if (p0 > lo) load_piece(wsm, w + (long long)p0 * K, np, K);
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      dec::stage_act<TW>(blk.act, pl.lda, BT, b0, nb, K, src, K, 0, nw ? 1 : 0, K, nw,
                         nullptr, eps, blk.misc, nullptr, 0, 0, blk.bar, blk.parity);
      wait_weights(blk);
      dec::gemv<TW, BT>(wsm, K + row_pad<TW>(), np, blk.act, pl.lda, K, pl.out_rb, pl.out_rw,
                        pl.out_mma, blk.red, blk.res);
      for (int i = threadIdx.x; i < np * nb; i += dec::kThreads) {
        const int r = i / nb, bb = i - r * nb;
        const long long at = (long long)(b0 + bb) * E + p0 + r;
        const float s = blk.res[r * BT + bb];
        if (rcur) {
          const int c0 = lo & ~3, width = up4(hi) - c0;
          rnext[at] = s + (b0 == 0 ? rsm[bb * width + p0 + r - c0] : __ldcg(rcur + at));
        } else {
          hid[at] = s;
        }
      }
    }
  }
}

struct DecodeIO {
  const float* token;   // (B, E) fp32: R_0
  float* hid;           // (B, E): the last layer's output
  float* res[2];        // (B, E): R_k in res[(k + 1) % 2]
  const float* norm_w;  // (K, E)
  const float* norm_b;  // (K, E) or null
  const void* in_w;     // (K, 2Di, E)
  const void* out_w;    // (K, E, Di)
  const void* conv_w;   // (K, Di, W)
  const float* conv_b;  // (K, Di)
  const void* x_proj_w;   // (K, P, Di)
  const void* dt_proj_w;  // (K, Di, R)
  const float* dt_bias;   // (K, Di)
  const float* A;         // (K, Di, N)
  const float* Dskip;     // (K, Di)
  void* conv_states;      // (K, B, Di, W)
  void* ssm_states;       // (K, B, Di, N)
  float* scratch;         // cy, z, y (B, Di); x_proj's partial sums (kp, B, up4(P))
  unsigned* bar;          // the grid barrier's counter, then its value at a launch's start
  unsigned long long* timer;  // null, or a stamp at the start of each phase + the end
  int K, B, E, Di, W, R, N;
  float eps;
  int is_rms, s_bf16;
  int En;  // d_model the norm divides by: E less the zero lanes of a padded width
};

template <typename TW, int BT>
__global__ void __launch_bounds__(dec::kThreads, 1) decode_k9_kernel(const DecodeIO io,
                                                                     const Plan pl) {
  extern __shared__ __align__(128) char smem[];
  constexpr int S = sizeof(TW);
  const int B = io.B, E = io.E, Di = io.Di, W = io.W, R = io.R, N = io.N, P = R + 2 * N;
  const int Pp = up4(P), sb = io.s_bf16;
  float* cy = io.scratch;
  float* z = cy + (long long)B * Di;
  float* y = z + (long long)B * Di;
  float* xpart = y + (long long)B * Di;
  Block blk = make_block(smem, pl);
  constexpr int kPhases = 4;
  const int total = io.K * kPhases;
  int in_lo, in_hi, xp_lo, xp_hi, st_lo, st_hi, out_lo, out_hi;
  dec::block_span(2 * Di, in_lo, in_hi);
  dec::block_span((P + pl.xp_rg - 1) / pl.xp_rg * pl.xp_kp, xp_lo, xp_hi);
  dec::block_span((Di + 7) / 8, st_lo, st_hi);
  st_lo *= 8;
  st_hi = min(st_hi * 8, Di);
  dec::block_span(E, out_lo, out_hi);
  const int nch_max = 8 * ((((Di + 7) / 8) + (int)gridDim.x - 1) / (int)gridDim.x);
  const int in_rows = min(in_hi - in_lo, pl.in_cap), out_rows = min(out_hi - out_lo, pl.out_cap);
  const int xp_unit = pl.xp_rg * (pl.xp_kw * S + dec::kRowPad);
  const int tile0 = min(B, BT), ss = sb ? 2 : 4, nch = st_hi - st_lo;
  // The state phase's area: dt_proj's rows, then A, D and dt_bias of the
  // block's channels and the first tile's states, all fetched ahead.
  const int st_a = (nch * R * S + 15) / 16 * 16, st_d = st_a + nch * N * 4;
  const int st_h = st_d + 2 * nch * 4;
  const int out_w_bytes = out_rows * (Di * S + dec::kRowPad);
  const int r_lo = out_lo & ~3, r_width = up4(out_hi) - r_lo;  // R_k's columns, aligned
  const int phase_bytes[kPhases] = {in_rows * (E * S + dec::kRowPad), (xp_hi - xp_lo) * xp_unit,
                                    st_h + tile0 * nch * N * ss,
                                    out_w_bytes + tile0 * r_width * 4};
  unsigned target = dec::grid_base(io.bar);

  // Issue the copies of global phase gp's weight slice and the L2 prefetch
  // of its small operands (the caller commits the group).
  auto issue = [&](int gp) {
    const int k = gp / kPhases, ph = gp % kPhases;
    char* dst = region(smem, pl, gp, phase_bytes[ph]);
    if (ph == 0) {
      const TW* w = (const TW*)io.in_w + (long long)k * 2 * Di * E;
      dec::copy_rows(dst, (const char*)(w + (long long)in_lo * E), in_rows, E * S,
                     (long long)E * S, E * S + dec::kRowPad);
      dec::prefetch_l2(io.norm_w + (long long)k * E, E * 4);
      const int c0 = in_lo, c1 = min(in_hi, Di);
      if (c1 > c0) {
        dec::prefetch_l2((const TW*)io.conv_w + ((long long)k * Di + c0) * W, (c1 - c0) * W * S);
        dec::prefetch_l2(io.conv_b + (long long)k * Di + c0, (c1 - c0) * 4);
        for (int b = 0; b < tile0; ++b)
          dec::prefetch_l2((const char*)io.conv_states +
                               (((long long)k * B + b) * Di + c0) * W * ss,
                           (long long)(c1 - c0) * W * ss);
      }
    } else if (ph == 1) {
      const TW* w = (const TW*)io.x_proj_w + (long long)k * P * Di;
      for (int u = xp_lo; u < xp_hi; ++u) {
        const int r0 = (u / pl.xp_kp) * pl.xp_rg, c0 = (u % pl.xp_kp) * pl.xp_kw;
        dec::copy_rows(dst + (u - xp_lo) * xp_unit, (const char*)(w + (long long)r0 * Di + c0),
                       min(pl.xp_rg, P - r0), min(pl.xp_kw, Di - c0) * S, (long long)Di * S,
                       pl.xp_kw * S + dec::kRowPad);
      }
    } else if (ph == 2) {
      if (nch > 0) {
        const long long c0 = (long long)k * Di + st_lo;
        dec::copy_rows(dst, (const char*)((const TW*)io.dt_proj_w + c0 * R), 1, nch * R * S, 0,
                       0);
        dec::copy_rows(dst + st_a, (const char*)(io.A + c0 * N), 1, nch * N * 4, 0, 0);
        dec::copy_rows(dst + st_d, (const char*)(io.Dskip + c0), 1, nch * 4, 0, 0);
        dec::copy_rows(dst + st_d + nch * 4, (const char*)(io.dt_bias + c0), 1, nch * 4, 0, 0);
        dec::copy_rows(dst + st_h,
                       (const char*)io.ssm_states + (((long long)k * B) * Di + st_lo) * N * ss,
                       tile0, nch * N * ss, (long long)Di * N * ss, nch * N * ss);
      }
    } else {
      const TW* w = (const TW*)io.out_w + (long long)k * E * Di;
      dec::copy_rows(dst, (const char*)(w + (long long)out_lo * Di), out_rows, Di * S,
                     (long long)Di * S, Di * S + dec::kRowPad);
      if (k < io.K - 1 && out_hi > out_lo)  // R_k, written by this layer's in phase
        dec::copy_rows(dst + out_w_bytes, (const char*)(io.res[(k + 1) % 2] + r_lo), tile0,
                       r_width * 4, (long long)E * 4, r_width * 4);
    }
  };

  // Two phases' weights are in flight or landed at any time: phase gp's
  // region is filled at the end of phase gp - 2, under the barrier.
  auto fetch = [&](int gp) {
    if (gp < total) issue(gp);
    dec::cp_commit();  // one group a phase, empty after the last
  };
  fetch(0);
  fetch(1);
  for (int gp = 0; gp < total; ++gp) {
    if (gp > 0) dec::grid_sync(io.bar, target, [&]() { fetch(gp + 1); });
    if (io.timer && blockIdx.x == 0 && threadIdx.x == 0) io.timer[gp] = dec::global_ns();
    const int k = gp / kPhases, ph = gp % kPhases;
    TW* wsm = (TW*)region(smem, pl, gp, phase_bytes[ph]);
    blk.waited = false;
    if (ph == 0) {
      in_phase<TW, BT>(blk, pl, wsm, (const TW*)io.in_w + (long long)k * 2 * Di * E, in_lo,
                       in_hi, B, E, io.En, k == 0 ? io.token : io.res[(k + 1) % 2],
                       k == 0 ? io.res[1] : nullptr, io.norm_w + (long long)k * E,
                       io.norm_b ? io.norm_b + (long long)k * E : nullptr, io.eps, io.is_rms, 0,
                       Di, W, (const TW*)io.conv_w + (long long)k * Di * W,
                       io.conv_b + (long long)k * Di,
                       (char*)io.conv_states + (long long)k * B * Di * W * (sb ? 2 : 4), sb, cy,
                       Di, z, Di, Di);
    } else if (ph == 1) {
      // Each tile of every unit's x columns comes in one bulk copy, unit s
      // in its own slot of act (BT rows, ldu floats apart).
      const int nu = xp_hi - xp_lo, ldu = pl.xp_kw + dec::kActPad;
      for (int b0 = 0; b0 < B && nu > 0; b0 += BT) {
        const int nb = min(BT, B - b0);
        unsigned bytes = 0;
        for (int u = xp_lo; u < xp_hi; ++u)
          bytes += nb * min(pl.xp_kw, Di - (u % pl.xp_kp) * pl.xp_kw) * 4;
        __syncthreads();
        for (int i = threadIdx.x; i < nu * (BT - nb) * ldu; i += dec::kThreads) {
          const int s = i / ((BT - nb) * ldu), rest = i - s * (BT - nb) * ldu;
          blk.act[(s * BT + nb) * ldu + rest] = 0.f;
        }
        dec::bulk_load(blk.bar, blk.parity, bytes, nu * nb,
                       [&](int i, float*& d, const float*& src, unsigned& size) {
                         const int s = i / nb, bb = i - s * nb;
                         const int c0 = ((xp_lo + s) % pl.xp_kp) * pl.xp_kw;
                         d = blk.act + (s * BT + bb) * ldu;
                         src = cy + (long long)(b0 + bb) * Di + c0;
                         size = min(pl.xp_kw, Di - c0) * 4;
                       });
        if (sizeof(TW) == 2) {  // the product's input, rounded to the weights' bf16
          for (int i = threadIdx.x; i < nu * BT * ldu; i += dec::kThreads)
            blk.act[i] = dec::rnd<TW>(blk.act[i]);
          __syncthreads();
        }
        wait_weights(blk);
        for (int u = xp_lo; u < xp_hi; ++u) {
          const int q = u % pl.xp_kp, r0 = (u / pl.xp_kp) * pl.xp_rg, c0 = q * pl.xp_kw;
          const int nr = min(pl.xp_rg, P - r0), cw = min(pl.xp_kw, Di - c0);
          const TW* w = (const TW*)((const char*)wsm + (u - xp_lo) * xp_unit);
          dec::gemv<TW, BT>(w, pl.xp_kw + row_pad<TW>(), nr, blk.act + (u - xp_lo) * BT * ldu,
                            ldu, cw, pl.xp_rb, pl.xp_rw, 0, blk.red, blk.res);
          for (int i = threadIdx.x; i < nr * nb; i += dec::kThreads) {
            const int r = i / nb, bb = i - r * nb;
            xpart[((long long)q * B + b0 + bb) * Pp + r0 + r] = blk.res[r * BT + bb];
          }
        }
      }
    } else if (ph == 2) {
      if (nch > 0) {
        // Per tile: x_proj's partial sums (kp x nb rows) into act, the tile's
        // cy and z columns into misc after x_dbl and, after the first tile,
        // its states into the phase's area.
        float* xd = blk.misc;                  // (BT, Pp): x_dbl rows
        float* cys = xd + BT * Pp;             // (BT, nch_max)
        float* zs = cys + BT * nch_max;
        const char* area = (const char*)wsm;
        const float* As = (const float*)(area + st_a);
        const float* Ds = (const float*)(area + st_d);
        const float* dtbs = Ds + nch;
        char* hs = (char*)wsm + st_h;  // (nb, nch, N) in the state dtype
        char* hst = (char*)io.ssm_states + (long long)k * B * Di * N * ss;
        const int kp = pl.xp_kp;
        for (int b0 = 0; b0 < B; b0 += BT) {
          const int nb = min(BT, B - b0);
          const int nh = b0 > 0 ? nb : 0;  // state rows to copy now
          __syncthreads();
          dec::bulk_load(
              blk.bar, blk.parity, (unsigned)(nb * (kp * Pp + 2 * nch) * 4 + nh * nch * N * ss),
              nb * (kp + 2) + nh, [&](int i, float*& d, const float*& s, unsigned& size) {
                if (i < kp * nb) {
                  const int q = i / nb, bb = i - q * nb;
                  d = blk.act + (q * BT + bb) * Pp;
                  s = xpart + ((long long)q * B + b0 + bb) * Pp;
                  size = Pp * 4;
                } else if (i < (kp + 2) * nb) {
                  const int j = i - kp * nb, bb = j % nb;
                  d = (j < nb ? cys : zs) + bb * nch_max;
                  s = (j < nb ? cy : z) + (long long)(b0 + bb) * Di + st_lo;
                  size = nch * 4;
                } else {
                  const int bb = i - (kp + 2) * nb;
                  d = (float*)(hs + (long long)bb * nch * N * ss);
                  s = (const float*)(hst + ((long long)(b0 + bb) * Di + st_lo) * N * ss);
                  size = nch * N * ss;
                }
              });
          for (int i = threadIdx.x; i < nb * P; i += dec::kThreads) {
            const int bb = i / P, p = i - bb * P;
            float s = 0.f;
            for (int q = 0; q < kp; ++q) s += blk.act[(q * BT + bb) * Pp + p];
            xd[bb * Pp + p] = s;
          }
          wait_weights(blk);
          __syncthreads();
          for (int t = threadIdx.x; t < nb * nch; t += dec::kThreads) {
            const int bb = t / nch, c = t - bb * nch, d = st_lo + c;
            const long long b = b0 + bb;
            const float* xr = xd + bb * Pp;
            const TW* wr = wsm + c * R;
            float s = 0.f;
            for (int r = 0; r < R; ++r) s += dec::rnd<TW>(xr[r]) * vmt::to_f32(wr[r]);
            const float dt = vmt::softplus_f(s + dtbs[c]);
            const float xv = cys[bb * nch_max + c];
            const float dx = dt * xv;
            const long long hl = ((long long)bb * nch + c) * N, hg = (b * Di + d) * N;
            const float* a = As + c * N;
            float acc = 0.f;
            // Each thread starts its row at its own state, so a warp's
            // shared-memory reads of (c, n) rows N apart spread over banks.
            for (int i = 0; i < N; ++i) {
              const int n = (i + c) % N;
              const float hn = expf(dt * a[n]) * dec::ld_state(hs, hl + n, sb) + dx * xr[R + n];
              dec::st_state(hst, hg + n, hn, sb);
              acc += xr[R + N + n] * hn;
            }
            y[b * Di + d] = (acc + Ds[c] * xv) * silu(zs[bb * nch_max + c]);
          }
        }
      }
    } else {
      const bool last = k == io.K - 1;
      out_phase<TW, BT>(blk, pl, wsm, (const TW*)io.out_w + (long long)k * E * Di, out_lo,
                        out_hi, B, E, Di, y, nullptr, 0.f, last ? nullptr : io.res[(k + 1) % 2],
                        (const float*)((const char*)wsm + out_w_bytes), io.res[k % 2], io.hid);
    }
    wait_weights(blk);  // a block with nothing to do keeps its groups in step
  }
  dec::grid_close(io.bar, target);
  if (io.timer && blockIdx.x == 0 && threadIdx.x == 0) io.timer[total] = dec::global_ns();
}

// ---------------------------------------------------------------------------
// Mamba-2 (K15): the same persistent walk with the SSD mixer, three phases a
// layer:
//   1. in: norm + in_proj + conv (in_phase): Win's rows give z, the [x B C]
//      slab (conv + SiLU, the window rolled) and the dt rows;
//   2. state, a warp per (b, head, p) row of N states, eight rows at a time
//      (the earlier design's shape, a small share of its trace), its inputs
//      staged by bulk copy: dt = softplus(dt_raw + dt_bias_h),
//      h = exp(dt A_h) h + (dt x) B, y = C . h + D_h x, gated = y silu(z);
//   3. out: the gated RMSNorm of each staged row (rounded to the weight
//      dtype), out_proj and the residual add (out_phase).
// Rounding as the TPU kernel's: normed and the normed gated rows round to
// the weight dtype before their products; the conv, the state update and
// the gate are fp32; the conv window keeps its dtype, the SSD state is fp32.

struct DecodeM2IO {
  const float* token;
  float* hid;
  float* res[2];
  const float* norm_w;  // (K, E)
  const float* norm_b;  // (K, E) or null
  const void* in_w;     // (K, M, E), M = 2 Di + 2 G N + H
  const void* out_w;    // (K, E, Di)
  const void* conv_w;   // (K, CD, W)
  const float* conv_b;  // (K, CD)
  const float* A;       // (K, H)
  const float* Dskip;   // (K, H)
  const float* dt_bias; // (K, H)
  const float* gate_w;  // (K, Di) or null: no gated RMSNorm
  void* conv_states;    // (K, B, CD, W)
  float* ssm_states;    // (K, B, H, P, N)
  float* scratch;       // raw (B, up4(M)), cy (B, up4(CD)), gated (B, Di)
  unsigned* bar;
  unsigned long long* timer;
  int K, B, E, H, P, G, N, W;
  float eps;
  int is_rms;
  float gate_eps;
  int c_bf16;
  int En;  // d_model the norm divides by: E less the zero lanes of a padded width
};

constexpr int kM2Tasks = 8;  // state rows a warp walks together

template <typename TW, int BT>
__global__ void __launch_bounds__(dec::kThreads, 1) decode_k15_kernel(const DecodeM2IO io,
                                                                      const Plan pl) {
  extern __shared__ __align__(128) char smem[];
  constexpr int S = sizeof(TW);
  const int B = io.B, E = io.E, H = io.H, P = io.P, N = io.N, W = io.W, cb = io.c_bf16;
  const int Di = H * P, GN = io.G * N, CD = Di + 2 * GN, M = Di + CD + H;
  const int ldr = up4(M), ldc = up4(CD);
  float* raw = io.scratch;
  float* cy = raw + (long long)B * ldr;
  float* gated = cy + (long long)B * ldc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Block blk = make_block(smem, pl);
  constexpr int kPhases = 3;
  const int total = io.K * kPhases;
  int in_lo, in_hi, st_lo, st_hi, out_lo, out_hi;
  dec::block_span(M, in_lo, in_hi);
  dec::block_span(Di / 4, st_lo, st_hi);
  st_lo *= 4;
  st_hi *= 4;
  dec::block_span(E, out_lo, out_hi);
  const int in_rows = min(in_hi - in_lo, pl.in_cap), out_rows = min(out_hi - out_lo, pl.out_cap);
  const int tile0 = min(B, BT), nhp = st_hi - st_lo;
  const int out_w_bytes = out_rows * (Di * S + dec::kRowPad);
  const int r_lo = out_lo & ~3, r_width = up4(out_hi) - r_lo;  // R_k's columns, aligned
  // The state phase's area: the first tile's SSD states of the block's rows.
  const int phase_bytes[kPhases] = {in_rows * (E * S + dec::kRowPad), tile0 * nhp * N * 4,
                                    out_w_bytes + tile0 * r_width * 4};
  unsigned target = dec::grid_base(io.bar);
  // The state phase's staged row: x and z of the block's (head, p) rows,
  // its heads' dt inputs (from a 16-byte boundary), then B and C.
  const int nhp_max = 4 * ((Di / 4 + (int)gridDim.x - 1) / (int)gridDim.x);
  const int o_z = nhp_max, o_dt = 2 * nhp_max, o_bc = o_dt + up4(nhp_max / P + 2) + 8;

  auto issue = [&](int gp) {
    const int k = gp / kPhases, ph = gp % kPhases;
    char* dst = region(smem, pl, gp, phase_bytes[ph]);
    if (ph == 0) {
      const TW* w = (const TW*)io.in_w + (long long)k * M * E;
      dec::copy_rows(dst, (const char*)(w + (long long)in_lo * E), in_rows, E * S,
                     (long long)E * S, E * S + dec::kRowPad);
      dec::prefetch_l2(io.norm_w + (long long)k * E, E * 4);
      const int c0 = max(in_lo, Di) - Di, c1 = min(in_hi, Di + CD) - Di;
      if (c1 > c0) {
        const int cs = cb ? 2 : 4;
        dec::prefetch_l2((const TW*)io.conv_w + ((long long)k * CD + c0) * W, (c1 - c0) * W * S);
        dec::prefetch_l2(io.conv_b + (long long)k * CD + c0, (c1 - c0) * 4);
        for (int b = 0; b < tile0; ++b)
          dec::prefetch_l2((const char*)io.conv_states +
                               (((long long)k * B + b) * CD + c0) * W * cs,
                           (long long)(c1 - c0) * W * cs);
      }
    } else if (ph == 1) {
      if (nhp > 0) {
        dec::copy_rows(dst, (const char*)(io.ssm_states + ((long long)k * B * Di + st_lo) * N),
                       tile0, nhp * N * 4, (long long)Di * N * 4, nhp * N * 4);
        dec::prefetch_l2(io.A + (long long)k * H, H * 4);
        dec::prefetch_l2(io.Dskip + (long long)k * H, H * 4);
        dec::prefetch_l2(io.dt_bias + (long long)k * H, H * 4);
      }
    } else {
      const TW* w = (const TW*)io.out_w + (long long)k * E * Di;
      dec::copy_rows(dst, (const char*)(w + (long long)out_lo * Di), out_rows, Di * S,
                     (long long)Di * S, Di * S + dec::kRowPad);
      if (io.gate_w) dec::prefetch_l2(io.gate_w + (long long)k * Di, Di * 4);
      if (k < io.K - 1 && out_hi > out_lo)  // R_k, written by this layer's in phase
        dec::copy_rows(dst + out_w_bytes, (const char*)(io.res[(k + 1) % 2] + r_lo), tile0,
                       r_width * 4, (long long)E * 4, r_width * 4);
    }
  };

  // Two phases' weights are in flight or landed at any time: phase gp's
  // region is filled at the end of phase gp - 2, under the barrier.
  auto fetch = [&](int gp) {
    if (gp < total) issue(gp);
    dec::cp_commit();  // one group a phase, empty after the last
  };
  fetch(0);
  fetch(1);
  for (int gp = 0; gp < total; ++gp) {
    if (gp > 0) dec::grid_sync(io.bar, target, [&]() { fetch(gp + 1); });
    if (io.timer && blockIdx.x == 0 && threadIdx.x == 0) io.timer[gp] = dec::global_ns();
    const int k = gp / kPhases, ph = gp % kPhases;
    TW* wsm = (TW*)region(smem, pl, gp, phase_bytes[ph]);
    blk.waited = false;
    if (ph == 0) {
      in_phase<TW, BT>(blk, pl, wsm, (const TW*)io.in_w + (long long)k * M * E, in_lo, in_hi,
                       B, E, io.En, k == 0 ? io.token : io.res[(k + 1) % 2],
                       k == 0 ? io.res[1] : nullptr, io.norm_w + (long long)k * E,
                       io.norm_b ? io.norm_b + (long long)k * E : nullptr, io.eps, io.is_rms, Di,
                       CD, W, (const TW*)io.conv_w + (long long)k * CD * W,
                       io.conv_b + (long long)k * CD,
                       (char*)io.conv_states + (long long)k * B * CD * W * (cb ? 2 : 4), cb, cy,
                       ldc, raw, ldr, 0);
    } else if (ph == 1) {
      if (nhp > 0) {
        const int h_lo = st_lo / P, h_hi = (st_hi - 1) / P + 1;
        const int a0 = (Di + CD + h_lo) & ~3, a1 = up4(Di + CD + h_hi);
        const float* A = io.A + (long long)k * H;
        const float* Dk = io.Dskip + (long long)k * H;
        const float* dtb = io.dt_bias + (long long)k * H;
        float* sst = io.ssm_states + (long long)k * B * Di * N;
        for (int b0 = 0; b0 < B; b0 += BT) {
          const int nb = min(BT, B - b0);
          __syncthreads();
          dec::bulk_load(blk.bar, blk.parity,
                         (unsigned)(nb * (2 * nhp + (a1 - a0) + up4(2 * GN)) * 4), nb * 4,
                         [&](int i, float*& d, const float*& s, unsigned& size) {
                           const int part = i / nb, bb = i - part * nb;
                           float* row = blk.act + (long long)bb * pl.lda;
                           const long long b = b0 + bb;
                           if (part == 0) {
                             d = row, s = cy + b * ldc + st_lo, size = nhp * 4;
                           } else if (part == 1) {
                             d = row + o_z, s = raw + b * ldr + st_lo, size = nhp * 4;
                           } else if (part == 2) {
                             d = row + o_dt, s = raw + b * ldr + a0, size = (a1 - a0) * 4;
                           } else {
                             d = row + o_bc, s = cy + b * ldc + Di, size = up4(2 * GN) * 4;
                           }
                         });
          wait_weights(blk);
          // dt, exp(dt A) and D of each (batch row, head), once a tile.
          const int nh = h_hi - h_lo;
          float* hd = blk.res;  // (nb, nh, 3)
          for (int i = threadIdx.x; i < nb * nh; i += dec::kThreads) {
            const int bb = i / nh, h = h_lo + i % nh;
            const float dt =
                vmt::softplus_f(blk.act[(long long)bb * pl.lda + o_dt + Di + CD + h - a0] + dtb[h]);
            hd[3 * i] = dt;
            hd[3 * i + 1] = expf(dt * A[h]);
            hd[3 * i + 2] = Dk[h];
          }
          __syncthreads();
          const int ntask = nb * nhp;
          for (int t0 = warp * kM2Tasks; t0 < ntask; t0 += dec::kWarps * kM2Tasks) {
            float dA[kM2Tasks], dx[kM2Tasks], acc[kM2Tasks];
            const float* row[kM2Tasks];
            const float* sv[kM2Tasks];
            float* st[kM2Tasks];
#pragma unroll
            for (int j = 0; j < kM2Tasks; ++j) {
              const int t = min(t0 + j, ntask - 1);
              const int bb = t / nhp, hp = st_lo + t % nhp;
              const float* hdj = hd + 3 * (bb * nh + hp / P - h_lo);
              row[j] = blk.act + (long long)bb * pl.lda;
              dA[j] = hdj[1];
              dx[j] = hdj[0] * row[j][hp - st_lo];
              st[j] = sst + ((long long)(b0 + bb) * Di + hp) * N;
              // The first tile's states came ahead, to the phase's area.
              sv[j] = b0 == 0 ? (const float*)wsm + ((long long)bb * nhp + hp - st_lo) * N : st[j];
              acc[j] = 0.f;
            }
#pragma unroll 2
            for (int n = lane; n < N; n += 32) {
              float hv[kM2Tasks];
#pragma unroll
              for (int j = 0; j < kM2Tasks; ++j) hv[j] = sv[j][n];
#pragma unroll
              for (int j = 0; j < kM2Tasks; ++j) {
                const int hp = st_lo + min(t0 + j, ntask - 1) % nhp;
                const int g = (hp / P) / (H / io.G);
                const float hn = dA[j] * hv[j] + dx[j] * row[j][o_bc + g * N + n];
                if (t0 + j < ntask) st[j][n] = hn;
                acc[j] += row[j][o_bc + GN + g * N + n] * hn;
              }
            }
#pragma unroll
            for (int j = 0; j < kM2Tasks; ++j) {
              const float s = vmt::warp_sum(acc[j]);
              const int t = t0 + j;
              if (lane == 0 && t < ntask) {
                const int bb = t / nhp, c = t % nhp, hp = st_lo + c;
                const float yv = s + hd[3 * (bb * nh + hp / P - h_lo) + 2] * row[j][c];
                gated[(long long)(b0 + bb) * Di + hp] = yv * silu(row[j][o_z + c]);
              }
            }
          }
        }
      }
    } else {
      const bool last = k == io.K - 1;
      out_phase<TW, BT>(blk, pl, wsm, (const TW*)io.out_w + (long long)k * E * Di, out_lo,
                        out_hi, B, E, Di, gated,
                        io.gate_w ? io.gate_w + (long long)k * Di : nullptr, io.gate_eps,
                        last ? nullptr : io.res[(k + 1) % 2],
                        (const float*)((const char*)wsm + out_w_bytes), io.res[k % 2], io.hid);
    }
    wait_weights(blk);  // a block with nothing to do keeps its groups in step
  }
  dec::grid_close(io.bar, target);
  if (io.timer && blockIdx.x == 0 && threadIdx.x == 0) io.timer[total] = dec::global_ns();
}

// Set the kernel's shared memory once per size and device, check that the
// grid is co-resident, and launch it cooperatively (the runtime refuses a
// grid that cannot all be resident: no deadlock, no fallback).
template <auto kern, typename IO>
cudaError_t launch(const IO& io, const Plan& pl, int grid, int device, cudaStream_t s) {
  static int ready_smem[16] = {0};  // this kernel's shared memory size on each device
  if (device < 0 || device >= 16) return cudaErrorInvalidDevice;
  cudaError_t err;
  if (ready_smem[device] != pl.smem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, dec::kThreads,
                                                             pl.smem)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
    ready_smem[device] = pl.smem;
  }
  void* args[] = {(void*)&io, (void*)&pl};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(dec::kThreads), args,
                                    (size_t)pl.smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Plan read_plan(const int* v) {
  Plan p;
  memcpy(&p, v, sizeof(Plan));
  return p;
}

template <typename TW>
cudaError_t k9_bt(const DecodeIO& io, const Plan& pl, int grid, int device, cudaStream_t s) {
  switch (pl.bt) {
    case 1: return launch<decode_k9_kernel<TW, 1>>(io, pl, grid, device, s);
    case 8: return launch<decode_k9_kernel<TW, 8>>(io, pl, grid, device, s);
    case 16: return launch<decode_k9_kernel<TW, 16>>(io, pl, grid, device, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TW>
cudaError_t k15_bt(const DecodeM2IO& io, const Plan& pl, int grid, int device, cudaStream_t s) {
  switch (pl.bt) {
    case 1: return launch<decode_k15_kernel<TW, 1>>(io, pl, grid, device, s);
    case 8: return launch<decode_k15_kernel<TW, 8>>(io, pl, grid, device, s);
    case 16: return launch<decode_k15_kernel<TW, 16>>(io, pl, grid, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

static_assert(sizeof(Plan) == kPlanInts * sizeof(int), "Plan is kPlanInts ints");

// K9. ptrs (20): token (B, E) fp32; hid, res0, res1 (B, E) fp32 (the last
// layer's output in hid, its residual in res[K % 2]); norm_w, norm_b (may be
// null) (K, E) fp32; in_w (K, 2Di, E), out_w (K, E, Di), conv_w (K, Di, W)
// in the weight dtype; conv_b (K, Di) fp32; x_proj_w (K, R + 2N, Di),
// dt_proj_w (K, Di, R) in the weight dtype; dt_bias (K, Di), A (K, Di, N), D
// (K, Di) fp32; conv_states (K, B, Di, W), ssm_states (K, B, Di, N) in one
// dtype, advanced in place; scratch 3 B Di + xp_kp B up4(R + 2N) fp32; the
// grid barrier (two uint32: the counter, its value at a launch's start; zero
// before the first launch); the phase timer (K * 4 + 1 uint64) or null.
// dims (12): w_bf16, s_bf16, K, B, E, Di, W, R, N, is_rms, grid, En. plan:
// decode_plan's kPlanInts ints.
// E and Di multiples of 8 (a width that is not comes padded with zero
// lanes: zero weight rows and columns, zero states; the norm divides by En,
// the true d_model), weights on 16-byte boundaries, all contiguous.
extern "C" int vmt_decode_stack(const void* const* ptrs, const int* dims, const int* plan,
                                float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int K = dims[2], B = dims[3], E = dims[4], Di = dims[5];
  if (E % 8 || Di % 8 || dims[11] < 1 || dims[11] > E) return (int)cudaErrorInvalidValue;
  if (K == 0 || B == 0) return cudaSuccess;
  DecodeIO io{(const float*)ptrs[0], (float*)ptrs[1], {(float*)ptrs[2], (float*)ptrs[3]},
              (const float*)ptrs[4], (const float*)ptrs[5], ptrs[6], ptrs[7], ptrs[8],
              (const float*)ptrs[9], ptrs[10], ptrs[11], (const float*)ptrs[12],
              (const float*)ptrs[13], (const float*)ptrs[14], (void*)ptrs[15], (void*)ptrs[16],
              (float*)ptrs[17], (unsigned*)ptrs[18], (unsigned long long*)ptrs[19],
              K, B, E, Di, dims[6], dims[7], dims[8], eps, dims[9], dims[1], dims[11]};
  const Plan pl = read_plan(plan);
  const cudaStream_t s = (cudaStream_t)stream;
  err = dims[0] ? k9_bt<bf16>(io, pl, dims[10], device, s)
                : k9_bt<float>(io, pl, dims[10], device, s);
  return (int)err;
}

// K15. ptrs (19): token, hid, res0, res1 as vmt_decode_stack's; norm_w,
// norm_b (may be null) (K, E) fp32; in_w (K, 2Di + 2GN + H, E), out_w (K, E,
// Di), conv_w (K, CD, W) in the weight dtype; conv_b (K, CD), A, D, dt_bias
// (K, H), gate_w (K, Di) or null fp32; conv_states (K, B, CD, W) fp32 or
// bf16 (c_bf16) and ssm_states (K, B, H, P, N) fp32, advanced in place;
// scratch B (up4(2Di + 2GN + H) + up4(CD) + Di) fp32; the grid barrier as
// vmt_decode_stack's; the phase timer (K * 3 + 1) or null. dims (13):
// w_bf16, c_bf16, K, B, E, H, P, G, N, W, is_rms, grid, En.
// E a multiple of 8 (padded as vmt_decode_stack's; the norm divides by En),
// Di = H P a multiple of 8, G dividing H; contiguous.
extern "C" int vmt_decode_stack_m2(const void* const* ptrs, const int* dims, const int* plan,
                                   float eps, float gate_eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int K = dims[2], B = dims[3], E = dims[4], H = dims[5], P = dims[6], G = dims[7];
  if (E % 8 || (H * P) % 8 || G <= 0 || H % G || dims[12] < 1 || dims[12] > E)
    return (int)cudaErrorInvalidValue;
  if (K == 0 || B == 0) return cudaSuccess;
  DecodeM2IO io{(const float*)ptrs[0], (float*)ptrs[1], {(float*)ptrs[2], (float*)ptrs[3]},
                (const float*)ptrs[4], (const float*)ptrs[5], ptrs[6], ptrs[7], ptrs[8],
                (const float*)ptrs[9], (const float*)ptrs[10], (const float*)ptrs[11],
                (const float*)ptrs[12], (const float*)ptrs[13], (void*)ptrs[14],
                (float*)ptrs[15], (float*)ptrs[16], (unsigned*)ptrs[17],
                (unsigned long long*)ptrs[18], K, B, E, H, P, G, dims[8], dims[9], eps,
                dims[10], gate_eps, dims[1], dims[12]};
  const Plan pl = read_plan(plan);
  const cudaStream_t s = (cudaStream_t)stream;
  err = dims[0] ? k15_bt<bf16>(io, pl, dims[11], device, s)
                : k15_bt<float>(io, pl, dims[11], device, s);
  return (int)err;
}
