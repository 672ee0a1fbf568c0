"""K12: the Mamba-2 (SSD) mixer core between the projections, CUDA for Hopper.

Replaces videomamba_tpu/ops/pallas/ssd_scan.py (ssd_mixer_pallas: the
per-head ``_ssd_mixer_padded`` -> ``_ssd_kernel`` and the merged
``_ssd_mixer_fwd_merged`` -> ``_ssd_mixer_fwd_merged_kernel``). For the raw
in_proj output zxbcdt (B, L, 2 Di + 2 G N + H): causal conv + SiLU over the
[x B C] slab with the streaming window, the SSD chunk walk, the D skip, the
silu(z) gate and the gated RMSNorm; it returns (out_proj input (B, L, Di) in
zxbcdt's dtype, h_last (B, H, P, N) fp32).

The TPU grid is (B, L / Q) with the chunk axis sequential and the state in
VMEM scratch: on Hopper that is one block per batch row. csrc/ssd_mixer.cu
splits the walk by state passing instead, six launches on the current
stream: the conv (K3's ``conv_silu`` over the slab, left context from the
window); per (chunk, head, batch) block the chunk's own state (x w)^T B; a
short sequential pass per (head, batch) that turns those into each chunk's
entry state and h_last; per (causal 64 x 64 tile pair, group, batch)
block C B^T, built once for the group's heads into a scratch the wrapper
allocates (:func:`cb_scratch_elems`); per (64 rows of a chunk, 64 head-dim
columns, head, batch) block the intra-chunk (C B^T * decay * dt) x over
the causal 64-row slabs, the inter-chunk (C h_entry^T) e^s and D x; then a
row pass for the gate and the norm, which spans every head of a row. That is 26 x
24 = 624 blocks at VideoMamba-Base-m2, B = 1, and shared memory that grows
with neither the head dim nor the state (both staged 64 wide), only by the
chunk's s and dt, so chunk 256, d_state 128 and P = N = 256 run too. The dt softplus and the
per-chunk decay cumsum are torch ops around it, as they are XLA ops in the
JAX package (``_prepare_dt``, ``_decay_tensors``).

What bounds it on the H100: operations. At Base, B = 1, the products need
about 1.0 GFLOP (0.015 ms at fp32's 67 TFLOP/s) against about 30 MB of
inputs and outputs (0.009 ms). The chunk products are fp32 FMA at fp32 and
bf16 ``mma.sync`` with fp32 sums at bf16 (csrc/ssd_core.cuh's slab
product), on operands already rounded to the compute dtype.

Rounding (the merged arm, the JAX default, _merged_scan_fwd_core): the conv,
its SiLU and x_f are fp32; x, B, C, the decay-weighted tile m = C B^T e^(s_q
- s_k) dt_k, x_f w and the entry state h are rounded to the compute dtype
before their products, whose sums are fp32; the D skip reads x_f; the state
stays fp32 between chunks; the output is rounded once. At fp32 nothing is
rounded (the TPU's ``Precision.HIGHEST``). The conv window is rounded to the
compute dtype first, as the JAX wrapper casts it.

Training: with ``checkpoints=True`` (:func:`ssd_mixer_core`) the call also
returns the walk's own buffers, each chunk's entry state ``hins`` (B, nc,
H, P, N) fp32 and the pre-gate y ``yd`` (B, L, Di) fp32: the residuals the
backward (K13, ops/kernels/ssd_mixer_bwd.py) starts from, as the JAX
package's ``_mixer_vjp_fwd`` emits them. They cost no extra launch.

The kernel's shape gate (:func:`ssd_kernel_supported`) is its own: head dim
and state multiples of 4 and groups dividing heads. The chunk tiles stage
64 rows, 64 head-dim columns and 64 states at a time, so shared memory
grows only with the chunk's s and dt (every chunk a model uses fits). The
TPU's 128-lane chunk rule is not ported. On a CUDA tensor a shape outside
the gate raises; the model routes never send one to a plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.mixer_bwd import _rnd, conv_pre
from videomamba_tpu_torch.ops.ssd import _expand_groups, _prepare_dt

Tensor = torch.Tensor

MAX_SMEM_BYTES = 232448  # one Hopper block's shared memory (227 KB)
SLAB = 64  # chunk rows, head-dim columns and states the chunk kernels stage at a time


def chunk_smem_bytes(chunk: int) -> int:
    """Shared memory of the largest chunk-kernel block at fp32, the gate of
    every chunk kernel (csrc/ssd_core.cuh ``ssd_smem_bytes``): the reverse
    walk's tile launches, four staging and one fp32 (SLAB, SLAB) tile, s and
    dt (Q,), four per-row vectors and one per-thread vector (256). The
    forward's chunk-output block (three tiles, s and dt) is smaller."""
    return 4 * (5 * SLAB * SLAB + 2 * chunk + 4 * SLAB + 256)


def cb_scratch_elems(bsz: int, lp: int, chunk: int, ngroups: int) -> int:
    """fp32 elements of the C B^T scratch (B, nc, G, Q, Q): each chunk's
    causal tiles, built once a group (csrc/ssd_mixer.cu launch 4) for the
    forward's chunk outputs and the backward's tile launches."""
    return bsz * (lp // chunk) * ngroups * chunk * chunk


def ssd_kernel_supported(nheads: int, hdim: int, ngroups: int, d_state: int,
                         chunk_size: int) -> bool:
    """The Hopper kernels' shape gate (K11-K14 share the chunk walk)."""
    return (hdim % 4 == 0 and d_state % 4 == 0 and chunk_size > 0 and ngroups > 0
            and nheads % ngroups == 0
            and chunk_smem_bytes(chunk_size) <= MAX_SMEM_BYTES)


def decay_cumsum(dt_p: Tensor, A: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """dt_p (B, L, H) fp32 zero-padded to whole chunks and the per-chunk
    inclusive cumsum s of dt * A, both (B, Lp, H) fp32 (the JAX package's
    ``_decay_tensors``). Padded rows have dt = 0: no decay, no input."""
    bsz, seqlen, nheads = dt_p.shape
    pad = (-seqlen) % chunk
    dtf = F.pad(dt_p.float(), (0, 0, 0, pad))
    lp = seqlen + pad
    s = torch.cumsum((dtf * A.float()).reshape(bsz, lp // chunk, chunk, nheads), dim=2)
    return dtf.contiguous(), s.reshape(bsz, lp, nheads).contiguous()


def to_chunks(t: Tensor, lp: int, chunk: int) -> Tensor:
    """(B, L, X, Y) zero-padded to Lp rows and split into (B, nc, Q, X, Y)."""
    bsz, seqlen = t.shape[:2]
    t = F.pad(t, (0, 0, 0, 0, 0, lp - seqlen))
    return t.reshape(bsz, lp // chunk, chunk, *t.shape[2:])


def walk_plain(x_f: Tensor, Bm: Tensor, Cm: Tensor, dtf: Tensor, s: Tensor,
               h0: Optional[Tensor], D: Optional[Tensor], cdt: torch.dtype,
               chunk: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The chunk walk (launches 2-5 of csrc/ssd_mixer.cu) in plain PyTorch,
    with its rounding points. x_f (B, L, H, P), Bm and Cm (B, L, G, N),
    fp32; dtf and s (B, Lp, H) from :func:`decay_cumsum`; h0 (B, H, P, N)
    or None; D (H,) or None. Returns (y (B, L, H, P) fp32 with the D skip,
    h_last (B, H, P, N) fp32, hins (B, nc, H, P, N) fp32: each chunk's entry
    state)."""
    bsz, seqlen, nheads, hdim = x_f.shape
    d_state = Bm.shape[-1]
    q = int(chunk)
    lp = dtf.shape[1]
    nc = lp // q
    xf = to_chunks(x_f.float(), lp, q)  # (B, C, Q, H, P)
    xr = _rnd(xf, cdt)
    Bh = _expand_groups(_rnd(to_chunks(Bm.float(), lp, q), cdt), nheads)  # (B, C, Q, H, N)
    Ch = _expand_groups(_rnd(to_chunks(Cm.float(), lp, q), cdt), nheads)
    sc = s.reshape(bsz, nc, q, nheads)
    dtc = dtf.reshape(bsz, nc, q, nheads)

    # Intra-chunk: m[q, k] = rnd(C_q . B_k e^(s_q - s_k) dt_k), k <= q.
    cb = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    seg = (sc[:, :, :, None, :] - sc[:, :, None, :, :]).movedim(-1, 2)  # (B, C, H, Q, Q)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x_f.device))
    m = cb * torch.exp(seg.masked_fill(~causal, float("-inf")))
    m = _rnd(m * dtc.permute(0, 1, 3, 2)[:, :, :, None, :], cdt)
    y = torch.einsum("bchqk,bckhp->bcqhp", m, xr)

    # Chunk states S_c = (x_f w rounded)^T B, w = dt e^(s_last - s); entry states.
    w = dtc * torch.exp(sc[:, :, -1:, :] - sc)
    S = torch.einsum("bcqhp,bcqhn->bchpn", _rnd(xf * w[..., None], cdt), Bh)
    h = h0.float() if h0 is not None else x_f.new_zeros(
        (bsz, nheads, hdim, d_state), dtype=torch.float32)
    entries = []
    for c in range(nc):
        entries.append(h)
        h = torch.exp(sc[:, c, -1])[:, :, None, None] * h + S[:, c]
    hins = torch.stack(entries, dim=1)  # (B, C, H, P, N)

    y = y + torch.einsum("bcqhn,bchpn->bcqhp", Ch, _rnd(hins, cdt)) * torch.exp(sc)[..., None]
    if D is not None:
        y = y + D.float()[:, None] * xf
    return y.reshape(bsz, lp, nheads, hdim)[:, :seqlen], h, hins


def gate_plain(y: Tensor, z: Tensor, norm_weight: Optional[Tensor], norm_eps: float) -> Tensor:
    """Launch 5 in plain PyTorch: norm(y silu(z)) in fp32, y (B, L, Di)."""
    gated = y * F.silu(z.float())
    if norm_weight is not None:
        var = gated.square().mean(-1, keepdim=True)
        gated = gated * torch.rsqrt(var + norm_eps) * norm_weight.float()
    return gated


def ssd_core_plain(zx: Tensor, dt_p: Tensor, A: Tensor, conv_w: Tensor, conv_b: Tensor,
                   D: Tensor, h0: Optional[Tensor], conv_state: Optional[Tensor],
                   norm_weight: Optional[Tensor], norm_eps: float, chunk_size: int,
                   nheads: int, hdim: int, ngroups: int, d_state: int,
                   checkpoints: bool = False) -> Tuple:
    """The kernels' span in plain PyTorch, with their rounding points.
    zx (B, L, >= Di + CD): z at columns [0, Di), [x B C] at [Di, Di + CD);
    dt_p (B, L, H) post-softplus. Returns (gated (B, L, Di) in zx.dtype,
    h_last (B, H, P, N) fp32), and with ``checkpoints`` also (hins (B, nc,
    H, P, N), yd (B, L, Di)), fp32."""
    cdt = zx.dtype
    bsz, seqlen, _ = zx.shape
    di, gn = nheads * hdim, ngroups * d_state
    cd = di + 2 * gn
    width = conv_w.shape[1]
    cst = (conv_state.to(cdt) if conv_state is not None
           else zx.new_zeros((bsz, cd, width)))
    pre, _ = conv_pre(zx[..., di:di + cd], conv_w, conv_b.float(), cst)
    cy = F.silu(pre)  # (B, L, CD) fp32
    dtf, s = decay_cumsum(dt_p, A, int(chunk_size))
    y, h, hins = walk_plain(
        cy[..., :di].reshape(bsz, seqlen, nheads, hdim),
        cy[..., di:di + gn].reshape(bsz, seqlen, ngroups, d_state),
        cy[..., di + gn:].reshape(bsz, seqlen, ngroups, d_state),
        dtf, s, h0, D, cdt, chunk_size)
    y = y.reshape(bsz, seqlen, di)
    gated = gate_plain(y, zx[..., :di], norm_weight, norm_eps).to(cdt)
    if checkpoints:
        return gated, h, hins, y
    return gated, h


def ssd_mixer_plain(
    zxbcdt: Tensor,
    A: Tensor,
    conv_weight: Tensor,
    conv_bias: Optional[Tensor],
    D: Tensor,
    dt_bias: Optional[Tensor],
    initial_state: Optional[Tensor] = None,
    conv_state: Optional[Tensor] = None,
    norm_weight: Optional[Tensor] = None,
    norm_eps: float = 1e-5,
    chunk_size: int = 128,
    nheads: int = 0,
    hdim: int = 0,
    ngroups: int = 1,
    d_state: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K12 with the kernel's rounding points (the
    JAX ``ssd_mixer_pallas`` contract). zxbcdt (B, L, 2 Di + 2 G N + H);
    conv_weight (CD, W), the module's layout; conv_state (B, CD, W);
    initial_state (B, H, P, N). Returns (gated (B, L, Di) in zxbcdt.dtype,
    h_last (B, H, P, N) fp32)."""
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    dt_p = _prepare_dt(zxbcdt[..., di + cd:di + cd + nheads], dt_bias, True)
    conv_b = conv_bias if conv_bias is not None else zxbcdt.new_zeros(cd, dtype=torch.float32)
    return ssd_core_plain(zxbcdt, dt_p, A, conv_weight, conv_b, D, initial_state, conv_state,
                          norm_weight, norm_eps, chunk_size, nheads, hdim, ngroups, d_state)


def core_operands(kernel: str, zx: Tensor, dt_p: Tensor, A: Tensor, conv_weight: Tensor,
                  conv_bias: Optional[Tensor], D: Tensor, initial_state: Optional[Tensor],
                  conv_state: Optional[Tensor], norm_weight: Optional[Tensor],
                  chunk_size: int, nheads: int, hdim: int, ngroups: int, d_state: int,
                  seqlen: int) -> dict:
    """The chunk walk's operands as the C entries take them, checked, and
    its scratch: the fp32 (B, Lp, H) dt and decay cumsum, fp32 conv taps,
    bias, window (rounded to the compute dtype first), D, norm weight and h0,
    and the output, h_last, conv, y and entry-state buffers."""
    if not ssd_kernel_supported(nheads, hdim, ngroups, d_state, chunk_size):
        raise ValueError(
            f"{kernel} kernel: head dim {hdim} and d_state {d_state} must be multiples "
            f"of 4, chunk {chunk_size} positive, {ngroups} groups must divide {nheads} "
            f"heads and {chunk_smem_bytes(chunk_size)} <= "
            f"{MAX_SMEM_BYTES} bytes of chunk tiles")
    dev, cdt = zx.device, zx.dtype
    bsz = zx.shape[0]
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    width = conv_weight.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    dtf, s = decay_cumsum(dt_p, A, chunk_size)
    ops = dict(
        conv_w=conv_weight.float().contiguous(),
        conv_b=(conv_bias.float().contiguous() if conv_bias is not None
                else torch.zeros(cd, **f32)),
        conv_state=(conv_state.to(cdt).float().contiguous() if conv_state is not None
                    else torch.zeros((bsz, cd, width), **f32)),
        D=D.float().contiguous(),
        norm_w=norm_weight.float().contiguous() if norm_weight is not None else None,
        h0=(initial_state.float().contiguous() if initial_state is not None
            else torch.zeros((bsz, nheads, hdim, d_state), **f32)),
        dt=dtf, s=s,
    )
    _build.check_operands(
        kernel, dev,
        {"conv_w": (ops["conv_w"], (cd, width)), "conv_b": (ops["conv_b"], (cd,)),
         "conv_state": (ops["conv_state"], (bsz, cd, width)), "D": (ops["D"], (nheads,)),
         "norm_w": (ops["norm_w"], (di,)), "h0": (ops["h0"], (bsz, nheads, hdim, d_state)),
         "dt": (dtf, tuple(dtf.shape)), "s": (s, tuple(s.shape))},
    )
    nc = s.shape[1] // chunk_size
    ops.update(
        gated=torch.empty((bsz, seqlen, di), dtype=cdt, device=dev),
        h_last=torch.empty((bsz, nheads, hdim, d_state), **f32),
        cy=torch.empty((bsz * seqlen * cd,), **f32),
        y=torch.empty((bsz * seqlen * di,), **f32),
        hin=torch.empty((bsz * nc * nheads * hdim * d_state,), **f32),
        cb=torch.empty((cb_scratch_elems(bsz, s.shape[1], chunk_size, ngroups),), **f32),
    )
    return ops


def core_args(ops: dict, chunk_size: int, nheads: int, hdim: int, ngroups: int,
              d_state: int, norm_eps: float, bsz: int, seqlen: int) -> tuple:
    """The trailing arguments every chunk-walk C entry takes, in order."""
    p = _build.ptr
    return (p(ops["conv_state"]), p(ops["conv_w"]), p(ops["conv_b"]), p(ops["s"]),
            p(ops["dt"]), p(ops["D"]), p(ops["norm_w"]), p(ops["h0"]), p(ops["h_last"]),
            p(ops["cy"]), p(ops["y"]), p(ops["hin"]), p(ops["cb"]), bsz, seqlen, chunk_size,
            nheads, hdim, ngroups, d_state, ops["conv_w"].shape[1], norm_eps)


def ssd_mixer_core(zx: Tensor, dt_p: Tensor, A: Tensor, conv_weight: Tensor,
                   conv_bias: Optional[Tensor], D: Tensor, initial_state: Optional[Tensor],
                   conv_state: Optional[Tensor], norm_weight: Optional[Tensor],
                   norm_eps: float, chunk_size: int, nheads: int, hdim: int, ngroups: int,
                   d_state: int, checkpoints: bool = False) -> Tuple:
    """K12 with dt given post-softplus (B, L, H), the contract of
    :func:`ssd_core_plain`: with ``checkpoints`` it also returns (hins (B,
    nc, H, P, N), yd (B, L, Di)) fp32, the walk's own buffers."""
    if dispatch.runs_plain(zx):
        conv_b = conv_bias if conv_bias is not None else zx.new_zeros(
            conv_weight.shape[0], dtype=torch.float32)
        return ssd_core_plain(zx, dt_p, A, conv_weight, conv_b, D, initial_state, conv_state,
                              norm_weight, norm_eps, chunk_size, nheads, hdim, ngroups,
                              d_state, checkpoints)
    bsz, seqlen, dpj = zx.shape
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    if dpj < di + cd:
        raise ValueError(f"ssd_mixer kernel: zxbcdt has {dpj} columns, expected at least "
                         f"{di + cd}")
    _build.check_operands("ssd_mixer", zx.device, {"zxbcdt": (zx, (bsz, seqlen, dpj))},
                          dtypes={"zxbcdt": _build.FP32_OR_BF16})
    ld = _build.row_stride(zx, "ssd_mixer zxbcdt")
    ops = core_operands("ssd_mixer", zx, dt_p, A, conv_weight, conv_bias, D,
                        initial_state, conv_state, norm_weight, chunk_size, nheads, hdim,
                        ngroups, d_state, seqlen)
    if bsz == 0 or seqlen == 0:
        ops["h_last"].copy_(ops["h0"])
    else:
        err = _build.library().vmt_ssd_mixer(
            _build.ptr(zx), ld, _build.ptr(ops["gated"]),
            *core_args(ops, chunk_size, nheads, hdim, ngroups, d_state, norm_eps, bsz,
                       seqlen),
            _build.is_bf16(zx), zx.device.index, _build.stream_of(zx),
        )
        _build.check(err, "ssd_mixer")
        ssd_mixer.launches += 1
    if checkpoints:
        return ops["gated"], ops["h_last"], *walk_checkpoints(ops, bsz, seqlen, nheads,
                                                              hdim, d_state)
    return ops["gated"], ops["h_last"]


def walk_checkpoints(ops: dict, bsz: int, seqlen: int, nheads: int, hdim: int,
                     d_state: int) -> Tuple[Tensor, Tensor]:
    """The walk's hin and y buffers after a launch, as (hins (B, nc, H, P,
    N), yd (B, L, Di)): the training forward's checkpoints."""
    return (ops["hin"].view(bsz, -1, nheads, hdim, d_state),
            ops["y"].view(bsz, seqlen, nheads * hdim))


def ssd_mixer(
    zxbcdt: Tensor,
    A: Tensor,
    conv_weight: Tensor,
    conv_bias: Optional[Tensor],
    D: Tensor,
    dt_bias: Optional[Tensor],
    initial_state: Optional[Tensor] = None,
    conv_state: Optional[Tensor] = None,
    norm_weight: Optional[Tensor] = None,
    norm_eps: float = 1e-5,
    chunk_size: int = 128,
    nheads: int = 0,
    hdim: int = 0,
    ngroups: int = 1,
    d_state: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Kernel wrapper with the contract of :func:`ssd_mixer_plain`.

    On CUDA: zxbcdt fp32 or bf16 with rows of unit stride (a view of a
    wider tensor is fine); every other operand of any float dtype, read as
    fp32 (the window first rounded to zxbcdt's dtype)."""
    if dispatch.runs_plain(zxbcdt):
        return ssd_mixer_plain(zxbcdt, A, conv_weight, conv_bias, D, dt_bias,
                               initial_state, conv_state, norm_weight, norm_eps, chunk_size,
                               nheads, hdim, ngroups, d_state)
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    if zxbcdt.shape[-1] != di + cd + nheads:
        raise ValueError(f"ssd_mixer kernel: zxbcdt has {zxbcdt.shape[-1]} columns, expected "
                         f"{di + cd + nheads}")
    dt_p = _prepare_dt(zxbcdt[..., di + cd:], dt_bias, True)
    return ssd_mixer_core(zxbcdt, dt_p, A, conv_weight, conv_bias, D, initial_state,
                          conv_state, norm_weight, norm_eps, chunk_size, nheads, hdim,
                          ngroups, d_state)


ssd_mixer.launches = 0
