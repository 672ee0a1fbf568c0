"""K13: the Mamba-2 (SSD) mixer backward, CUDA for Hopper, and the mixer's
autograd Function.

Replaces videomamba_tpu/ops/pallas/ssd_scan.py (the per-head
``_ssd_mixer_bwd_padded`` -> ``_ssd_mixer_bwd_kernel`` and the merged
``_ssd_mixer_bwd_merged`` -> ``_ssd_mixer_bwd_merged_kernel``, driven by
``_mixer_vjp_bwd_fused``): every gradient of K12's span from its training
forward's checkpoints (each chunk's entry state ``hins`` and the pre-gate y
``yd``) and the cotangents of the gated rows and of h_last. It returns
dzxbcdt (zero in the dt columns: dt enters post-softplus, so softplus and
dt_bias are autograd's, outside), ddt, dA, the conv window's, taps' and
bias' gradients, dh0, dD and the norm weight's gradient.

csrc/ssd_mixer_bwd.cu runs it as launches on the current stream (the conv
recompute, the epilogue backward, the reverse chunk walk of
csrc/ssd_core_bwd.cu, the conv backward; design in its header note). The
short decay chains (``_decay_chain_grads``) and the sums of the per-block
partials of dD and the norm weight's gradient are torch ops here, as the
JAX package keeps them in XLA. There are no floating-point atomics: two
runs give bit-identical gradients.

``VIDEOMAMBA_SSD_BWD=composite`` selects the JAX package's composite
backward instead (``_mixer_vjp_bwd``): a torch recompute of the conv and
autograd of the epilogue around K11's backward (ops/kernels/ssd_core.py).

Rounding: the per-head arm's (see csrc/ssd_core_bwd.cu), every sum fp32,
dzx rounded once to zx's dtype. The JAX merged arm sums the heads' dcb
before rounding it: at bf16 the two arms differ within 2e-2.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.mixer_bwd import conv_pre
from videomamba_tpu_torch.ops.kernels.ssd_core import (
    bwd_buffers,
    decay_chain,
    scan_bwd_plain,
    ssd_scan_bwd,
    walk_ds,
)
from videomamba_tpu_torch.ops.kernels.ssd_mixer import (
    decay_cumsum,
    ssd_kernel_supported,
    ssd_mixer_core,
)
from videomamba_tpu_torch.ops.norm import rms_norm

Tensor = torch.Tensor

EPI_ROWS = 16  # rows a block of the epilogue launch takes (csrc kSsdEpiRows)
SPLIT_ROWS = 256  # rows of a conv-gradient slice (csrc/mixer_bwd.cuh kSplitRows)


def _dsilu(pre: Tensor) -> Tensor:
    sig = torch.sigmoid(pre)
    return sig * (1.0 + pre * (1.0 - sig))


def ssd_mixer_bwd_plain(zx: Tensor, dt_p: Tensor, A: Tensor, conv_weight: Tensor,
                        conv_bias: Optional[Tensor], D: Tensor,
                        conv_state: Optional[Tensor], norm_weight: Optional[Tensor],
                        norm_eps: float, hins: Tensor, yd: Tensor, dout: Tensor,
                        dhlast: Optional[Tensor], chunk_size: int, nheads: int, hdim: int,
                        ngroups: int, d_state: int) -> Tuple:
    """Plain PyTorch version of K13 with its rounding points. zx (B, L, >=
    Di + CD) as K12 took it, dt_p (B, L, H) post-softplus, conv_weight (CD,
    W), conv_state (B, CD, W) or None, hins and yd from the checkpointed
    forward, dout (B, L, Di) and dhlast (B, H, P, N) or None the cotangents.
    Returns (dzx like zx in its dtype, ddt (B, L, H), dA (H,), dconv_state
    or None, dconv_w (CD, W), dconv_b (CD,), dh0 (B, H, P, N), dD (H,),
    dnorm_weight (Di,) or None), fp32 but dzx."""
    cdt = zx.dtype
    bsz, seqlen, dpj = zx.shape
    di, gn = nheads * hdim, ngroups * d_state
    cd = di + 2 * gn
    width = conv_weight.shape[1]
    q = int(chunk_size)
    cst = (conv_state.to(cdt).float() if conv_state is not None
           else zx.new_zeros((bsz, cd, width), dtype=torch.float32))
    conv_b = conv_bias.float() if conv_bias is not None else zx.new_zeros(cd, dtype=torch.float32)
    pre, ctx = conv_pre(zx[..., di:di + cd], conv_weight, conv_b, cst)
    cy = F.silu(pre)

    # The epilogue at the stored pre-gate y: silu(z) gate and gated RMSNorm.
    z = zx[..., :di].float()
    sig = torch.sigmoid(z)
    silu = z * sig
    ydf = yd.float()
    gate = ydf * silu
    do = dout.float()
    dnw = None
    if norm_weight is not None:
        r = torch.rsqrt(gate.square().mean(-1, keepdim=True) + norm_eps)
        dnw = (do * (gate * r)).sum((0, 1))
        dxn = do * norm_weight.float()
        dot = (dxn * gate).sum(-1, keepdim=True)
        dgate = dxn * r - gate * (r * r * r / di) * dot
    else:
        dgate = do
    dyd = dgate * silu
    dz = dgate * ydf * (sig * (1.0 + z * (1.0 - sig)))
    x_f = cy[..., :di]
    dD = (dyd * x_f).sum((0, 1)).reshape(nheads, hdim).sum(-1)

    dtf, s = decay_cumsum(dt_p, A, q)
    dx, dB, dC, ds, ddt, dh0 = scan_bwd_plain(
        x_f.reshape(bsz, seqlen, nheads, hdim),
        cy[..., di:di + gn].reshape(bsz, seqlen, ngroups, d_state),
        cy[..., di + gn:].reshape(bsz, seqlen, ngroups, d_state),
        dtf, s, hins, dyd.reshape(bsz, seqlen, nheads, hdim), dhlast, D, cdt, q)
    ddt, dA = decay_chain(ds, ddt, A, dtf, q, seqlen)

    # The conv backward through SiLU, over the context [window tail || raw].
    dxbc = torch.cat([dx.reshape(bsz, seqlen, di), dB.reshape(bsz, seqlen, gn),
                      dC.reshape(bsz, seqlen, gn)], dim=-1)
    dcpre = dxbc * _dsilu(pre)
    w = conv_weight.float()
    dctx = torch.zeros_like(ctx)
    for k in range(width):
        dctx[:, k:k + seqlen] += w[:, k] * dcpre
    dconv_w = torch.stack([(dcpre * ctx[:, k:k + seqlen]).sum((0, 1)) for k in range(width)],
                          dim=1)
    dconv_state = None
    if conv_state is not None:
        dconv_state = torch.zeros_like(cst)
        dconv_state[:, :, 1:] = dctx[:, :width - 1].transpose(1, 2)
    dzx = torch.cat([dz, dctx[:, width - 1:], z.new_zeros((bsz, seqlen, dpj - di - cd))],
                    dim=-1).to(cdt)
    return dzx, ddt, dA, dconv_state, dconv_w, dcpre.sum((0, 1)), dh0, dD, dnw


def bwd_operands(kernel: str, zx: Tensor, dt_p: Tensor, A: Tensor, conv_weight: Tensor,
                 conv_bias: Optional[Tensor], D: Tensor, conv_state: Optional[Tensor],
                 norm_weight: Optional[Tensor], hins: Tensor, yd: Tensor,
                 dhlast: Optional[Tensor], chunk_size: int, nheads: int, hdim: int,
                 ngroups: int, d_state: int, seqlen: int) -> dict:
    """K13's inputs as the C entries take them, checked (the fp32 dt and
    decay cumsum, taps, bias, window rounded to zx's dtype, D, norm weight,
    checkpoints and dhlast), and its outputs and scratch."""
    if not ssd_kernel_supported(nheads, hdim, ngroups, d_state, chunk_size):
        raise ValueError(
            f"{kernel} kernel: head dim {hdim} and d_state {d_state} must be multiples of 4, "
            f"chunk {chunk_size} positive and {ngroups} groups must divide {nheads} heads")
    dev, cdt = zx.device, zx.dtype
    bsz = zx.shape[0]
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    width = conv_weight.shape[1]
    q = int(chunk_size)
    f32 = dict(dtype=torch.float32, device=dev)
    dtf, s = decay_cumsum(dt_p, A, q)
    lp = dtf.shape[1]
    ops = dict(
        conv_state=(conv_state.to(cdt).float().contiguous() if conv_state is not None
                    else torch.zeros((bsz, cd, width), **f32)),
        conv_w=conv_weight.float().contiguous(),
        conv_b=(conv_bias.float().contiguous() if conv_bias is not None
                else torch.zeros(cd, **f32)),
        s=s, dt=dtf, D=D.float().contiguous(),
        norm_w=norm_weight.float().contiguous() if norm_weight is not None else None,
        hins=hins, yd=yd,
        dhlast=dhlast.float().contiguous() if dhlast is not None else None,
    )
    _build.check_operands(
        kernel, dev,
        {"conv_w": (ops["conv_w"], (cd, width)), "D": (ops["D"], (nheads,)),
         "norm_w": (ops["norm_w"], (di,)),
         "hins": (hins, (bsz, lp // q, nheads, hdim, d_state)), "yd": (yd, (bsz, seqlen, di)),
         "dhlast": (ops["dhlast"], (bsz, nheads, hdim, d_state))},
        contiguous=("hins", "yd"),
    )
    rows = bsz * seqlen
    ops.update(bwd_buffers(bsz, seqlen, lp, q, nheads, hdim, ngroups, d_state, dev))
    ops.update(
        dconv_state=torch.empty((bsz, cd, width), **f32),
        dconv_w=torch.empty((cd, width), **f32),
        dconv_b=torch.empty(cd, **f32),
        part_nw=torch.empty((-(-rows // EPI_ROWS), di), **f32),
        part_dD=torch.empty((-(-rows // EPI_ROWS), di), **f32),
        cy=torch.empty((rows, cd), **f32),
        cpre=torch.empty((rows, cd), **f32),
        dyd=torch.empty((rows, di), **f32),
        conv_part=torch.empty((-(-rows // SPLIT_ROWS), width + 1, cd), **f32),
    )
    return ops


def bwd_args(ops: dict, chunk_size: int, nheads: int, hdim: int, ngroups: int,
             d_state: int, norm_eps: float, bsz: int, seqlen: int) -> tuple:
    """The arguments every mixer-backward C entry takes after its own, in order."""
    p = _build.ptr
    names = ("conv_state", "conv_w", "conv_b", "s", "dt", "D", "norm_w", "hins", "yd",
             "dhlast", "dh0", "dconv_state", "dconv_w", "dconv_b", "part_nw", "part_dD",
             "cy", "cpre", "dyd", "dxbc", "g", "dbh", "dch", "dsq", "dsk", "ddt", "dslast",
             "conv_part", "cb")
    return (*(p(ops[k]) for k in names), bsz, seqlen, int(chunk_size), nheads, hdim, ngroups,
            d_state, ops["conv_w"].shape[1], norm_eps)


def bwd_results(ops: dict, A: Tensor, chunk_size: int, nheads: int, hdim: int,
                seqlen: int, has_state: bool, has_norm: bool) -> tuple:
    """(ddt, dA, dconv_state, dconv_w, dconv_b, dh0, dD, dnorm_weight) from
    a launch's buffers: the decay chains and the partials' sums, in torch."""
    ddt, dA = decay_chain(walk_ds(ops, chunk_size), ops["ddt"], A, ops["dt"], chunk_size,
                          seqlen)
    dD = ops["part_dD"].sum(0).view(nheads, hdim).sum(-1)
    dnw = ops["part_nw"].sum(0) if has_norm else None
    return (ddt, dA, ops["dconv_state"] if has_state else None, ops["dconv_w"],
            ops["dconv_b"], ops["dh0"], dD, dnw)


def ssd_mixer_bwd(zx: Tensor, dt_p: Tensor, A: Tensor, conv_weight: Tensor,
                  conv_bias: Optional[Tensor], D: Tensor, conv_state: Optional[Tensor],
                  norm_weight: Optional[Tensor], norm_eps: float, hins: Tensor, yd: Tensor,
                  dout: Tensor, dhlast: Optional[Tensor], chunk_size: int, nheads: int,
                  hdim: int, ngroups: int, d_state: int) -> Tuple:
    """Kernel wrapper with the contract of :func:`ssd_mixer_bwd_plain`. On
    CUDA: zx fp32 or bf16 with rows of unit stride, dout (B, L, Di) in its
    dtype; hins and yd fp32 from K12's checkpointed forward."""
    if dispatch.runs_plain(zx):
        return ssd_mixer_bwd_plain(zx, dt_p, A, conv_weight, conv_bias, D, conv_state,
                                   norm_weight, norm_eps, hins, yd, dout, dhlast, chunk_size,
                                   nheads, hdim, ngroups, d_state)
    bsz, seqlen, dpj = zx.shape
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    cdt = zx.dtype
    if dpj != di + cd + nheads:
        raise ValueError(f"ssd_mixer_bwd kernel: zxbcdt has {dpj} columns, expected "
                         f"{di + cd + nheads}")
    if bsz == 0 or seqlen == 0:
        raise ValueError("ssd_mixer_bwd kernel: an empty batch or sequence")
    _build.check_operands("ssd_mixer_bwd", zx.device,
                          {"zxbcdt": (zx, (bsz, seqlen, dpj)), "dout": (dout, (bsz, seqlen, di))},
                          contiguous=("dout",),
                          dtypes={"zxbcdt": _build.FP32_OR_BF16, "dout": (cdt,)})
    ld = _build.row_stride(zx, "ssd_mixer_bwd zxbcdt")
    ops = bwd_operands("ssd_mixer_bwd", zx, dt_p, A, conv_weight, conv_bias, D, conv_state,
                       norm_weight, hins, yd, dhlast, chunk_size, nheads, hdim, ngroups,
                       d_state, seqlen)
    dzx = torch.empty((bsz, seqlen, dpj), dtype=cdt, device=zx.device)
    has = (conv_state is not None, norm_weight is not None)
    err = _build.library().vmt_ssd_mixer_bwd(
        _build.ptr(zx), ld, _build.ptr(dout), _build.ptr(dzx), dpj,
        *bwd_args(ops, chunk_size, nheads, hdim, ngroups, d_state, norm_eps, bsz, seqlen),
        _build.is_bf16(zx), zx.device.index, _build.stream_of(zx))
    _build.check(err, "ssd_mixer_bwd")
    ssd_mixer_bwd.launches += 1
    return (dzx, *bwd_results(ops, A, int(chunk_size), nheads, hdim, seqlen, *has))


ssd_mixer_bwd.launches = 0


def ssd_mixer_bwd_composite(zx: Tensor, dt_p: Tensor, A: Tensor, conv_weight: Tensor,
                            conv_bias: Optional[Tensor], D: Tensor,
                            conv_state: Optional[Tensor], norm_weight: Optional[Tensor],
                            norm_eps: float, hins: Tensor, yd: Tensor, dout: Tensor,
                            dhlast: Optional[Tensor], chunk_size: int, nheads: int, hdim: int,
                            ngroups: int, d_state: int) -> Tuple:
    """The JAX package's composite mixer backward (``_mixer_vjp_bwd``), the
    contract of :func:`ssd_mixer_bwd_plain`: the conv recomputed under
    autograd, autograd of the gate and norm at the stored pre-gate y, the D
    skip split off, K11's backward for the scan (its plain version on CPU
    tensors), then the conv's vjp."""
    cdt = zx.dtype
    bsz, seqlen, dpj = zx.shape
    di, gn = nheads * hdim, ngroups * d_state
    cd = di + 2 * gn
    width = conv_weight.shape[1]
    gs = (bsz, seqlen, ngroups, d_state)
    cst = conv_state if conv_state is not None else zx.new_zeros((bsz, cd, width))
    conv_b = conv_bias if conv_bias is not None else zx.new_zeros(cd, dtype=torch.float32)
    leaves = [t.detach().requires_grad_() for t in (zx[..., di:di + cd], conv_weight, conv_b, cst)]
    epi = [t.detach().requires_grad_() for t in (yd, zx[..., :di])]
    if norm_weight is not None:
        epi.append(norm_weight.detach().requires_grad_())
    with torch.enable_grad():
        xbc = causal_conv1d(leaves[0], leaves[1].t(), leaves[2], activation="silu",
                            initial_state=leaves[3])
        gated = epi[0].float() * F.silu(epi[1].float())
        if norm_weight is not None:
            gated = rms_norm(gated, epi[2], eps=norm_eps)
        gated = gated.to(cdt)
    epi_grads = torch.autograd.grad(gated, epi, dout)
    dyd, dz = epi_grads[0].float(), epi_grads[1]
    dnw = epi_grads[2] if norm_weight is not None else None
    x4 = xbc.detach()[..., :di].reshape(bsz, seqlen, nheads, hdim)
    dyd4 = dyd.reshape(bsz, seqlen, nheads, hdim)
    dD = (dyd4 * x4.float()).sum((0, 1, 3))
    dx, ddt, dA, dB, dC, dh0 = ssd_scan_bwd(
        x4, dt_p, A, xbc.detach()[..., di:di + gn].reshape(gs),
        xbc.detach()[..., di + gn:].reshape(gs), hins, dyd4, dhlast, chunk_size)
    dx = dx + dyd4 * D.float()[:, None]
    dxbc = torch.cat([dx.reshape(bsz, seqlen, di), dB.reshape(bsz, seqlen, gn),
                      dC.reshape(bsz, seqlen, gn)], dim=-1).to(xbc.dtype)
    draw, dcw, dcb, dcst = torch.autograd.grad(xbc, leaves, dxbc)
    dzx = torch.cat([dz.to(cdt), draw.to(cdt),
                     zx.new_zeros((bsz, seqlen, dpj - di - cd))], dim=-1)
    return (dzx, ddt, dA, dcst if conv_state is not None else None, dcw, dcb, dh0, dD, dnw)


def mixer_backward(*args) -> Tuple:
    """K13 (the default), or the composite backward under
    VIDEOMAMBA_SSD_BWD=composite; the arguments of :func:`ssd_mixer_bwd`."""
    fn = ssd_mixer_bwd if dispatch.ssd_bwd_fused_enabled() else ssd_mixer_bwd_composite
    return fn(*args)


def _like(t: Optional[Tensor], ref: Optional[Tensor]) -> Optional[Tensor]:
    """t in ref's dtype, or None when there is no primal."""
    return None if ref is None or t is None else t.to(ref.dtype)


class SsdMixerFn(torch.autograd.Function):
    """K12 under autograd: the forward keeps the walk's checkpoints (hins,
    yd), the backward is K13 or the composite backward (their plain
    versions on CPU tensors). dt_p enters post-softplus, so autograd carries
    softplus, dt_bias and the dt columns of in_proj."""

    @staticmethod
    def forward(ctx, zx, dt_p, A, conv_weight, conv_bias, D, h0, conv_state, norm_weight, cfg):
        ctx.set_materialize_grads(False)
        norm_eps, chunk, nheads, hdim, ngroups, d_state = cfg
        gated, h_last, hins, yd = ssd_mixer_core(
            zx, dt_p, A, conv_weight, conv_bias, D, h0, conv_state, norm_weight, norm_eps,
            chunk, nheads, hdim, ngroups, d_state, checkpoints=True)
        ctx.save_for_backward(zx, dt_p, A, conv_weight, conv_bias, D, h0, conv_state,
                              norm_weight, hins, yd)
        ctx.cfg = cfg
        return gated, h_last

    @staticmethod
    def backward(ctx, dgated, dhlast):
        (zx, dt_p, A, conv_weight, conv_bias, D, h0, conv_state, norm_weight, hins,
         yd) = ctx.saved_tensors
        norm_eps, chunk, nheads, hdim, ngroups, d_state = ctx.cfg
        bsz, seqlen = zx.shape[:2]
        if dgated is None:
            dgated = zx.new_zeros((bsz, seqlen, nheads * hdim))
        dzx, ddt, dA, dcst, dcw, dcb, dh0, dD, dnw = mixer_backward(
            zx, dt_p, A, conv_weight, conv_bias, D, conv_state, norm_weight, norm_eps, hins,
            yd, dgated.to(zx.dtype).contiguous(), dhlast, chunk, nheads, hdim, ngroups,
            d_state)
        return (dzx, ddt.to(dt_p.dtype), dA.to(A.dtype), dcw.to(conv_weight.dtype),
                _like(dcb, conv_bias), dD.to(D.dtype), _like(dh0, h0), _like(dcst, conv_state),
                _like(dnw, norm_weight), None)
