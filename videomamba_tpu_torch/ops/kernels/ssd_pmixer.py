"""K14: the Mamba-2 projected mixer, in_proj through out_proj, CUDA for Hopper.

Replaces the forward of videomamba_tpu/ops/pallas/ssd_block.py
(ssd_projected_mixer: the per-head ``_ssd_pmixer_fwd_padded`` ->
``_ssd_pmixer_kernel`` and the merged ``_ssd_pmixer_fwd_merged`` ->
``_ssd_pmixer_fwd_merged_kernel``): for the normed block input (B, L, E),
in_proj, then K12's span (conv + SiLU, the SSD chunk walk, D skip, silu(z)
gate, gated RMSNorm), then out_proj; it returns (out (B, L, E) in the input
dtype, h_last (B, H, P, N) fp32).

The TPU kernel keeps both weights in VMEM (about 10 MB at Base fp32) and
runs the two products on its idle MXU slots. A Hopper block has 227 KB of
shared memory, so csrc/ssd_pmixer.cu runs the span as launches on one
stream: in_proj into a zx buffer in the input dtype, K12's six launches
(csrc/ssd_mixer.cu) writing the gated rows in the input dtype, and
out_proj. The products run on K4's bf16 ``mma.sync`` tile (fp32 sums) at
bf16 and on the wide fp32 FMA tile at fp32 (csrc/mixer_parts.cuh
``gemm_nt_wide``: a 64 x 64 block tile, an outer product from
contraction-major shared tiles, K slices double-buffered through
registers). The products are written by hand because the TPU kernel
computes them in its body (ssd_block.py:285-286, 323-324). The dt
columns' product ``hidden @ Win[-H:]^T`` and its softplus run outside the
kernel in the JAX package too (ssd_block.py:1619) and stay
``torch.matmul`` here.

What bounds it on the H100: operations. At VideoMamba-Base-m2, B = 1, L =
1569 the two products are 7.7 and 3.7 GFLOP and the chunk walk 1.3: about
0.2 ms at fp32's 67 TFLOP/s and 0.014 ms on bf16 tensor cores.

Rounding (ssd_block.py:286, 323): zx is rounded to the input dtype after
in_proj, the gated rows before out_proj, and out once; in between, K12's.

Training under ``VIDEOMAMBA_SSD_TRAIN_ROUTE=pmixer`` (:class:`SsdPmixerFn`,
the JAX package's ``_pmixer_vjp_fwd`` / ``_pmixer_vjp_bwd`` on that route)
runs K14's forward with the walk's checkpoints and K14's backward,
csrc/ssd_pmixer_bwd.cu (:func:`ssd_pmixer_bwd`: in_proj recomputed,
out_proj's two gradients, K13's span, in_proj's two gradients, on K4's and
K6/K7's product tiles). On the default "mixer" route a differentiated layer
takes K12 and K13 between ``torch.matmul`` projections
(models/mamba2.py ``Mamba2._kernel_route``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.ssd_mixer import (
    core_args,
    core_operands,
    gate_plain,
    ssd_core_plain,
    walk_checkpoints,
)
from videomamba_tpu_torch.ops.kernels.ssd_mixer_bwd import (
    SPLIT_ROWS,
    _like,
    bwd_args,
    bwd_operands,
    bwd_results,
    ssd_mixer_bwd_plain,
)
from videomamba_tpu_torch.ops.ssd import _prepare_dt

Tensor = torch.Tensor

# The JAX package's routing rule (ssd_block.py:48-64): d_model a multiple of
# 128 and the TPU kernel's VMEM budget for the weights and the backward's
# fp32 accumulators. Kept so both packages route a layer alike.
PMIXER_BUDGET_BYTES = 48 * 1024 * 1024


def pmixer_route_ok(d_model: int, nheads: int, hdim: int, ngroups: int, d_state: int,
                    weight_bytes_per_el: int) -> bool:
    """The JAX package's width and byte rule for the projected-mixer route."""
    if d_model % 128:
        return False
    d_inner = nheads * hdim
    dpj = 2 * d_inner + 2 * ngroups * d_state + nheads
    wbytes = (d_model * dpj + d_inner * d_model) * weight_bytes_per_el
    accbytes = (d_model * dpj + d_inner * d_model) * 4
    return wbytes + accbytes <= PMIXER_BUDGET_BYTES


def dt_projection(hidden: Tensor, in_proj_w: Tensor, nheads: int, dt_bias: Optional[Tensor]
                  ) -> Tensor:
    """softplus(hidden @ Win[-H:]^T + dt_bias), fp32 (B, L, H): the dt
    columns, outside the kernel as in the JAX package."""
    return _prepare_dt(hidden @ in_proj_w[-nheads:].t(), dt_bias, True)


def ssd_pmixer_core_plain(hidden: Tensor, dt_p: Tensor, A: Tensor, in_proj_w: Tensor,
                          out_proj_w: Tensor, conv_weight: Tensor,
                          conv_bias: Optional[Tensor], D: Tensor,
                          initial_state: Optional[Tensor], conv_state: Optional[Tensor],
                          norm_weight: Optional[Tensor], norm_eps: float, chunk_size: int,
                          nheads: int, hdim: int, ngroups: int, d_state: int,
                          checkpoints: bool = False) -> Tuple:
    """K14's forward in plain PyTorch with dt given post-softplus (B, L, H);
    with ``checkpoints`` it also returns (hins, yd), as K12's."""
    cdt = hidden.dtype
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    zx = (hidden.float() @ in_proj_w[:di + cd].float().t()).to(cdt)
    conv_b = conv_bias if conv_bias is not None else hidden.new_zeros(cd, dtype=torch.float32)
    gated, h_last, *ckpt = ssd_core_plain(zx, dt_p, A, conv_weight, conv_b, D, initial_state,
                                          conv_state, norm_weight, norm_eps, chunk_size,
                                          nheads, hdim, ngroups, d_state, checkpoints)
    return ((gated.float() @ out_proj_w.float().t()).to(cdt), h_last, *ckpt)


def ssd_pmixer_plain(
    hidden: Tensor,
    A: Tensor,
    in_proj_w: Tensor,
    out_proj_w: Tensor,
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
    """Plain PyTorch version of K14's forward with the kernel's rounding
    points. hidden (B, L, E); in_proj_w (2 Di + 2 G N + H, E) and out_proj_w
    (E, Di), the module's layouts; the rest as :func:`ssd_mixer_plain`.
    Returns (out (B, L, E) in hidden.dtype, h_last (B, H, P, N) fp32)."""
    dt_p = dt_projection(hidden, in_proj_w, nheads, dt_bias)
    return ssd_pmixer_core_plain(hidden, dt_p, A, in_proj_w, out_proj_w, conv_weight,
                                 conv_bias, D, initial_state, conv_state, norm_weight,
                                 norm_eps, chunk_size, nheads, hdim, ngroups, d_state)


def _check_projections(kernel: str, hidden: Tensor, in_proj_w: Tensor, out_proj_w: Tensor,
                       di: int, cd: int, nheads: int, dout: Optional[Tensor] = None) -> None:
    bsz, seqlen, e = hidden.shape
    wdt = _build.one_dtype(hidden)
    _build.check_operands(
        kernel, hidden.device,
        {"hidden": (hidden, (bsz, seqlen, e)),
         "in_proj_w": (in_proj_w, (di + cd + nheads, e)),
         "out_proj_w": (out_proj_w, (e, di)), "dout": (dout, (bsz, seqlen, e))},
        contiguous=("hidden", "in_proj_w", "out_proj_w", "dout"),
        dtypes={"hidden": wdt, "in_proj_w": wdt, "out_proj_w": wdt, "dout": wdt},
    )


def ssd_pmixer_core(hidden: Tensor, dt_p: Tensor, A: Tensor, in_proj_w: Tensor,
                    out_proj_w: Tensor, conv_weight: Tensor, conv_bias: Optional[Tensor],
                    D: Tensor, initial_state: Optional[Tensor], conv_state: Optional[Tensor],
                    norm_weight: Optional[Tensor], norm_eps: float, chunk_size: int,
                    nheads: int, hdim: int, ngroups: int, d_state: int,
                    checkpoints: bool = False) -> Tuple:
    """K14's forward with dt given, the contract of
    :func:`ssd_pmixer_core_plain`. On CUDA: hidden and both projection
    weights share one dtype, fp32 or bf16, contiguous; the other operands of
    any float dtype, read as fp32."""
    if dispatch.runs_plain(hidden):
        return ssd_pmixer_core_plain(hidden, dt_p, A, in_proj_w, out_proj_w, conv_weight,
                                     conv_bias, D, initial_state, conv_state, norm_weight,
                                     norm_eps, chunk_size, nheads, hdim, ngroups, d_state,
                                     checkpoints)
    bsz, seqlen, e = hidden.shape
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    _check_projections("ssd_pmixer", hidden, in_proj_w, out_proj_w, di, cd, nheads)
    zx = torch.empty((bsz, seqlen, di + cd), dtype=hidden.dtype, device=hidden.device)
    ops = core_operands("ssd_pmixer", zx, dt_p, A, conv_weight, conv_bias, D, initial_state,
                        conv_state, norm_weight, chunk_size, nheads, hdim, ngroups, d_state,
                        seqlen)
    out = torch.empty_like(hidden)
    if bsz == 0 or seqlen == 0:
        ops["h_last"].copy_(ops["h0"])
    else:
        err = _build.library().vmt_ssd_pmixer(
            _build.ptr(hidden), _build.ptr(in_proj_w), _build.ptr(out_proj_w),
            _build.ptr(out), _build.ptr(zx), _build.ptr(ops["gated"]), e,
            *core_args(ops, chunk_size, nheads, hdim, ngroups, d_state, norm_eps, bsz,
                       seqlen),
            _build.is_bf16(hidden), hidden.device.index, _build.stream_of(hidden),
        )
        _build.check(err, "ssd_pmixer")
        ssd_pmixer.launches += 1
    if checkpoints:
        return out, ops["h_last"], *walk_checkpoints(ops, bsz, seqlen, nheads, hdim, d_state)
    return out, ops["h_last"]


def ssd_pmixer(
    hidden: Tensor,
    A: Tensor,
    in_proj_w: Tensor,
    out_proj_w: Tensor,
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
    """Kernel wrapper with the contract of :func:`ssd_pmixer_plain`."""
    if dispatch.runs_plain(hidden):
        return ssd_pmixer_plain(hidden, A, in_proj_w, out_proj_w, conv_weight, conv_bias, D,
                                dt_bias, initial_state, conv_state, norm_weight, norm_eps,
                                chunk_size, nheads, hdim, ngroups, d_state)
    dt_p = dt_projection(hidden, in_proj_w, nheads, dt_bias)
    return ssd_pmixer_core(hidden, dt_p, A, in_proj_w, out_proj_w, conv_weight, conv_bias, D,
                           initial_state, conv_state, norm_weight, norm_eps, chunk_size,
                           nheads, hdim, ngroups, d_state)


ssd_pmixer.launches = 0


def ssd_pmixer_bwd_plain(hidden: Tensor, dt_p: Tensor, A: Tensor, in_proj_w: Tensor,
                         out_proj_w: Tensor, conv_weight: Tensor, conv_bias: Optional[Tensor],
                         D: Tensor, conv_state: Optional[Tensor],
                         norm_weight: Optional[Tensor], norm_eps: float, hins: Tensor,
                         yd: Tensor, dout: Tensor, dhlast: Optional[Tensor], chunk_size: int,
                         nheads: int, hdim: int, ngroups: int, d_state: int) -> Tuple:
    """Plain PyTorch version of K14's backward with its rounding points
    (ssd_block.py _ssd_pmixer_bwd_kernel). Returns (dhidden in hidden's
    dtype, ddt (B, L, H), dA, dconv_state or None, dWin (2 Di + 2 G N + H,
    E) with zero dt rows, dWout (E, Di), dconv_w, dconv_b, dh0, dD, dnorm
    or None), fp32 but dhidden."""
    cdt = hidden.dtype
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    zx = (hidden.float() @ in_proj_w[:di + cd].float().t()).to(cdt)
    gated = gate_plain(yd.float(), zx[..., :di], norm_weight, norm_eps).to(cdt)
    rows = hidden.shape[0] * hidden.shape[1]
    dwout = dout.float().reshape(rows, -1).t() @ gated.float().reshape(rows, -1)
    dgated = dout.float() @ out_proj_w.float()
    dzx, ddt, dA, dcst, dcw, dcb, dh0, dD, dnw = ssd_mixer_bwd_plain(
        zx, dt_p, A, conv_weight, conv_bias, D, conv_state, norm_weight, norm_eps, hins, yd,
        dgated, dhlast, chunk_size, nheads, hdim, ngroups, d_state)
    dhidden = (dzx.float() @ in_proj_w[:di + cd].float()).to(cdt)
    dwin = torch.zeros(in_proj_w.shape, dtype=torch.float32, device=hidden.device)
    dwin[:di + cd] = dzx.float().reshape(rows, -1).t() @ hidden.float().reshape(rows, -1)
    return dhidden, ddt, dA, dcst, dwin, dwout, dcw, dcb, dh0, dD, dnw


def ssd_pmixer_bwd(hidden: Tensor, dt_p: Tensor, A: Tensor, in_proj_w: Tensor,
                   out_proj_w: Tensor, conv_weight: Tensor, conv_bias: Optional[Tensor],
                   D: Tensor, conv_state: Optional[Tensor], norm_weight: Optional[Tensor],
                   norm_eps: float, hins: Tensor, yd: Tensor, dout: Tensor,
                   dhlast: Optional[Tensor], chunk_size: int, nheads: int, hdim: int,
                   ngroups: int, d_state: int) -> Tuple:
    """Kernel wrapper with the contract of :func:`ssd_pmixer_bwd_plain`. On
    CUDA: hidden, dout and both weights share one dtype, contiguous; hins and
    yd fp32 from K14's checkpointed forward."""
    if dispatch.runs_plain(hidden):
        return ssd_pmixer_bwd_plain(hidden, dt_p, A, in_proj_w, out_proj_w, conv_weight,
                                    conv_bias, D, conv_state, norm_weight, norm_eps, hins, yd,
                                    dout, dhlast, chunk_size, nheads, hdim, ngroups, d_state)
    bsz, seqlen, e = hidden.shape
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    if bsz == 0 or seqlen == 0:
        raise ValueError("ssd_pmixer_bwd kernel: an empty batch or sequence")
    _check_projections("ssd_pmixer_bwd", hidden, in_proj_w, out_proj_w, di, cd, nheads, dout)
    dev, cdt = hidden.device, hidden.dtype
    zx = torch.empty((bsz, seqlen, di + cd), dtype=cdt, device=dev)
    ops = bwd_operands("ssd_pmixer_bwd", zx, dt_p, A, conv_weight, conv_bias, D, conv_state,
                       norm_weight, hins, yd, dhlast, chunk_size, nheads, hdim, ngroups,
                       d_state, seqlen)
    rows = bsz * seqlen
    f32 = dict(dtype=torch.float32, device=dev)
    gated = torch.empty((rows, di), dtype=cdt, device=dev)
    dgated = torch.empty((rows, di), **f32)
    dzx = torch.empty((rows, di + cd), dtype=cdt, device=dev)
    dhidden = torch.empty((rows, e), **f32)
    dwin = torch.zeros(in_proj_w.shape, **f32)
    dwout = torch.empty((e, di), **f32)
    part = torch.empty(-(-rows // SPLIT_ROWS) * max((di + cd) * e, e * di), **f32)
    has = (conv_state is not None, norm_weight is not None)
    err = _build.library().vmt_ssd_pmixer_bwd(
        *(_build.ptr(t) for t in (hidden, in_proj_w, out_proj_w, dout, zx, gated, dgated,
                                  dzx, dhidden, dwin, dwout, part)),
        e, *bwd_args(ops, chunk_size, nheads, hdim, ngroups, d_state, norm_eps, bsz, seqlen),
        _build.is_bf16(hidden), dev.index, _build.stream_of(hidden))
    _build.check(err, "ssd_pmixer_bwd")
    ssd_pmixer_bwd.launches += 1
    ddt, dA, dcst, dcw, dcb, dh0, dD, dnw = bwd_results(ops, A, int(chunk_size), nheads, hdim,
                                                        seqlen, *has)
    return (dhidden.view(bsz, seqlen, e).to(cdt), ddt, dA, dcst, dwin, dwout, dcw, dcb, dh0,
            dD, dnw)


ssd_pmixer_bwd.launches = 0


class SsdPmixerFn(torch.autograd.Function):
    """K14 under autograd, the VIDEOMAMBA_SSD_TRAIN_ROUTE=pmixer route: K14's
    checkpointed forward and K14's backward (their plain versions on CPU
    tensors). dt_p enters post-softplus: autograd carries the dt columns'
    product, softplus and dt_bias."""

    @staticmethod
    def forward(ctx, hidden, dt_p, A, in_proj_w, out_proj_w, conv_weight, conv_bias, D, h0,
                conv_state, norm_weight, cfg):
        ctx.set_materialize_grads(False)
        ctx.cfg = cfg
        out, h_last, hins, yd = ssd_pmixer_core(hidden, dt_p, A, in_proj_w, out_proj_w,
                                                conv_weight, conv_bias, D, h0, conv_state,
                                                norm_weight, *cfg, checkpoints=True)
        ctx.save_for_backward(hidden, dt_p, A, in_proj_w, out_proj_w, conv_weight, conv_bias,
                              D, h0, conv_state, norm_weight, hins, yd)
        return out, h_last

    @staticmethod
    def backward(ctx, dout, dhlast):
        (hidden, dt_p, A, in_w, out_w, conv_w, conv_b, D, h0, conv_state, norm_w, hins,
         yd) = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(hidden)
        dhidden, ddt, dA, dcst, dwin, dwout, dcw, dcb, dh0, dD, dnw = ssd_pmixer_bwd(
            hidden, dt_p, A, in_w, out_w, conv_w, conv_b, D, conv_state, norm_w, ctx.cfg[0],
            hins, yd, dout.to(hidden.dtype).contiguous(), dhlast, *ctx.cfg[1:])
        return (dhidden, ddt.to(dt_p.dtype), dA.to(A.dtype), dwin.to(in_w.dtype),
                dwout.to(out_w.dtype), dcw.to(conv_w.dtype), _like(dcb, conv_b), dD.to(D.dtype),
                _like(dh0, h0), _like(dcst, conv_state), _like(dnw, norm_w), None)
