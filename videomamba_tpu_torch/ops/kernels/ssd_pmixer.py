"""K14 (forward): the Mamba-2 projected mixer, in_proj through out_proj, CUDA for Hopper.

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
stream: in_proj on K4's product tiles (bf16 ``mma.sync`` with fp32 sums at
bf16, fp32 FMA tiles at fp32) into a zx buffer in the input dtype, K12's
five launches (csrc/ssd_mixer.cu) writing the gated rows in the input
dtype, and out_proj on the same tiles. The products are written by hand
because the TPU kernel computes them in its body (ssd_block.py:285-286,
323-324). The dt columns' product ``hidden @ Win[-H:]^T`` and its softplus
run outside the kernel in the JAX package too (ssd_block.py:1619) and stay
``torch.matmul`` here.

What bounds it on the H100: operations. At VideoMamba-Base-m2, B = 1, L =
1569 the two products are 7.7 and 3.7 GFLOP and the chunk walk 1.3: about
0.2 ms at fp32's 67 TFLOP/s and 0.014 ms on bf16 tensor cores; the
single-stage FMA tiles and the chunk walk's FMA tiles run far below that.

Rounding (ssd_block.py:286, 323): zx is rounded to the input dtype after
in_proj, the gated rows before out_proj, and out once; in between, K12's.
Forward only: under autograd on the card the call runs as
:class:`SsdPmixerFn`, whose backward raises (K14's backward and K13 are not
ported).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.ssd_mixer import (
    K13_MISSING,
    core_args,
    core_operands,
    ssd_core_plain,
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
    cdt = hidden.dtype
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    dt_p = dt_projection(hidden, in_proj_w, nheads, dt_bias)
    zx = (hidden.float() @ in_proj_w[:di + cd].float().t()).to(cdt)
    conv_b = conv_bias if conv_bias is not None else hidden.new_zeros(cd, dtype=torch.float32)
    gated, h_last = ssd_core_plain(zx, dt_p, A, conv_weight, conv_b, D, initial_state,
                                   conv_state, norm_weight, norm_eps, chunk_size, nheads,
                                   hdim, ngroups, d_state)
    return (gated.float() @ out_proj_w.float().t()).to(cdt), h_last


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
    """Kernel wrapper with the contract of :func:`ssd_pmixer_plain`.

    On CUDA: hidden and both projection weights share one dtype, fp32 or
    bf16, contiguous; the other operands of any float dtype, read as fp32."""
    if dispatch.runs_plain(hidden):
        return ssd_pmixer_plain(hidden, A, in_proj_w, out_proj_w, conv_weight, conv_bias, D,
                                dt_bias, initial_state, conv_state, norm_weight, norm_eps,
                                chunk_size, nheads, hdim, ngroups, d_state)
    bsz, seqlen, e = hidden.shape
    di = nheads * hdim
    cd = di + 2 * ngroups * d_state
    wdt = _build.one_dtype(hidden)
    _build.check_operands(
        "ssd_pmixer", hidden.device,
        {"hidden": (hidden, (bsz, seqlen, e)),
         "in_proj_w": (in_proj_w, (di + cd + nheads, e)),
         "out_proj_w": (out_proj_w, (e, di))},
        contiguous=("hidden", "in_proj_w", "out_proj_w"),
        dtypes={"hidden": wdt, "in_proj_w": wdt, "out_proj_w": wdt},
    )
    dt_p = dt_projection(hidden, in_proj_w, nheads, dt_bias)
    zx = torch.empty((bsz, seqlen, di + cd), dtype=hidden.dtype, device=hidden.device)
    ops = core_operands("ssd_pmixer", zx, dt_p, A, conv_weight, conv_bias, D, initial_state,
                        conv_state, norm_weight, chunk_size, nheads, hdim, ngroups, d_state,
                        seqlen)
    out = torch.empty_like(hidden)
    if bsz == 0 or seqlen == 0:
        ops["h_last"].copy_(ops["h0"])
        return out, ops["h_last"]
    err = _build.library().vmt_ssd_pmixer(
        _build.ptr(hidden), _build.ptr(in_proj_w), _build.ptr(out_proj_w), _build.ptr(out),
        _build.ptr(zx), _build.ptr(ops["gated"]), e,
        *core_args(ops, chunk_size, nheads, hdim, ngroups, d_state, norm_eps, bsz, seqlen),
        _build.is_bf16(hidden), hidden.device.index, _build.stream_of(hidden),
    )
    _build.check(err, "ssd_pmixer")
    ssd_pmixer.launches += 1
    return out, ops["h_last"]


ssd_pmixer.launches = 0


class SsdPmixerFn(torch.autograd.Function):
    """K14 under autograd on the card: the forward is the kernel, the
    backward raises, so a graph through it never ends in ``grad=None``."""

    @staticmethod
    def forward(ctx, hidden, A, in_proj_w, out_proj_w, conv_weight, conv_bias, D, dt_bias,
                initial_state, conv_state, norm_weight, cfg):
        return ssd_pmixer(hidden, A, in_proj_w, out_proj_w, conv_weight, conv_bias, D,
                          dt_bias, initial_state, conv_state, norm_weight, *cfg)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "K14's backward (ssd_block.py _ssd_pmixer_bwd_*) is not ported, nor is "
            + K13_MISSING)
