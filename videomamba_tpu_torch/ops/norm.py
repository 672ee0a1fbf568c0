"""Residual add + (RMS|Layer)Norm with fp32 statistics.

Port of videomamba_tpu/ops/norm.py:

    prenorm=True:  res = x + residual; return (norm(res), res)
    prenorm=False: return norm(x + residual)

Statistics are taken in fp32; the normed output has x's dtype; the returned
residual is fp32 with ``residual_in_fp32``, else x's dtype. ``use_kernel``
(the model's ``fused_add_norm`` flag) routes through the hand-written kernel
(ops/kernels/fused_add_norm.py); otherwise the plain composition runs.
When autograd records the call, the kernel route runs as
:class:`FusedAddNormFn`, the counterpart of the JAX package's
``_fused_add_norm_pallas_vjp`` (norm.py:30-102): K2 forward; backward by
autograd of the plain composition, or K8 under ``VIDEOMAMBA_NORM_BWD=pallas``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Tensor = torch.Tensor


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-5) -> Tensor:
    """RMSNorm over the last axis, fp32 internals, output in x.dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(
    x: Tensor, weight: Tensor, bias: Optional[Tensor] = None, eps: float = 1e-5
) -> Tensor:
    """LayerNorm over the last axis, fp32 internals, output in x.dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def fused_add_norm(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    residual: Optional[Tensor] = None,
    prenorm: bool = False,
    residual_in_fp32: bool = False,
    eps: float = 1e-5,
    norm_type: str = "rms",
    use_kernel: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Residual add followed by normalization, in one logical op.

    Returns normed, or (normed, residual_out) when ``prenorm``.
    """
    # Imported here: the kernel module builds its plain version from the
    # functions above.
    from videomamba_tpu_torch.ops.kernels import fused_add_norm as k

    if use_kernel and torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias, residual)
    ):
        return FusedAddNormFn.apply(x, weight, bias, residual, prenorm,
                                    residual_in_fp32, eps, norm_type)
    fn = k.fused_add_norm if use_kernel else k.fused_add_norm_plain
    return fn(
        x, weight, bias, residual=residual, prenorm=prenorm,
        residual_in_fp32=residual_in_fp32, eps=eps, norm_type=norm_type,
    )


class FusedAddNormFn(torch.autograd.Function):
    """K2 forward; the JAX package's ``_fan_bwd`` (norm.py:49-99) backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, prenorm, residual_in_fp32, eps,
                norm_type):
        from videomamba_tpu_torch.ops.kernels import fused_add_norm as k

        ctx.save_for_backward(x, weight, bias, residual)
        ctx.cfg = (prenorm, residual_in_fp32, eps, norm_type)
        return k.fused_add_norm(
            x, weight, bias, residual=residual, prenorm=prenorm,
            residual_in_fp32=residual_in_fp32, eps=eps, norm_type=norm_type,
        )

    @staticmethod
    def backward(ctx, *cts):
        from videomamba_tpu_torch.ops import dispatch
        from videomamba_tpu_torch.ops.kernels import fused_add_norm as k

        x, weight, bias, residual = ctx.saved_tensors
        prenorm, residual_in_fp32, eps, norm_type = ctx.cfg
        none4 = (None, None, None, None)
        if dispatch.norm_bwd_kernel():
            g_r = cts[1] if prenorm else None
            dx, dw, db, dres = k.fused_add_norm_bwd(
                x, weight, residual, cts[0], g_r, prenorm=prenorm, eps=eps,
                norm_type=norm_type,
            )
            db = db.to(bias.dtype) if bias is not None and norm_type == "layer" else None
            return (dx, dw.to(weight.dtype), db, dres) + none4
        args = (x, weight, bias, residual)
        live = [a.detach().requires_grad_() if a is not None else None for a in args]
        with torch.enable_grad():
            out = k.fused_add_norm_plain(
                live[0], live[1], live[2], residual=live[3], prenorm=prenorm,
                residual_in_fp32=residual_in_fp32, eps=eps, norm_type=norm_type,
            )
        outs = out if prenorm else (out,)
        present = [a for a in live if a is not None]
        grads = iter(torch.autograd.grad(outs, present, cts, allow_unused=True))
        return tuple(next(grads) if a is not None else None for a in live) + none4
