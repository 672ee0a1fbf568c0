"""Residual add + (RMS|Layer)Norm with fp32 statistics.

Port of videomamba_tpu/ops/norm.py:

    prenorm=True:  res = x + residual; return (norm(res), res)
    prenorm=False: return norm(x + residual)

Statistics are taken in fp32; the normed output has x's dtype; the returned
residual is fp32 with ``residual_in_fp32``, else x's dtype. ``use_kernel``
(the model's ``fused_add_norm`` flag) routes through the hand-written kernel
(ops/kernels/fused_add_norm.py); otherwise the plain composition runs.
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

    fn = k.fused_add_norm if use_kernel else k.fused_add_norm_plain
    return fn(
        x, weight, bias, residual=residual, prenorm=prenorm,
        residual_in_fp32=residual_in_fp32, eps=eps, norm_type=norm_type,
    )
