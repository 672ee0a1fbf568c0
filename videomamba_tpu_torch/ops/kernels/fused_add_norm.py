"""K2: fused residual add + RMS/LayerNorm and K8: its backward, CUDA for Hopper.

Replaces videomamba_tpu/ops/pallas/fused_add_norm.py (fused_add_norm_pallas,
``_kernel``). The kernel is csrc/fused_add_norm.cu: one warp per row, the row
kept in shared memory between its single read and its writes, statistics in
fp32 with warp shuffles (the row kernel is csrc/add_norm.cuh, which K4's
first launch shares). It is bound by device memory (two rows read, two
written, a few flops per element), which is why it reads and writes each
element once. Any row width D: a block holds four rows in shared memory,
fewer where they do not fit, and a row too wide for shared memory is read
again for each pass. x (and so normed) is fp32 or bf16, and so is the
residual, on its own: at bf16 the final norm gets a bf16 x and an fp32
residual. The returned residual is fp32 under ``residual_in_fp32``, else
x's dtype, as in the JAX package. Any other dtype on CUDA raises.

K8 replaces fused_add_norm.py (fused_add_norm_bwd_pallas, ``_bwd_kernel``):
dx, dresidual, dweight and dbias in one pass, csrc/fused_add_norm_bwd.cu.
It shares K2's row layout (one warp per row, the row in shared memory) and
is bound by device memory the same way; dweight and dbias go to one partial
row per block and a second launch sums them in a fixed order (no atomics).
"""

from __future__ import annotations

from typing import Optional

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.norm import layer_norm, rms_norm

Tensor = torch.Tensor

def fused_add_norm_plain(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    residual: Optional[Tensor] = None,
    prenorm: bool = False,
    residual_in_fp32: bool = False,
    eps: float = 1e-5,
    norm_type: str = "rms",
):
    """Plain PyTorch version of the kernel (videomamba_tpu/ops/norm.py:170-187)."""
    if residual is not None:
        residual_out = x.float() + residual.float()
    else:
        residual_out = x.float()
    if norm_type == "rms":
        normed = rms_norm(residual_out, weight, eps=eps)
    elif norm_type == "layer":
        normed = layer_norm(residual_out, weight, bias, eps=eps)
    else:
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    normed = normed.to(x.dtype)
    if not prenorm:
        return normed
    if not residual_in_fp32:
        residual_out = residual_out.to(x.dtype)
    return normed, residual_out


def fused_add_norm(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    residual: Optional[Tensor] = None,
    prenorm: bool = False,
    residual_in_fp32: bool = False,
    eps: float = 1e-5,
    norm_type: str = "rms",
):
    """Kernel wrapper: same contract as :func:`fused_add_norm_plain`.

    x, residual: (..., D) fp32 or bf16, contiguous, on one CUDA device;
    weight and bias (D,) fp32. Returns fresh tensors; never synchronises.
    """
    if dispatch.runs_plain(x):
        return fused_add_norm_plain(
            x, weight, bias, residual=residual, prenorm=prenorm,
            residual_in_fp32=residual_in_fp32, eps=eps, norm_type=norm_type,
        )
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    d = x.shape[-1]
    bias = bias if norm_type == "layer" else None  # RMSNorm has no shift
    _build.check_operands(
        "fused_add_norm", x.device,
        {"x": (x, x.shape), "residual": (residual, x.shape),
         "weight": (weight, (d,)), "bias": (bias, (d,))},
        contiguous=("x", "residual", "weight", "bias"),
        dtypes={"x": _build.FP32_OR_BF16, "residual": _build.FP32_OR_BF16},
    )

    out = torch.empty_like(x)
    res_dtype = torch.float32 if residual_in_fp32 else x.dtype
    res_out = torch.empty_like(x, dtype=res_dtype) if prenorm else None
    m = x.numel() // d if d else 0
    if m:
        err = _build.library().vmt_fused_add_norm(
            _build.ptr(x), _build.is_bf16(x), _build.ptr(residual),
            _build.is_bf16(residual), _build.ptr(weight), _build.ptr(bias),
            _build.ptr(out), _build.ptr(res_out), _build.is_bf16(res_out), m, d,
            eps, int(norm_type == "rms"), x.device.index, _build.stream_of(x),
        )
        _build.check(err, "fused_add_norm")
        fused_add_norm.launches += 1
    return (out, res_out) if prenorm else out


fused_add_norm.launches = 0


def fused_add_norm_bwd_plain(
    x: Tensor,
    weight: Tensor,
    residual: Optional[Tensor],
    g_out: Tensor,
    g_resout: Optional[Tensor],
    prenorm: bool = False,
    eps: float = 1e-5,
    norm_type: str = "rms",
):
    """Plain PyTorch version of K8 (fused_add_norm.py:134-177), fp32.

    Returns (dx in x's dtype, dweight (D,) fp32, dbias (D,) fp32 — the raw
    row sum of g_out, dropped by the caller without a bias — and dresidual
    in the residual's dtype, None without a residual)."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    r = x32 + residual.float().reshape(-1, d) if residual is not None else x32
    g = g_out.float().reshape(-1, d)
    if norm_type == "rms":
        inv = torch.rsqrt(r.square().mean(-1, keepdim=True) + eps)
        cen = r
    elif norm_type == "layer":
        cen = r - r.mean(-1, keepdim=True)
        inv = torch.rsqrt(cen.square().mean(-1, keepdim=True) + eps)
    else:
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    dweight = (g * (cen * inv)).sum(0)
    dbias = g.sum(0)
    dn = g * weight.float()
    dot = (dn * cen).sum(-1, keepdim=True)
    dr = dn * inv - cen * inv ** 3 * (dot / d)
    if norm_type == "layer":
        dr = dr - dr.mean(-1, keepdim=True)
    if prenorm and g_resout is not None:
        dr = dr + g_resout.float().reshape(-1, d)
    dr = dr.reshape(x.shape)
    dres = dr.to(residual.dtype) if residual is not None else None
    return dr.to(x.dtype), dweight, dbias, dres


def fused_add_norm_bwd(
    x: Tensor,
    weight: Tensor,
    residual: Optional[Tensor],
    g_out: Tensor,
    g_resout: Optional[Tensor],
    prenorm: bool = False,
    eps: float = 1e-5,
    norm_type: str = "rms",
):
    """Kernel wrapper with the contract of :func:`fused_add_norm_bwd_plain`.

    On CUDA: x (fp32 or bf16) with g_out in its dtype, the residual and
    g_resout each fp32 or bf16, weight (D,) fp32."""
    if dispatch.runs_plain(x):
        return fused_add_norm_bwd_plain(x, weight, residual, g_out, g_resout,
                                        prenorm=prenorm, eps=eps, norm_type=norm_type)
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    d = x.shape[-1]
    g = g_out.to(x.dtype).contiguous()
    g_r = g_resout.contiguous() if (prenorm and g_resout is not None) else None
    _build.check_operands(
        "fused_add_norm_bwd", x.device,
        {"x": (x, x.shape), "residual": (residual, x.shape), "g_out": (g, x.shape),
         "g_resout": (g_r, x.shape), "weight": (weight, (d,))},
        contiguous=("x", "residual", "g_out", "g_resout", "weight"),
        dtypes={"x": _build.FP32_OR_BF16, "residual": _build.FP32_OR_BF16,
                "g_out": _build.FP32_OR_BF16, "g_resout": _build.FP32_OR_BF16},
    )
    dev = x.device
    dx = torch.empty_like(x)
    dres = torch.empty_like(residual) if residual is not None else None
    dweight = torch.empty((d,), dtype=torch.float32, device=dev)
    dbias = torch.empty_like(dweight)
    m = x.numel() // d if d else 0
    if m == 0:
        dweight.zero_()
        dbias.zero_()
        return dx, dweight, dbias, dres
    lib = _build.library()
    part = torch.empty((lib.vmt_fused_add_norm_bwd_blocks(m), 2, d),
                       dtype=torch.float32, device=dev)
    err = lib.vmt_fused_add_norm_bwd(
        _build.ptr(x), _build.is_bf16(x), _build.ptr(residual), _build.is_bf16(residual),
        _build.ptr(weight), _build.ptr(g), _build.ptr(g_r), _build.is_bf16(g_r),
        _build.ptr(dx), _build.ptr(dres), _build.ptr(dweight), _build.ptr(dbias),
        _build.ptr(part), m, d, eps, int(norm_type == "rms"), dev.index,
        _build.stream_of(x),
    )
    _build.check(err, "fused_add_norm_bwd")
    fused_add_norm_bwd.launches += 1
    return dx, dweight, dbias, dres


fused_add_norm_bwd.launches = 0
