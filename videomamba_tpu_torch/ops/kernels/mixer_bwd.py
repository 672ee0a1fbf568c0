"""K6: backward of the fused Mamba-1 mixer core, hand-written CUDA for Hopper.

Replaces videomamba_tpu/ops/pallas/mixer_bwd.py (mixer_bwd_pallas,
``_mixer_bwd_kernel``): every gradient of K3's span (conv + SiLU, x_proj,
dt_proj, selective scan, D skip, silu(z) gate) from the forward's inputs and
its segment checkpoints. csrc/mixer_bwd.cu runs it as a sequence of launches
on the current stream through fp32 scratch this wrapper allocates: the
recompute of the conv and both products (K3's tiles), the time-split reverse
walk (csrc/scan_walk_split_bwd.cuh: chunk cotangents, a reverse pass over
the chunks, the output walk; the chunk from ``scan.walk_bwd_chunk``) with
the conv output as u, the two products of the cotangents with the projection
weights (its epilogue forms silu'), the conv backward, and the two
weight-gradient products, split over time slices and summed in a fixed
order. The products run on bf16 tensor cores (mma.sync) at bf16 weights and
on fp32 FMA tiles at fp32 (about 2.3 GFLOP at Base, batch 1).

Rounding at bf16 weights (mixer_bwd.py, highest=False): the conv output
before x_proj, x_dbl's dt columns before dt_proj, ddelta_raw before its
product with dt_proj's weight, dxdbl before its product with x_proj's, and
both inputs of each weight-gradient product, every product accumulated in
fp32. With fp32 weights nothing is rounded. There are no floating-point
atomics: repeated runs give bit-identical gradients.

Weights and gradients are in the module's torch layouts: conv_w (Di, W),
x_proj_w (R + 2N, Di) with rows [dt | B | C], dt_proj_w (Di, R); the TPU
kernel's 128-lane packing is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build, scan
from videomamba_tpu_torch.ops.kernels.scan import (
    check_x_proj,
    pad_state,
    pad_x_proj,
    unpad,
    unpad_x_proj,
    walk_state,
    _delta,
    num_segments,
    scan_bwd_core,
)

Tensor = torch.Tensor


def _rnd(t: Tensor, dtype: torch.dtype) -> Tensor:
    """t rounded to ``dtype`` and widened back to fp32."""
    return t.to(dtype).float()


def conv_pre(x: Tensor, conv_w: Tensor, conv_b: Tensor,
             conv_state: Tensor) -> Tuple[Tensor, Tensor]:
    """The causal depthwise conv before its SiLU, fp32, and its input
    context: x (B, L, Di) after the last W - 1 raw inputs of conv_state
    (B, Di, W); conv_w (Di, W)."""
    width = conv_w.shape[1]
    seqlen = x.shape[1]
    ctx = torch.cat([conv_state.float().transpose(1, 2)[:, 1:], x.float()], dim=1)
    w = conv_w.float()
    pre = sum(w[:, k] * ctx[:, k:k + seqlen] for k in range(width))
    return pre + conv_b.float(), ctx


def mixer_bwd_plain(
    x: Tensor,
    z: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    x_proj_w: Tensor,
    dt_proj_w: Tensor,
    dt_bias: Tensor,
    A: Tensor,
    D: Tensor,
    conv_state: Tensor,
    ckpt: Tensor,
    g_y: Tensor,
    g_hlast: Optional[Tensor],
) -> Tuple:
    """Plain PyTorch version of K6 (mixer_bwd.py:140-357), with the kernel's
    rounding points. Returns (dx, dz, dconv_w (Di, W), dconv_b, dx_proj_w
    (R+2N, Di), ddt_proj_w (Di, R), ddt_bias, dA, dD, dh0, dconv_state),
    each in its primal's dtype (dh0 fp32)."""
    r = dt_proj_w.shape[1]
    n = A.shape[1]
    width = conv_w.shape[1]
    seqlen = x.shape[1]
    wdt = x_proj_w.dtype
    rnd = (lambda t: _rnd(t, wdt)) if wdt != torch.float32 else (lambda t: t)
    cy_pre, ctx = conv_pre(x, conv_w, conv_b, conv_state)
    cy = F.silu(cy_pre)
    mm_in = rnd(cy)
    x_dbl = mm_in @ x_proj_w.float().t()
    dt_in = x_dbl[..., :r]
    delta_raw = rnd(dt_in) @ dt_proj_w.float().t()
    dt = _delta(delta_raw, dt_bias, True)
    du, ddelta, dz, dB, dC, dA, dD, dbias, dh0 = scan_bwd_core(
        cy, dt, A.float(), x_dbl[..., r:r + n], x_dbl[..., r + n:], D.float(),
        z.float(), g_y.float(), ckpt, g_hlast, True,
    )
    dxdbl = torch.cat([rnd(ddelta) @ dt_proj_w.float(), dB, dC], dim=-1)
    dcy = du + rnd(dxdbl) @ x_proj_w.float()
    sig = torch.sigmoid(cy_pre)
    dcpre = dcy * (sig * (1.0 + cy_pre * (1.0 - sig)))
    dx_proj_w = torch.einsum("blp,bld->pd", rnd(dxdbl), mm_in)
    ddt_proj_w = torch.einsum("bld,blr->dr", rnd(ddelta), rnd(dt_in))
    # Correlation of dcpre with the taps over the context [state tail || x].
    w = conv_w.float()
    dctx = torch.zeros_like(ctx)
    for k in range(width):
        dctx[:, k:k + seqlen] += w[:, k] * dcpre
    dconv_w = torch.stack([(dcpre * ctx[:, k:k + seqlen]).sum((0, 1))
                           for k in range(width)], dim=1)
    dconv_state = torch.zeros_like(conv_state, dtype=torch.float32)
    dconv_state[:, :, 1:] = dctx[:, :width - 1].transpose(1, 2)
    return (dctx[:, width - 1:].to(x.dtype), dz.to(z.dtype), dconv_w.to(conv_w.dtype),
            dcpre.sum((0, 1)).to(conv_b.dtype), dx_proj_w.to(x_proj_w.dtype),
            ddt_proj_w.to(dt_proj_w.dtype), dbias.to(dt_bias.dtype), dA.to(A.dtype),
            dD.to(D.dtype), dh0, dconv_state.to(conv_state.dtype))


def mixer_bwd(
    x: Tensor,
    z: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    x_proj_w: Tensor,
    dt_proj_w: Tensor,
    dt_bias: Tensor,
    A: Tensor,
    D: Tensor,
    conv_state: Tensor,
    ckpt: Tensor,
    g_y: Tensor,
    g_hlast: Optional[Tensor],
) -> Tuple:
    """Kernel wrapper with the contract of :func:`mixer_bwd_plain`.

    On CUDA: x and z share one dtype and the four conv / projection weights
    another (fp32 or bf16 each); g_y is read in x's dtype; dt_bias, A, D,
    ckpt and g_hlast are fp32; conv_state (fp32 or bf16) is read as fp32."""
    if dispatch.runs_plain(x):
        return mixer_bwd_plain(x, z, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias,
                               A, D, conv_state, ckpt, g_y, g_hlast)
    bsz, seqlen, di = x.shape
    width = conv_w.shape[1]
    r = dt_proj_w.shape[1]
    n = A.shape[1]
    check_x_proj("mixer_bwd", x_proj_w, r, n)
    npad = walk_state(n, "mixer_bwd")
    if npad != n:
        (dx, dz, dcw, dcb, dxp, ddtp, ddtb, dA, dD, dh0, dcst) = mixer_bwd(
            x, z, conv_w, conv_b, pad_x_proj(x_proj_w, r, n, npad), dt_proj_w, dt_bias,
            pad_state(A, npad), D, conv_state, pad_state(ckpt, npad), g_y,
            pad_state(g_hlast, npad))
        return (dx, dz, dcw, dcb, unpad_x_proj(dxp, r, n, npad), ddtp, ddtb, unpad(dA, n),
                dD, unpad(dh0, n), dcst)
    if bsz == 0 or seqlen == 0:
        raise ValueError("mixer_bwd kernel: empty batch or sequence")
    g = g_y.to(x.dtype).contiguous()
    weights = {"conv_w": (conv_w, (di, width)), "conv_b": (conv_b, (di,)),
               "x_proj_w": (x_proj_w, (r + 2 * n, di)), "dt_proj_w": (dt_proj_w, (di, r))}
    wdt, xdt = _build.one_dtype(x_proj_w), _build.one_dtype(x)
    rows = (bsz, seqlen, di)
    _build.check_operands(
        "mixer_bwd", x.device,
        {"x": (x, rows), "z": (z, rows), "g_y": (g, rows), **weights,
         "dt_bias": (dt_bias, (di,)), "A": (A, (di, n)), "D": (D, (di,)),
         "conv_state": (conv_state, (bsz, di, width)),
         "ckpt": (ckpt, (bsz, num_segments(seqlen), di, n)),
         "g_hlast": (g_hlast, (bsz, di, n))},
        contiguous=("g_y", *weights, "dt_bias", "A", "D", "ckpt", "g_hlast"),
        dtypes={"x": xdt, "z": xdt, "g_y": xdt, "conv_state": _build.FP32_OR_BF16,
                **{k: wdt for k in weights}},
    )
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(rows, dtype=x.dtype, device=dev)
    dz = torch.empty(rows, dtype=z.dtype, device=dev)
    dconv_w = torch.empty((di, width), **f32)
    dconv_b = torch.empty((di,), **f32)
    dx_proj_w = torch.empty((r + 2 * n, di), **f32)
    ddt_proj_w = torch.empty((di, r), **f32)
    ddt_bias = torch.empty((di,), **f32)
    dA = torch.empty((di, n), **f32)
    dD = torch.empty((di,), **f32)
    dh0 = torch.empty((bsz, di, n), **f32)
    dconv_state = torch.empty((bsz, di, width), **f32)
    lib = _build.library()
    chunk = scan.walk_bwd_chunk(bsz, seqlen, di)
    scratch = torch.empty(
        (lib.vmt_mixer_bwd_scratch_floats(bsz, seqlen, di, width, r, n, chunk),), **f32)
    cstate = conv_state.float().contiguous()
    err = lib.vmt_mixer_bwd(
        _build.ptr(x), _build.row_stride(x, "x"), _build.ptr(z), _build.row_stride(z, "z"),
        _build.ptr(cstate), _build.ptr(conv_w), _build.ptr(conv_b), _build.ptr(x_proj_w),
        _build.ptr(dt_proj_w), _build.ptr(dt_bias), _build.ptr(A), _build.ptr(D),
        _build.ptr(ckpt), _build.ptr(g), _build.ptr(g_hlast),
        _build.ptr(dx), _build.ptr(dz), _build.ptr(dconv_w), _build.ptr(dconv_b),
        _build.ptr(dx_proj_w), _build.ptr(ddt_proj_w), _build.ptr(ddt_bias),
        _build.ptr(dA), _build.ptr(dD), _build.ptr(dh0), _build.ptr(dconv_state),
        _build.ptr(scratch), _build.is_bf16(x), _build.is_bf16(x_proj_w),
        bsz, seqlen, di, width, r, n, chunk, dev.index, _build.stream_of(x),
    )
    _build.check(err, "mixer_bwd")
    mixer_bwd.launches += 1
    return (dx, dz, dconv_w.to(conv_w.dtype), dconv_b.to(conv_b.dtype),
            dx_proj_w.to(x_proj_w.dtype), ddt_proj_w.to(dt_proj_w.dtype),
            ddt_bias.to(dt_bias.dtype), dA.to(A.dtype), dD.to(D.dtype), dh0,
            dconv_state.to(conv_state.dtype))


mixer_bwd.launches = 0
