"""K7: backward of the whole prenorm Block, hand-written CUDA for Hopper.

Replaces videomamba_tpu/ops/pallas/block_bwd.py (block_bwd_pallas,
``_block_bwd_kernel``): every gradient of K4's span (add + norm, in_proj,
conv, x_proj, dt_proj, scan, gate, out_proj) from the forward's fp32 sum
``res_out = f32(hidden) + f32(residual)``, its 16-step scan checkpoints and
the cotangents of out, res_out and h_last. csrc/block_bwd.cu runs it as a
sequence of launches on the current stream through fp32 scratch this wrapper
allocates: the norm recompute (K2's row kernel), in_proj (K4's tiles), the
out_proj cotangent product, K6's whole span (its reverse walk, K5's, also
rebuilds the forward's gated output y for dWout: no forward y is kept), the
dWout / dnormed / dWin products and K8's row backward with the res_out
cotangent added. It is bound by the reverse walk (latency), then the
products (about 30 GFLOP at Base, batch 1, mostly on fp32 FMA tiles).

Rounding at bf16 weights (block_bwd.py:161-206, 324-393): each product's
input is rounded to bf16 and both inputs of each weight-gradient product;
every product accumulates in fp32; z stays fp32 in the walk (the forward's
bf16 gate rounding is not repeated, as in the TPU kernel). With fp32
weights nothing is rounded. There are no floating-point atomics: repeated
runs give bit-identical gradients.

Returns (dres, dnorm_w, dnorm_b, din_proj_w, dout_proj_w, dconv_w, dconv_b,
dx_proj_w, ddt_proj_w, ddt_bias, dA, dD, dh0, dconv_state): dres (B, L, E)
fp32, which the caller fans out to both hidden and residual; dnorm_b is the
row sum of the normed cotangent, which an RMSNorm caller drops; the weight
gradients in their weights' dtypes and the module's torch layouts; dh0
fp32; dconv_state in conv_state's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.fused_add_norm import MAX_D, fused_add_norm_bwd_plain
from videomamba_tpu_torch.ops.kernels.mixer_bwd import _rnd, mixer_bwd_plain
from videomamba_tpu_torch.ops.kernels.mixer_fused import mixer_fused_plain
from videomamba_tpu_torch.ops.kernels.scan import (
    check_x_proj,
    num_segments,
    pad_state,
    pad_x_proj,
    unpad,
    unpad_x_proj,
    walk_state,
)
from videomamba_tpu_torch.ops.norm import layer_norm, rms_norm

Tensor = torch.Tensor


def block_bwd_plain(
    res_out: Tensor,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    x_proj_w: Tensor,
    dt_proj_w: Tensor,
    dt_bias: Tensor,
    A: Tensor,
    D: Tensor,
    conv_state: Tensor,
    ckpt: Tensor,
    g_out: Tensor,
    g_res: Tensor,
    g_hlast: Optional[Tensor],
    norm_type: str = "rms",
    eps: float = 1e-5,
) -> Tuple:
    """Plain PyTorch version of K7 (block_bwd.py:143-436) with the kernel's
    rounding points, built from K6's and K8's plain versions. The gated y
    for dWout is K3's plain forward from the first checkpoint (the initial
    state) with the unrounded fp32 z, the function the kernel's reverse walk
    rebuilds."""
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    wdt = in_proj_w.dtype
    di = in_proj_w.shape[0] // 2
    r32 = res_out.float()
    normed = (rms_norm(r32, norm_w, eps=eps) if norm_type == "rms"
              else layer_norm(r32, norm_w, norm_b, eps=eps))
    mm0 = _rnd(normed, wdt)
    xz = mm0 @ in_proj_w.float().t()
    x, z = xz[..., :di], xz[..., di:]
    g_o = _rnd(g_out, wdt)
    g_y = g_o @ out_proj_w.float()
    h0 = ckpt[:, 0] if ckpt.shape[1] else ckpt.new_zeros((x.shape[0], di, A.shape[1]))
    y = mixer_fused_plain(x, z, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, h0,
                          conv_state)[0]
    dx, dz, *mixer_grads = mixer_bwd_plain(x, z, conv_w, conv_b, x_proj_w, dt_proj_w,
                                           dt_bias, A, D, conv_state, ckpt, g_y, g_hlast)
    dxz = _rnd(torch.cat([dx, dz], dim=-1), wdt)
    dout_proj_w = torch.einsum("ble,bld->ed", g_o, _rnd(y, wdt))
    din_proj_w = torch.einsum("blk,ble->ke", dxz, mm0)
    dnormed = dxz @ in_proj_w.float()
    dres, dnorm_w, dnorm_b, _ = fused_add_norm_bwd_plain(
        r32, norm_w, None, dnormed, g_res, prenorm=True, eps=eps, norm_type=norm_type)
    return (dres, dnorm_w, dnorm_b, din_proj_w.to(wdt), dout_proj_w.to(wdt), *mixer_grads)


def block_bwd(
    res_out: Tensor,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    x_proj_w: Tensor,
    dt_proj_w: Tensor,
    dt_bias: Tensor,
    A: Tensor,
    D: Tensor,
    conv_state: Tensor,
    ckpt: Tensor,
    g_out: Tensor,
    g_res: Tensor,
    g_hlast: Optional[Tensor],
    norm_type: str = "rms",
    eps: float = 1e-5,
) -> Tuple:
    """Kernel wrapper with the contract of :func:`block_bwd_plain`.

    On CUDA: res_out fp32; the five weight tensors in one dtype, fp32 or
    bf16, and g_out read in it; g_res fp32 or bf16; norm weights, dt_bias,
    A, D, ckpt and g_hlast fp32; conv_state (fp32 or bf16) read as fp32."""
    if dispatch.runs_plain(res_out):
        return block_bwd_plain(res_out, norm_w, norm_b, in_proj_w, out_proj_w, conv_w,
                               conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, conv_state,
                               ckpt, g_out, g_res, g_hlast, norm_type=norm_type, eps=eps)
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    bsz, seqlen, e = res_out.shape
    di = in_proj_w.shape[0] // 2
    width = conv_w.shape[1]
    r = dt_proj_w.shape[1]
    n = A.shape[1]
    check_x_proj("block_bwd", x_proj_w, r, n)
    npad = walk_state(n, "block_bwd")
    if npad != n:
        out = list(block_bwd(res_out, norm_w, norm_b, in_proj_w, out_proj_w, conv_w, conv_b,
                             pad_x_proj(x_proj_w, r, n, npad), dt_proj_w, dt_bias,
                             pad_state(A, npad), D, conv_state, pad_state(ckpt, npad), g_out,
                             g_res, pad_state(g_hlast, npad), norm_type=norm_type, eps=eps))
        out[7] = unpad_x_proj(out[7], r, n, npad)
        out[10], out[12] = unpad(out[10], n), unpad(out[12], n)
        return tuple(out)
    if e > MAX_D:
        raise ValueError(f"block_bwd kernel takes d_model <= {MAX_D}, got {e}")
    if width > 8:
        raise ValueError(f"block_bwd kernel takes d_conv <= 8, got {width}")
    if bsz == 0 or seqlen == 0:
        raise ValueError("block_bwd kernel: empty batch or sequence")
    wdt = _build.one_dtype(in_proj_w)
    g_o = g_out.to(in_proj_w.dtype).contiguous()
    g_r = g_res.contiguous()
    norm_b = norm_b if norm_type == "layer" else None  # RMSNorm has no shift
    rows = (bsz, seqlen, e)
    weights = {"in_proj_w": (in_proj_w, (2 * di, e)), "out_proj_w": (out_proj_w, (e, di)),
               "conv_w": (conv_w, (di, width)), "conv_b": (conv_b, (di,)),
               "x_proj_w": (x_proj_w, (r + 2 * n, di)), "dt_proj_w": (dt_proj_w, (di, r))}
    _build.check_operands(
        "block_bwd", res_out.device,
        {"res_out": (res_out, rows), "norm_w": (norm_w, (e,)), "norm_b": (norm_b, (e,)),
         **weights, "dt_bias": (dt_bias, (di,)), "A": (A, (di, n)), "D": (D, (di,)),
         "conv_state": (conv_state, (bsz, di, width)),
         "ckpt": (ckpt, (bsz, num_segments(seqlen), di, n)),
         "g_out": (g_o, rows), "g_res": (g_r, rows), "g_hlast": (g_hlast, (bsz, di, n))},
        contiguous=("res_out", "norm_w", "norm_b", *weights, "dt_bias", "A", "D", "ckpt",
                    "g_hlast"),
        dtypes={"conv_state": _build.FP32_OR_BF16, "g_out": wdt,
                "g_res": _build.FP32_OR_BF16, **{k: wdt for k in weights}},
    )
    dev = res_out.device
    f32 = dict(dtype=torch.float32, device=dev)
    dres = torch.empty(rows, **f32)
    dnorm_w = torch.empty((e,), **f32)
    dnorm_b = torch.empty((e,), **f32)
    din_proj_w = torch.empty((2 * di, e), **f32)
    dout_proj_w = torch.empty((e, di), **f32)
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
    scratch = torch.empty(
        (lib.vmt_block_bwd_scratch_floats(bsz, seqlen, e, di, width, r, n),), **f32)
    cstate = conv_state.float().contiguous()
    err = lib.vmt_block_bwd(
        _build.ptr(res_out), _build.ptr(norm_w), _build.ptr(norm_b), _build.ptr(in_proj_w),
        _build.ptr(out_proj_w), _build.ptr(conv_w), _build.ptr(conv_b),
        _build.ptr(x_proj_w), _build.ptr(dt_proj_w), _build.ptr(dt_bias), _build.ptr(A),
        _build.ptr(D), _build.ptr(cstate), _build.ptr(ckpt), _build.ptr(g_o),
        _build.ptr(g_r), _build.is_bf16(g_r), _build.ptr(g_hlast),
        _build.ptr(dres), _build.ptr(dnorm_w), _build.ptr(dnorm_b), _build.ptr(din_proj_w),
        _build.ptr(dout_proj_w), _build.ptr(dconv_w), _build.ptr(dconv_b),
        _build.ptr(dx_proj_w), _build.ptr(ddt_proj_w), _build.ptr(ddt_bias), _build.ptr(dA),
        _build.ptr(dD), _build.ptr(dh0), _build.ptr(dconv_state), _build.ptr(scratch),
        _build.is_bf16(in_proj_w), bsz, seqlen, e, di, width, r, n, eps,
        int(norm_type == "rms"), dev.index, _build.stream_of(res_out),
    )
    _build.check(err, "block_bwd")
    block_bwd.launches += 1
    return (dres, dnorm_w, dnorm_b, din_proj_w.to(in_proj_w.dtype),
            dout_proj_w.to(out_proj_w.dtype), dconv_w.to(conv_w.dtype),
            dconv_b.to(conv_b.dtype), dx_proj_w.to(x_proj_w.dtype),
            ddt_proj_w.to(dt_proj_w.dtype), ddt_bias, dA, dD, dh0,
            dconv_state.to(conv_state.dtype))


block_bwd.launches = 0
