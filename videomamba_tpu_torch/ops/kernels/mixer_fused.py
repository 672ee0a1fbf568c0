"""K3: fused Mamba-1 mixer core (conv, x_proj, dt_proj, scan, gate).

Replaces videomamba_tpu/ops/pallas/mixer_fused.py (mixer_fused_pallas ->
_mixer_fused_jit, ``_mixer_kernel`` / ``_mixer_kernel_pipelined``). The TPU
kernel holds the whole span in one body because VMEM fits a time block of
every intermediate; a Hopper block has 227 KB of shared memory and the
x_proj contraction crosses all channels while the walk is parallel over
them. So csrc/mixer_fused.cu runs the span as hand-written launches on the
current stream — causal conv + SiLU, x_proj and dt_proj as product tiles
(the TPU kernel computes both products in its body, so no library GEMM), and
the forward walk split over time chunks (csrc/scan_walk_split.cuh: chunk
states, a pass over the chunks, the output walk) — through fp32 scratch this
wrapper allocates. The TPU kernel walks time in order; here the chunk length
(:func:`~videomamba_tpu_torch.ops.kernels.scan.walk_chunk`) is chosen so the
walk's grid holds four blocks per SM at batch 1.

Precision follows the TPU kernel (mixer_fused.py:121-127): fp32 weights are
its ``highest`` route (fp32 FMA tiles, nothing rounded); bf16 weights round
the conv output to bf16 before x_proj and x_dbl's dt columns before dt_proj
(bf16 ``mma.sync`` tiles, fp32 accumulate). x and z are fp32 or bf16; y
comes back in x's dtype, h_last and the checkpoints in fp32.
``checkpoints=True`` also returns the walk's 16-step segment-start states,
(B, ceil(L/16), Di, N), for the backward (ops/kernels/mixer_bwd.py).

Weights are taken in the module's own torch layout: conv_w (Di, W),
x_proj_w (R + 2N, Di) with rows [dt | B | C], dt_proj_w (Di, R).
"""

from __future__ import annotations

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.scan import (
    check_x_proj,
    pad_state,
    pad_x_proj,
    unpad,
    walk_scratch,
    walk_state,
    num_segments,
    selective_scan_plain,
)

Tensor = torch.Tensor


def project(cy: Tensor, w: Tensor) -> Tensor:
    """cy @ w.T with fp32 accumulation, cy first rounded to w's dtype (the
    TPU kernel's cast of each product input to the weight dtype)."""
    return cy.to(w.dtype).float() @ w.float().t()


def mixer_fused_plain(
    x: Tensor,
    z: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    x_proj_w: Tensor,
    dt_proj_w: Tensor,
    dt_bias: Tensor,
    A: Tensor,
    D: Tensor,
    h0: Tensor,
    conv_state: Tensor,
    checkpoints: bool = False,
):
    """Plain PyTorch version: conv, two products, sequential scan, with the
    kernel's rounding points.

    x, z: (B, L, Di); conv_state (B, Di, W) raw inputs; h0 (B, Di, N).
    Returns (y (B, L, Di) in x.dtype, h_last (B, Di, N) fp32), and with
    ``checkpoints`` the segment-start states.
    """
    r = dt_proj_w.shape[1]
    n = A.shape[1]
    conv_out = causal_conv1d(
        x.float(), conv_w.t(), conv_b, activation="silu",
        initial_state=conv_state,
    )
    x_dbl = project(conv_out, x_proj_w)
    delta = project(x_dbl[..., :r], dt_proj_w)
    out = selective_scan_plain(
        conv_out, delta, A, x_dbl[..., r:r + n], x_dbl[..., r + n:], D, z,
        dt_bias, h0, softplus_delta=True, checkpoints=checkpoints,
    )
    return (out[0].to(x.dtype),) + tuple(out[1:])


def mixer_fused(
    x: Tensor,
    z: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    x_proj_w: Tensor,
    dt_proj_w: Tensor,
    dt_bias: Tensor,
    A: Tensor,
    D: Tensor,
    h0: Tensor,
    conv_state: Tensor,
    checkpoints: bool = False,
):
    """Kernel wrapper with the contract of :func:`mixer_fused_plain`.

    x and z may be the two halves of in_proj's output (row-strided views).
    On CUDA x and z share one dtype and the four conv / projection weights
    another (fp32 or bf16 each); dt_bias, A, D and h0 are fp32; conv_state
    (fp32 or bf16) is read as fp32.
    """
    if dispatch.runs_plain(x):
        return mixer_fused_plain(
            x, z, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, h0,
            conv_state, checkpoints,
        )
    bsz, seqlen, di = x.shape
    width = conv_w.shape[1]
    r = dt_proj_w.shape[1]
    n = A.shape[1]
    check_x_proj("mixer_fused", x_proj_w, r, n)
    npad = walk_state(n, "mixer_fused")
    if npad != n:
        out = mixer_fused(x, z, conv_w, conv_b, pad_x_proj(x_proj_w, r, n, npad), dt_proj_w,
                          dt_bias, pad_state(A, npad), D, pad_state(h0, npad), conv_state,
                          checkpoints)
        return (out[0], *(unpad(t, n) for t in out[1:]))
    weights = {"conv_w": (conv_w, (di, width)), "conv_b": (conv_b, (di,)),
               "x_proj_w": (x_proj_w, (r + 2 * n, di)), "dt_proj_w": (dt_proj_w, (di, r))}
    wdt, xdt = _build.one_dtype(x_proj_w), _build.one_dtype(x)
    _build.check_operands(
        "mixer_fused", x.device,
        {"x": (x, (bsz, seqlen, di)), "z": (z, (bsz, seqlen, di)), **weights,
         "dt_bias": (dt_bias, (di,)), "A": (A, (di, n)), "D": (D, (di,)),
         "h0": (h0, (bsz, di, n)), "conv_state": (conv_state, (bsz, di, width))},
        contiguous=("conv_w", "conv_b", "x_proj_w", "dt_proj_w", "dt_bias", "A",
                    "D", "h0"),
        dtypes={"x": xdt, "z": xdt, "conv_state": _build.FP32_OR_BF16,
                **{k: wdt for k in weights}},
    )

    dev = x.device
    y = torch.empty((bsz, seqlen, di), dtype=x.dtype, device=dev)
    h_last = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((bsz, num_segments(seqlen), di, n), dtype=torch.float32,
                        device=dev) if checkpoints else None)
    if bsz == 0 or di == 0 or seqlen == 0:
        h_last.copy_(h0)
        return (y, h_last, ckpt) if checkpoints else (y, h_last)
    conv_out = torch.empty((bsz, seqlen, di), dtype=torch.float32, device=dev)
    delta = torch.empty_like(conv_out)
    x_dbl = torch.empty((bsz, seqlen, r + 2 * n), dtype=torch.float32, device=dev)
    chunk, walk_states, walk_dtsum = walk_scratch(bsz, seqlen, di, n, dev)
    cstate = conv_state.float().contiguous()
    err = _build.library().vmt_mixer_fused(
        _build.ptr(x), _build.row_stride(x, "x"), _build.ptr(z), _build.row_stride(z, "z"),
        _build.ptr(cstate), _build.ptr(conv_w), _build.ptr(conv_b),
        _build.ptr(x_proj_w), _build.ptr(dt_proj_w), _build.ptr(dt_bias),
        _build.ptr(A), _build.ptr(D), _build.ptr(h0), _build.ptr(y),
        _build.ptr(h_last), _build.ptr(ckpt), _build.ptr(conv_out), _build.ptr(x_dbl),
        _build.ptr(delta), _build.ptr(walk_states), _build.ptr(walk_dtsum), chunk,
        _build.is_bf16(x), _build.is_bf16(x_proj_w), bsz, seqlen, di, width, r, n,
        dev.index, _build.stream_of(x),
    )
    _build.check(err, "mixer_fused")
    mixer_fused.launches += 1
    return (y, h_last, ckpt) if checkpoints else (y, h_last)


mixer_fused.launches = 0
