"""K4: the whole prenorm Block (add + norm, in_proj, mixer core, out_proj).

Replaces videomamba_tpu/ops/pallas/block_fused.py (block_fused_pallas ->
_block_fused_jit -> ``_block_kernel_pipelined``, the serving form). The TPU
kernel keeps all five weight matrices resident in VMEM and streams time
blocks past them; a Hopper block has 227 KB of shared memory, and the
x_proj contraction crosses every channel while the walk runs in parallel
over channels. So csrc/block_fused.cu runs the span as seven hand-written
launches on the current stream, through scratch this wrapper allocates:
add + norm (K2's row kernel), in_proj, conv + SiLU, x_proj, dt_proj, the walk
of K1 (csrc/scan_walk.cuh), out_proj. The four products are computed inside
the TPU kernel, so they are hand-written here too: bf16 tensor-core tiles
(``mma.sync``, fp32 accumulate) at bf16, fp32 FMA tiles at fp32. At batch 1
the walk bounds it (latency), then in_proj and out_proj.

Both the kernel and :func:`block_fused_plain` keep the TPU kernel's rounding
points (block_fused.py:379-471): the sum and the norm in fp32; each
product's input rounded to the weight dtype and the product accumulated in
fp32; x, z, the conv, B, C and the walk in fp32, except that z is rounded to
bf16 for the gate on the bf16 path; ``out`` in the hidden dtype. fp32 weights
are the TPU's ``highest`` route, where nothing is rounded.

``checkpoints=True`` is the training forward (JAX block_fused.py:102,
196-198): it also returns the walk's state at every 16-step tile boundary,
fp32, (B, ceil(L / 16), Di, N), the residual K7 (ops/kernels/block_bwd.py)
rebuilds the recurrence from; the walk stores it behind a compile-time flag,
so serving pays nothing. These are the port's own checkpoints (K1's and
K3's), not the TPU kernel's 8-step ``hckpt``.

Weights are taken in the module's own torch layout: in_proj_w (2Di, E),
out_proj_w (E, Di), conv_w (Di, W), x_proj_w (R + 2N, Di) with rows
[dt | B | C], dt_proj_w (Di, R). The TPU-only 128-lane weight packing and
kernel-form selection are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.fused_add_norm import MAX_D
from videomamba_tpu_torch.ops.kernels.scan import (
    check_x_proj,
    pad_state,
    pad_x_proj,
    unpad,
    walk_state,
    num_segments,
    selective_scan_plain,
)
from videomamba_tpu_torch.ops.norm import layer_norm, rms_norm

Tensor = torch.Tensor

# Constants of the JAX package's routing rule (block_fused.py:42-58 and
# mixer_fused.py:42-51), kept so both packages route a Block alike.
PACK = 128
DEFAULT_BLOCK_L = 128
BUDGET_BYTES = 14 * 1024 * 1024


def mixer_fused_supported(d_inner: int, dt_rank: int, d_state: int) -> bool:
    """The JAX package's fused-mixer shape rule (mixer_fused.py:45-51)."""
    return (
        d_inner % 128 == 0
        and 0 < dt_rank <= PACK
        and 0 < d_state <= PACK
        and d_state % 8 == 0
    )


def block_fused_supported(d_model: int, d_inner: int, dt_rank: int,
                          d_state: int, weight_bytes_per_el: int = 2) -> bool:
    """Whether a Block takes the whole-block route (block_fused.py:45-58).

    The byte count is the TPU kernel's VMEM budget: resident weights (with
    the TPU's 128-lane packing of x_proj/dt_proj) plus fp32 temporaries of a
    128-row time block, under 14 MiB. It says nothing about this card; it is
    ported as the rule that keeps the two packages on the same route at every
    preset and dtype (K4 everywhere but fp32 Base).
    """
    if not mixer_fused_supported(d_inner, dt_rank, d_state):
        return False
    weight_bytes = (
        d_model * 2 * d_inner + d_inner * d_model
        + d_inner * 3 * PACK + PACK * d_inner
    ) * weight_bytes_per_el
    temp_bytes = DEFAULT_BLOCK_L * d_inner * 4 * 5
    return weight_bytes + temp_bytes < BUDGET_BYTES


def _product(a: Tensor, w: Tensor) -> Tensor:
    """a @ w.T with fp32 accumulation over the (already rounded) operands."""
    return a.float() @ w.float().t()


def block_fused_plain(
    hidden: Tensor,
    residual: Tensor,
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
    h0: Tensor,
    conv_state: Tensor,
    norm_type: str = "rms",
    eps: float = 1e-5,
    residual_fp32: bool = True,
    checkpoints: bool = False,
) -> Tuple[Tensor, ...]:
    """Plain PyTorch version with the kernel's rounding points.

    hidden, residual: (B, L, E); h0 (B, Di, N); conv_state (B, Di, W) raw
    inputs. Returns (out (B, L, E) in hidden.dtype, res_out (B, L, E) fp32
    with ``residual_fp32`` else hidden.dtype, h_last (B, Di, N) fp32), and
    with ``checkpoints`` also the segment-start states (B, ceil(L / 16), Di,
    N) fp32. Every product is fp32 over rounded operands, so with TF32 off it
    is a precise reference on the card as well.
    """
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    wdt = in_proj_w.dtype
    di = in_proj_w.shape[0] // 2
    r = dt_proj_w.shape[1]
    n = A.shape[1]
    res_out = hidden.float() + residual.float()
    if norm_type == "rms":
        normed = rms_norm(res_out, norm_w, eps=eps)
    else:
        normed = layer_norm(res_out, norm_w, norm_b, eps=eps)
    xz = _product(normed.to(wdt), in_proj_w)
    x, z = xz[..., :di], xz[..., di:]
    cy = causal_conv1d(x, conv_w.t(), conv_b, activation="silu",
                       initial_state=conv_state)
    x_dbl = _product(cy.to(wdt), x_proj_w)
    delta = _product(x_dbl[..., :r].to(wdt), dt_proj_w)
    if wdt != torch.float32 and hidden.dtype != torch.float32:
        z = z.to(torch.bfloat16)  # the gate input's bf16 scratch
    y, h_last, *ckpt = selective_scan_plain(
        cy, delta, A, x_dbl[..., r:r + n], x_dbl[..., r + n:], D, z, dt_bias,
        h0, softplus_delta=True, checkpoints=checkpoints,
    )
    out = _product(y.to(wdt), out_proj_w).to(hidden.dtype)
    res_dtype = torch.float32 if residual_fp32 else hidden.dtype
    return (out, res_out.to(res_dtype), h_last, *ckpt)


def block_fused(
    hidden: Tensor,
    residual: Tensor,
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
    h0: Tensor,
    conv_state: Tensor,
    norm_type: str = "rms",
    eps: float = 1e-5,
    residual_fp32: bool = True,
    checkpoints: bool = False,
) -> Tuple[Tensor, ...]:
    """Kernel wrapper with the contract of :func:`block_fused_plain`.

    On CUDA: hidden and the five weight tensors share one dtype, fp32 or
    bf16; the residual is fp32 or bf16; norm weights, dt_bias, A, D and h0
    are fp32; conv_state (fp32 or bf16) is read as fp32.
    """
    if dispatch.runs_plain(hidden):
        return block_fused_plain(
            hidden, residual, norm_w, norm_b, in_proj_w, out_proj_w, conv_w,
            conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, h0, conv_state,
            norm_type=norm_type, eps=eps, residual_fp32=residual_fp32,
            checkpoints=checkpoints,
        )
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    bsz, seqlen, e = hidden.shape
    di = in_proj_w.shape[0] // 2
    width = conv_w.shape[1]
    r = dt_proj_w.shape[1]
    n = A.shape[1]
    check_x_proj("block_fused", x_proj_w, r, n)
    npad = walk_state(n, "block_fused")
    if npad != n:
        out = block_fused(hidden, residual, norm_w, norm_b, in_proj_w, out_proj_w, conv_w,
                          conv_b, pad_x_proj(x_proj_w, r, n, npad), dt_proj_w, dt_bias,
                          pad_state(A, npad), D, pad_state(h0, npad), conv_state,
                          norm_type=norm_type, eps=eps, residual_fp32=residual_fp32,
                          checkpoints=checkpoints)
        return (*out[:2], *(unpad(t, n) for t in out[2:]))
    if e > MAX_D:
        raise ValueError(f"block_fused kernel takes d_model <= {MAX_D}, got {e}")
    wdt = hidden.dtype
    norm_b = norm_b if norm_type == "layer" else None  # RMSNorm has no shift
    weights = {"in_proj_w": (in_proj_w, (2 * di, e)), "out_proj_w": (out_proj_w, (e, di)),
               "conv_w": (conv_w, (di, width)), "conv_b": (conv_b, (di,)),
               "x_proj_w": (x_proj_w, (r + 2 * n, di)), "dt_proj_w": (dt_proj_w, (di, r))}
    _build.check_operands(
        "block_fused", hidden.device,
        {"hidden": (hidden, (bsz, seqlen, e)), "residual": (residual, (bsz, seqlen, e)),
         "norm_w": (norm_w, (e,)), "norm_b": (norm_b, (e,)), **weights,
         "dt_bias": (dt_bias, (di,)), "A": (A, (di, n)), "D": (D, (di,)),
         "h0": (h0, (bsz, di, n)), "conv_state": (conv_state, (bsz, di, width))},
        contiguous=("hidden", "residual", "norm_w", "norm_b", *weights, "dt_bias",
                    "A", "D", "h0"),
        dtypes={"hidden": _build.FP32_OR_BF16, "residual": _build.FP32_OR_BF16,
                "conv_state": _build.FP32_OR_BF16, **{k: (wdt,) for k in weights}},
    )

    dev = hidden.device
    out = torch.empty_like(hidden)
    res_out = torch.empty_like(
        hidden, dtype=torch.float32 if residual_fp32 else hidden.dtype)
    h_last = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((bsz, num_segments(seqlen), di, n), dtype=torch.float32,
                        device=dev) if checkpoints else None)
    outs = (out, res_out, h_last) + ((ckpt,) if checkpoints else ())
    if bsz == 0 or seqlen == 0:
        h_last.copy_(h0)
        return outs
    rows = bsz * seqlen
    f32 = dict(dtype=torch.float32, device=dev)
    normed = torch.empty((rows, e), dtype=wdt, device=dev)
    xz = torch.empty((rows, 2 * di), **f32)
    conv_out = torch.empty((rows, di), **f32)
    x_dbl = torch.empty((rows, r + 2 * n), **f32)
    delta = torch.empty((rows, di), **f32)
    y = torch.empty((rows, di), **f32)
    cstate = conv_state.float().contiguous()
    err = _build.library().vmt_block_fused(
        _build.ptr(hidden), _build.ptr(residual), _build.is_bf16(residual),
        _build.ptr(norm_w), _build.ptr(norm_b), _build.ptr(in_proj_w),
        _build.ptr(out_proj_w), _build.ptr(conv_w), _build.ptr(conv_b),
        _build.ptr(x_proj_w), _build.ptr(dt_proj_w), _build.ptr(dt_bias),
        _build.ptr(A), _build.ptr(D), _build.ptr(h0), _build.ptr(cstate),
        _build.ptr(out), _build.ptr(res_out), _build.is_bf16(res_out),
        _build.ptr(h_last), _build.ptr(ckpt), _build.ptr(normed), _build.ptr(xz),
        _build.ptr(conv_out), _build.ptr(x_dbl), _build.ptr(delta), _build.ptr(y),
        _build.is_bf16(hidden), bsz, seqlen, e, di, width, r, n, eps,
        int(norm_type == "rms"), dev.index, _build.stream_of(hidden),
    )
    _build.check(err, "block_fused")
    block_fused.launches += 1
    return outs


block_fused.launches = 0
