"""K9 and K15: one decode token through the whole layer stack, CUDA for Hopper.

K9 (:func:`decode_stack`) is the Mamba-1 stack, K15 (:func:`decode_stack_m2`,
at the end of this module) the Mamba-2 one.

Replaces videomamba_tpu/ops/pallas/decode_step.py (decode_stack_pallas,
``_decode_kernel``): for a token (B, E) and each of the K layers, residual
add, RMS / LayerNorm, in_proj, the rolling conv and SiLU, x_proj, dt_proj
and softplus, the single-step state update ``y = C h + D x``, the silu(z)
gate and out_proj; the stacked conv and SSM states advance by one token.
It returns (hidden, residual) in fp32 for the model's final norm.

The TPU kernel's grid is the layer axis with each layer's weights
double-buffered into VMEM. csrc/decode_step.cu runs four hand-written
launches a layer on the current stream, all from one C call per token:
norm + in_proj + conv (each block recomputes the normed rows into shared
memory), x_proj, dt_proj + state update + gate (a thread per channel), and
out_proj, the three products as GEMVs with one warp per weight row and
16-byte weight loads; hidden and residual stay in fp32 device buffers
between layers. It is bound by device memory (every weight read once per
token: ~90.5 M parameters at VideoMamba-Base, 0.108 ms at fp32 and 0.054
ms at bf16 on 3.35 TB/s) and, at B = 1, by the host's launch rate (4K
launches a token). The conv and SSM states are updated in place on the
kernel route (the session owns them); the plain version returns new ones.

Rounding (decode_step.py:134-184, with the TPU's ``precision=DEFAULT`` as
interpret mode computes it): fp32 weights take fp32 products; bf16 weights
round ``normed``, the conv output, ``x_dbl`` and ``y`` to bf16 before their
products, with fp32 sums. The states are stored in their own dtype.

Layouts (the contract's, stacked on depth; the TPU's lane-major state swap
is not ported): norm_w, norm_b (K, E) fp32; in_proj_w (K, 2Di, E),
out_proj_w (K, E, Di), conv_w (K, Di, W), x_proj_w (K, R + 2N, Di),
dt_proj_w (K, Di, R) in the weight dtype; conv_b, dt_bias, D (K, Di) and A
(K, Di, N) fp32; conv_states (K, B, Di, W), ssm_states (K, B, Di, N).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.mixer_bwd import _rnd
from videomamba_tpu_torch.ops.kernels.scan import softplus
from videomamba_tpu_torch.ops.norm import layer_norm, rms_norm

Tensor = torch.Tensor

BATCH_PASS = 8  # kDecBatch: token rows staged in shared memory per pass
MAX_PASS_BYTES = 200 * 1024  # BATCH_PASS x E fp32 normed rows in one block
LAUNCHES_PER_LAYER = 4


def decode_stack_supported(d_model: int, d_inner: int) -> bool:
    """The port's own gate for K9: 16-byte weight rows (d_model and d_inner
    multiples of 8) and one pass's normed rows in one block's shared memory
    (d_model up to 6400). Any batch size: the kernel takes the batch
    BATCH_PASS rows at a time."""
    return (d_model % 8 == 0 and d_inner % 8 == 0
            and BATCH_PASS * d_model * 4 <= MAX_PASS_BYTES)


def decode_stack_plain(
    token: Tensor,
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
    conv_states: Tensor,
    ssm_states: Tensor,
    norm_type: str = "rms",
    eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K9 (decode_step.py:80-190) with the kernel's
    rounding points and sums in its order. token (B, E). Returns (hidden
    (B, E) fp32, residual (B, E) fp32, new conv_states, new ssm_states)."""
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    wdt = in_proj_w.dtype
    di = in_proj_w.shape[1] // 2
    width = conv_w.shape[2]
    r = dt_proj_w.shape[2]
    n = A.shape[2]
    hidden = token.float()
    residual = torch.zeros_like(hidden)
    new_conv, new_ssm = [], []
    for k in range(in_proj_w.shape[0]):
        residual = hidden + residual
        normed = (rms_norm(residual, norm_w[k], eps=eps) if norm_type == "rms"
                  else layer_norm(residual, norm_w[k],
                                  None if norm_b is None else norm_b[k], eps=eps))
        xz = _rnd(normed, wdt) @ in_proj_w[k].float().t()
        x_raw, z = xz[:, :di], xz[:, di:]
        cst = conv_states[k].float()
        cw = conv_w[k].float()
        # The kernel's order: window taps 1 .. W-1 oldest first, x_raw last.
        acc = cst[..., 1] * cw[:, 0] if width > 1 else x_raw * cw[:, 0]
        for w in range(1, width):
            acc = acc + (x_raw if w == width - 1 else cst[..., w + 1]) * cw[:, w]
        x = F.silu(acc + conv_b[k])
        new_conv.append(torch.cat(
            [conv_states[k][..., 1:], x_raw.to(conv_states.dtype)[..., None]], dim=-1))
        x_dbl = _rnd(x, wdt) @ x_proj_w[k].float().t()
        dt = softplus(_rnd(x_dbl[:, :r], wdt) @ dt_proj_w[k].float().t() + dt_bias[k])
        h = (torch.exp(dt[..., None] * A[k]) * ssm_states[k].float()
             + (dt * x)[..., None] * x_dbl[:, None, r:r + n])
        new_ssm.append(h.to(ssm_states.dtype))
        y = (h * x_dbl[:, None, r + n:]).sum(-1) + D[k] * x
        y = y * F.silu(z)
        hidden = _rnd(y, wdt) @ out_proj_w[k].float().t()
    return hidden, residual, torch.stack(new_conv), torch.stack(new_ssm)


def decode_stack(
    token: Tensor,
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
    conv_states: Tensor,
    ssm_states: Tensor,
    norm_type: str = "rms",
    eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Kernel wrapper with the contract of :func:`decode_stack_plain`; on
    CUDA the states are advanced in place and returned.

    On CUDA: the five weight stacks in one dtype, fp32 or bf16; the two
    state stacks in one dtype, fp32 or bf16; the token any float dtype (read
    as fp32); everything else fp32. All contiguous."""
    if dispatch.runs_plain(token):
        return decode_stack_plain(token, norm_w, norm_b, in_proj_w, out_proj_w, conv_w,
                                  conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, conv_states,
                                  ssm_states, norm_type=norm_type, eps=eps)
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    bsz, e = token.shape
    depth, two_di, _ = in_proj_w.shape
    di = two_di // 2
    width = conv_w.shape[2]
    r = dt_proj_w.shape[2]
    n = A.shape[2]
    if not decode_stack_supported(e, di):
        raise ValueError(
            f"decode_stack kernel takes d_model and d_inner multiples of 8 and "
            f"{BATCH_PASS} x d_model x 4 <= {MAX_PASS_BYTES} bytes, got d_model {e}, "
            f"d_inner {di}")
    norm_b = norm_b if norm_type == "layer" else None  # RMSNorm has no shift
    wdt, sdt = _build.one_dtype(in_proj_w), _build.one_dtype(conv_states)
    weights = {"in_proj_w": (in_proj_w, (depth, 2 * di, e)),
               "out_proj_w": (out_proj_w, (depth, e, di)),
               "conv_w": (conv_w, (depth, di, width)),
               "x_proj_w": (x_proj_w, (depth, r + 2 * n, di)),
               "dt_proj_w": (dt_proj_w, (depth, di, r))}
    _build.check_operands(
        "decode_stack", token.device,
        {"norm_w": (norm_w, (depth, e)), "norm_b": (norm_b, (depth, e)), **weights,
         "conv_b": (conv_b, (depth, di)), "dt_bias": (dt_bias, (depth, di)),
         "A": (A, (depth, di, n)), "D": (D, (depth, di)),
         "conv_states": (conv_states, (depth, bsz, di, width)),
         "ssm_states": (ssm_states, (depth, bsz, di, n))},
        contiguous=("norm_w", "norm_b", *weights, "conv_b", "dt_bias", "A", "D",
                    "conv_states", "ssm_states"),
        dtypes={**{k: wdt for k in weights}, "conv_states": sdt, "ssm_states": sdt},
    )
    dev = token.device
    f32 = dict(dtype=torch.float32, device=dev)
    hidden = token.to(torch.float32, copy=True).contiguous()
    res = (torch.zeros((bsz, e), **f32), torch.empty((bsz, e), **f32))
    scratch = torch.empty((bsz * (3 * di + r + 2 * n),), **f32)
    err = _build.library().vmt_decode_stack(
        _build.ptr(hidden), _build.ptr(res[0]), _build.ptr(res[1]), _build.ptr(norm_w),
        _build.ptr(norm_b), _build.ptr(in_proj_w), _build.ptr(out_proj_w),
        _build.ptr(conv_w), _build.ptr(conv_b), _build.ptr(x_proj_w),
        _build.ptr(dt_proj_w), _build.ptr(dt_bias), _build.ptr(A), _build.ptr(D),
        _build.ptr(conv_states), _build.ptr(ssm_states), _build.ptr(scratch),
        _build.is_bf16(in_proj_w), _build.is_bf16(conv_states), depth, bsz, e, di, width,
        r, n, eps, int(norm_type == "rms"), dev.index, _build.stream_of(token),
    )
    _build.check(err, "decode_stack")
    decode_stack.launches += 1
    return hidden, res[depth % 2], conv_states, ssm_states


decode_stack.launches = 0


# ---------------------------------------------------------------------------
# K15: the Mamba-2 (SSD) stack.
#
# Replaces videomamba_tpu/ops/pallas/decode_step.py (decode_stack_pallas_m2,
# ``_decode_kernel_m2``): for each layer, residual add and norm, in_proj
# (z | [x B C] | dt), the rolling conv over [x B C] and SiLU, the per-head
# scalar-decay state update h = exp(dt A_h) h + dt x B with y = C . h + D_h
# x, the silu(z) gate, the gated RMSNorm and out_proj. csrc/decode_step.cu
# runs three launches a layer from one C call per token: K9's norm + in_proj
# + conv launch (taking the slab's rows as its channels), a warp per (b,
# head, p) state row, and the gated norm + out_proj GEMV (each block
# recomputing the normed rows, eight a pass, so any batch fits). It is bound
# by device memory: the weights once a token and the (H, P, N) fp32 state of
# every layer read and written. Rounding as the TPU kernel's: normed and the
# normed gated rows are rounded to the weight dtype before their products,
# the rest is fp32; the conv windows keep their dtype, the SSD states are
# fp32 (the Mamba-2 streaming contract's).
#
# Layouts (the streaming contract's, stacked on depth; the TPU's lane-major
# (K, B, N, H*P) state is not ported): norm_w, norm_b (K, E) fp32;
# in_proj_w (K, 2Di + 2GN + H, E), out_proj_w (K, E, Di), conv_w (K, CD, W)
# in the weight dtype; conv_b (K, CD), A, D, dt_bias (K, H), gate_w (K, Di)
# fp32; conv_states (K, B, CD, W), ssm_states (K, B, H, P, N).

LAUNCHES_PER_LAYER_M2 = 3
M2_WEIGHT_BUDGET_BYTES = 48 * 1024 * 1024


def decode_stack_m2_supported(d_model: int, d_inner: int, nheads: int, ngroups: int,
                              d_state: int) -> bool:
    """K15's gate: the JAX package's (decode_step.py:64-77: one B/C group,
    d_inner a multiple of 128, its per-layer weight bytes) and the card's
    (16-byte weight rows, one pass's normed rows in one block's shared
    memory). Any batch size."""
    if ngroups != 1 or d_inner % 128 or d_model % 8:
        return False
    conv_dim = d_inner + 2 * ngroups * d_state
    d_proj = 2 * d_inner + 2 * ngroups * d_state + nheads
    weight_bytes = (d_model * d_proj + d_inner * d_model + 4 * conv_dim) * 2 \
        + d_state * d_inner * 4
    return (2 * weight_bytes < M2_WEIGHT_BUDGET_BYTES
            and BATCH_PASS * max(d_model, d_inner) * 4 <= MAX_PASS_BYTES)


def decode_stack_m2_plain(
    token: Tensor,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    A: Tensor,
    D: Tensor,
    dt_bias: Tensor,
    gate_w: Optional[Tensor],
    conv_states: Tensor,
    ssm_states: Tensor,
    ngroups: int = 1,
    norm_type: str = "rms",
    eps: float = 1e-5,
    gate_eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K15 (decode_step.py:306-417) with the
    kernel's rounding points. token (B, E). Returns (hidden (B, E) fp32,
    residual (B, E) fp32, new conv_states, new ssm_states)."""
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    wdt = in_proj_w.dtype
    di = out_proj_w.shape[2]
    _, bsz, nheads, hdim, n = ssm_states.shape
    gn = ngroups * n
    cd = di + 2 * gn
    width = conv_w.shape[2]
    hidden = token.float()
    residual = torch.zeros_like(hidden)
    new_conv, new_ssm = [], []
    for k in range(in_proj_w.shape[0]):
        residual = hidden + residual
        normed = (rms_norm(residual, norm_w[k], eps=eps) if norm_type == "rms"
                  else layer_norm(residual, norm_w[k],
                                  None if norm_b is None else norm_b[k], eps=eps))
        zxbcdt = _rnd(normed, wdt) @ in_proj_w[k].float().t()
        z, raw, dt_raw = zxbcdt[:, :di], zxbcdt[:, di:di + cd], zxbcdt[:, di + cd:]
        cst = conv_states[k].float()
        cw = conv_w[k].float()
        # The kernel's order: window taps 1 .. W-1 oldest first, the raw input last.
        acc = cst[..., 1] * cw[:, 0] if width > 1 else raw * cw[:, 0]
        for w in range(1, width):
            acc = acc + (raw if w == width - 1 else cst[..., w + 1]) * cw[:, w]
        xbc = F.silu(acc + conv_b[k])
        new_conv.append(torch.cat(
            [conv_states[k][..., 1:], raw.to(conv_states.dtype)[..., None]], dim=-1))
        x = xbc[:, :di].reshape(bsz, nheads, hdim)
        Bh = xbc[:, di:di + gn].reshape(bsz, ngroups, n).repeat_interleave(
            nheads // ngroups, dim=1)
        Ch = xbc[:, di + gn:].reshape(bsz, ngroups, n).repeat_interleave(
            nheads // ngroups, dim=1)
        dt = softplus(dt_raw + dt_bias[k])  # (B, H)
        dA = torch.exp(dt * A[k])
        h = (dA[:, :, None, None] * ssm_states[k].float()
             + (dt[:, :, None] * x)[..., None] * Bh[:, :, None, :])
        new_ssm.append(h.to(ssm_states.dtype))
        y = (h * Ch[:, :, None, :]).sum(-1) + D[k][:, None] * x
        gated = y.reshape(bsz, di) * F.silu(z)
        if gate_w is not None:
            gated = gated * torch.rsqrt(gated.square().mean(-1, keepdim=True) + gate_eps)
            gated = gated * gate_w[k]
        hidden = _rnd(gated, wdt) @ out_proj_w[k].float().t()
    return hidden, residual, torch.stack(new_conv), torch.stack(new_ssm)


def decode_stack_m2(
    token: Tensor,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    A: Tensor,
    D: Tensor,
    dt_bias: Tensor,
    gate_w: Optional[Tensor],
    conv_states: Tensor,
    ssm_states: Tensor,
    ngroups: int = 1,
    norm_type: str = "rms",
    eps: float = 1e-5,
    gate_eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Kernel wrapper with the contract of :func:`decode_stack_m2_plain`; on
    CUDA the states are advanced in place and returned.

    On CUDA: the three weight stacks in one dtype, fp32 or bf16; the conv
    windows fp32 or bf16 and the SSD states fp32 (the streaming contract's);
    the token any float dtype (read as fp32); everything else fp32. All
    contiguous."""
    if dispatch.runs_plain(token):
        return decode_stack_m2_plain(token, norm_w, norm_b, in_proj_w, out_proj_w, conv_w,
                                     conv_b, A, D, dt_bias, gate_w, conv_states, ssm_states,
                                     ngroups=ngroups, norm_type=norm_type, eps=eps,
                                     gate_eps=gate_eps)
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    bsz, e = token.shape
    depth, _, di = out_proj_w.shape
    nheads, hdim, n = ssm_states.shape[2:]
    cd = di + 2 * ngroups * n
    width = conv_w.shape[2]
    if not decode_stack_m2_supported(e, di, nheads, ngroups, n):
        raise ValueError(
            f"decode_stack_m2 kernel takes one group, d_inner a multiple of 128, d_model a "
            f"multiple of 8 and the JAX package's weight budget, got d_model {e}, d_inner "
            f"{di}, {ngroups} groups")
    norm_b = norm_b if norm_type == "layer" else None  # RMSNorm has no shift
    wdt = _build.one_dtype(in_proj_w)
    weights = {"in_proj_w": (in_proj_w, (depth, di + cd + nheads, e)),
               "out_proj_w": (out_proj_w, (depth, e, di)),
               "conv_w": (conv_w, (depth, cd, width))}
    _build.check_operands(
        "decode_stack_m2", token.device,
        {"norm_w": (norm_w, (depth, e)), "norm_b": (norm_b, (depth, e)), **weights,
         "conv_b": (conv_b, (depth, cd)), "A": (A, (depth, nheads)),
         "D": (D, (depth, nheads)), "dt_bias": (dt_bias, (depth, nheads)),
         "gate_w": (gate_w, (depth, di)),
         "conv_states": (conv_states, (depth, bsz, cd, width)),
         "ssm_states": (ssm_states, (depth, bsz, nheads, hdim, n))},
        contiguous=("norm_w", "norm_b", *weights, "conv_b", "A", "D", "dt_bias", "gate_w",
                    "conv_states", "ssm_states"),
        dtypes={**{k: wdt for k in weights}, "conv_states": _build.FP32_OR_BF16},
    )
    dev = token.device
    f32 = dict(dtype=torch.float32, device=dev)
    hidden = token.to(torch.float32, copy=True).contiguous()
    res = (torch.zeros((bsz, e), **f32), torch.empty((bsz, e), **f32))
    scratch = torch.empty((bsz * (2 * di + cd + nheads + cd),), **f32)
    p = _build.ptr
    err = _build.library().vmt_decode_stack_m2(
        p(hidden), p(res[0]), p(res[1]), p(norm_w), p(norm_b), p(in_proj_w), p(out_proj_w),
        p(conv_w), p(conv_b), p(A), p(D), p(dt_bias), p(gate_w), p(conv_states),
        p(ssm_states), p(scratch), _build.is_bf16(in_proj_w), _build.is_bf16(conv_states),
        depth, bsz, e, nheads, hdim, ngroups, n, width, eps, int(norm_type == "rms"),
        gate_eps, dev.index, _build.stream_of(token),
    )
    _build.check(err, "decode_stack_m2")
    decode_stack_m2.launches += 1
    return hidden, res[depth % 2], conv_states, ssm_states


decode_stack_m2.launches = 0
