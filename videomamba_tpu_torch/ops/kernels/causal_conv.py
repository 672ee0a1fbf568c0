"""K10: causal depthwise conv1d + bias + SiLU, hand-written CUDA for Hopper.

Replaces videomamba_tpu/ops/pallas/causal_conv.py (causal_conv1d_pallas,
``_conv_kernel``), the kernel behind ``causal_conv1d(use_pallas=True)``:
``y[b, t, d] = act(bias[d] + sum_k w[k, d] ctx[b, t + k, d])`` over (B, L,
D), ctx being x preceded by the last W - 1 raw inputs of ``conv_state``
(B, D, W). csrc/causal_conv.cu gives each thread one channel and a tile of
64 time steps, walked in order with the last W - 1 inputs in registers
(widths 1 to 4, compiled as such; any other width loops over its taps at run
time); the halo before the tile comes from x (or conv_state for the first
tile). It is bound by device memory: one read of x and one write of y. The
taps, bias and state are read as fp32 and the sum is fp32; y comes back in
x's dtype (fp32 or bf16).

The gate (:func:`causal_conv_supported`) is the JAX package's
``pallas_conv_supported`` without its 128-lane rule: any D, any width W
with seqlen >= W.
"""

from __future__ import annotations

from typing import Optional

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from videomamba_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

def causal_conv_supported(width: int, seqlen: int) -> bool:
    """The shapes ``causal_conv1d(use_kernel=True)`` runs K10 at: any width
    up to the sequence length, at any channel count."""
    return 1 <= width <= seqlen


def causal_conv_plain(x: Tensor, weight: Tensor, bias: Optional[Tensor],
                      conv_state: Tensor, activation: Optional[str] = "silu") -> Tensor:
    """Plain PyTorch version: the port's composition (ops/causal_conv1d.py),
    W shifted multiply-adds in fp32. x (B, L, D); weight (W, D); bias (D,)
    or None; conv_state (B, D, W)."""
    return causal_conv1d(x, weight, bias, activation=activation, initial_state=conv_state)


def causal_conv(x: Tensor, weight: Tensor, bias: Optional[Tensor], conv_state: Tensor,
                activation: Optional[str] = "silu") -> Tensor:
    """Kernel wrapper with the contract of :func:`causal_conv_plain`.

    On CUDA: x fp32 or bf16 (read contiguous); weight, bias and conv_state
    of any float dtype, read as fp32; any W >= 1."""
    if dispatch.runs_plain(x):
        return causal_conv_plain(x, weight, bias, conv_state, activation)
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError(f"activation {activation!r} is not supported")
    bsz, seqlen, d = x.shape
    width = weight.shape[0]
    if width < 1:
        raise ValueError(f"causal_conv kernel takes a width of at least 1, got {width}")
    x = x.contiguous()
    w32 = weight.float().contiguous()
    b32 = bias.float().contiguous() if bias is not None else None
    state = conv_state.float().contiguous()
    _build.check_operands(
        "causal_conv", x.device,
        {"x": (x, (bsz, seqlen, d)), "weight": (w32, (width, d)), "bias": (b32, (d,)),
         "conv_state": (state, (bsz, d, width))},
        dtypes={"x": _build.FP32_OR_BF16},
    )
    y = torch.empty_like(x)
    err = _build.library().vmt_causal_conv(
        _build.ptr(x), _build.ptr(state), _build.ptr(w32), _build.ptr(b32), _build.ptr(y),
        _build.is_bf16(x), bsz, seqlen, d, width, int(activation is not None),
        x.device.index, _build.stream_of(x),
    )
    _build.check(err, "causal_conv")
    causal_conv.launches += 1
    return y


causal_conv.launches = 0
