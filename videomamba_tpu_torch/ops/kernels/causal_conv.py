"""K10: causal depthwise conv1d + bias + SiLU, hand-written CUDA for Hopper.

Replaces videomamba_tpu/ops/pallas/causal_conv.py (causal_conv1d_pallas,
``_conv_kernel``), the kernel behind ``causal_conv1d(use_pallas=True)``:
``y[b, t, d] = act(bias[d] + sum_k w[k, d] ctx[b, t + k, d])`` over (B, L,
D), ctx being x preceded by the last W - 1 raw inputs of ``conv_state``
(B, D, W). csrc/causal_conv.cu gives each thread one 16-byte vector of
channels (4 fp32 or 8 bf16) and a tile of time steps, its taps and bias in
registers: widths 1 to 4 are compiled as such over 4 steps, whose 4 + W -
1 input rows a thread loads before its first multiply-add; any other width
loops over its taps at run time over 8 steps, its input rows loaded in
batches of 8. A D no multiple of the vector, or a pointer off a 16-byte
boundary, runs the same kernels a channel a thread. The halo before the
first tile comes from conv_state (fp32 or bf16). It is bound by device
memory: one read of x and one write of y. The taps, bias and state are read
as fp32 and the sum
is fp32; y comes back in x's dtype (fp32 or bf16). :func:`causal_conv_plan`
lays the launch out.

The gate (:func:`causal_conv_supported`) is the JAX package's
``pallas_conv_supported`` without its 128-lane rule: any D, any width W
with seqlen >= W.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from videomamba_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

def causal_conv_supported(width: int, seqlen: int) -> bool:
    """The shapes ``causal_conv1d(use_kernel=True)`` runs K10 at: any width
    up to the sequence length, at any channel count."""
    return 1 <= width <= seqlen


CONV_THREADS = 64      # channel vectors a block (csrc/causal_conv.cu kConvThreads)
CONV_TILE_FIXED = 4    # time steps a thread at widths 1-4 (kConvTileFixed)
CONV_TILE_ANY = 8      # time steps a thread at other widths (kConvTileAny)


class ConvPlan(NamedTuple):
    """K10's launch: ``vec`` channels a thread, ``tile`` time steps a
    thread, and the grid (time tiles, channel blocks, batch rows) of
    CONV_THREADS-thread blocks."""
    vec: int
    tile: int
    grid: tuple


@functools.lru_cache(maxsize=256)
def causal_conv_plan(batch: int, seqlen: int, d: int, dtype: torch.dtype, width: int,
                     aligned: bool = True) -> ConvPlan:
    """The launch at (batch, seqlen, d) and this width: 16-byte vectors (4
    fp32, 8 bf16) where D divides by them and x, weight and bias start on a
    16-byte boundary (``aligned``), else one channel a thread; 4 steps a
    thread at widths 1-4, 8 at others."""
    wide = 8 if dtype == torch.bfloat16 else 4
    vec = wide if aligned and d % wide == 0 else 1
    tile = CONV_TILE_FIXED if width <= 4 else CONV_TILE_ANY
    grid = (-(-seqlen // tile), -(-(d // vec) // CONV_THREADS), batch)
    return ConvPlan(vec, tile, grid)


def causal_conv_plain(x: Tensor, weight: Tensor, bias: Optional[Tensor],
                      conv_state: Tensor, activation: Optional[str] = "silu") -> Tensor:
    """Plain PyTorch version: the port's composition (ops/causal_conv1d.py),
    W shifted multiply-adds in fp32. x (B, L, D); weight (W, D); bias (D,)
    or None; conv_state (B, D, W)."""
    return causal_conv1d(x, weight, bias, activation=activation, initial_state=conv_state)


def causal_conv(x: Tensor, weight: Tensor, bias: Optional[Tensor], conv_state: Tensor,
                activation: Optional[str] = "silu") -> Tensor:
    """Kernel wrapper with the contract of :func:`causal_conv_plain`.

    On CUDA: x fp32 or bf16 (read contiguous); weight and bias of any float
    dtype, read as fp32; conv_state fp32 or bf16 as it is (another float
    dtype as fp32); any W >= 1."""
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
    state = (conv_state if conv_state.dtype in _build.FP32_OR_BF16
             else conv_state.float()).contiguous()
    _build.check_operands(
        "causal_conv", x.device,
        {"x": (x, (bsz, seqlen, d)), "weight": (w32, (width, d)), "bias": (b32, (d,)),
         "conv_state": (state, (bsz, d, width))},
        dtypes={"x": _build.FP32_OR_BF16, "conv_state": _build.FP32_OR_BF16},
    )
    y = torch.empty_like(x)
    p_x, p_w, p_b = x.data_ptr(), w32.data_ptr(), 0 if b32 is None else b32.data_ptr()
    plan = causal_conv_plan(bsz, seqlen, d, x.dtype, width, aligned=(p_x | p_w | p_b) % 16 == 0)
    err = _build.library().vmt_causal_conv(
        p_x, _build.ptr(state), _build.is_bf16(state), p_w, p_b or None, _build.ptr(y),
        _build.is_bf16(x), bsz, seqlen, d, width, int(activation is not None), plan.vec,
        plan.tile, x.device.index, _build.stream_of(x),
    )
    _build.check(err, "causal_conv")
    causal_conv.launches += 1
    return y


causal_conv.launches = 0
