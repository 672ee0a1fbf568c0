"""Causal depthwise 1-D convolution with streaming state (plain PyTorch).

Port of videomamba_tpu/ops/causal_conv1d.py, layout kept: activations
(B, L, D), weight (W, D) with tap 0 the oldest, ``conv_state`` (B, D, W)
holding the last W raw (pre-activation) inputs. The width is tiny (4), so the
conv is W shifted multiply-adds in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def causal_conv1d(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    activation: Optional[str] = "silu",
    initial_state: Optional[Tensor] = None,
    return_final_state: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """``y[b, l, d] = act(bias[d] + sum_w weight[w, d] * ctx[b, l + w, d])``.

    ``ctx`` is x left-extended with the last W-1 entries of ``initial_state``
    (or zeros). Returns y (B, L, D) in x.dtype, and with
    ``return_final_state`` also the new (B, D, W) window in x.dtype: the last
    W raw inputs of [state || x].
    """
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError(f"activation {activation!r} is not supported")
    seqlen = x.shape[1]
    w = weight.shape[0]
    x32 = x.float()
    if initial_state is not None:
        state_bld = initial_state.float().transpose(1, 2)  # (B, W, D)
        ctx = torch.cat([state_bld[:, 1:], x32], dim=1) if w > 1 else x32
    else:
        ctx = F.pad(x32, (0, 0, w - 1, 0)) if w > 1 else x32

    w32 = weight.float()
    y = w32[0] * ctx[:, 0:seqlen]
    for k in range(1, w):
        y = y + w32[k] * ctx[:, k:k + seqlen]
    if bias is not None:
        y = y + bias.float()
    if activation in ("silu", "swish"):
        y = F.silu(y)
    y = y.to(x.dtype)
    if not return_final_state:
        return y
    return y, conv_window(x, initial_state, w)


def conv_window(x: Tensor, conv_state: Optional[Tensor], width: int) -> Tensor:
    """New (B, D, W) raw-input window: the last W inputs of [state || x],
    zero-padded when short, in x.dtype (videomamba_tpu/models/mamba.py:57-65)."""
    if conv_state is not None:
        full = torch.cat([conv_state.transpose(1, 2).to(x.dtype), x], dim=1)
    else:
        full = F.pad(x, (0, 0, width, 0))
    return full[:, -width:].transpose(1, 2).contiguous()
