"""Causal depthwise 1-D convolution with streaming state.

Port of videomamba_tpu/ops/causal_conv1d.py, layout kept: activations
(B, L, D), weight (W, D) with tap 0 the oldest, ``conv_state`` (B, D, W)
holding the last W raw (pre-activation) inputs. The width is tiny (4), so the
plain conv is W shifted multiply-adds in fp32. ``use_kernel=True`` routes
through K10 (ops/kernels/causal_conv.py, the JAX package's
``use_pallas=True``) where its width gate admits the shape; under autograd
that runs as :class:`CausalConvFn`, whose backward is autograd of the plain
composition, as the JAX package's ``_pallas_conv_bwd`` is.
:func:`causal_conv1d_update` is the single-token step of the decode path.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class CausalConvFn(torch.autograd.Function):
    """K10 forward; backward by autograd of the plain composition."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv_state, activation):
        from videomamba_tpu_torch.ops.kernels import causal_conv as k10

        ctx.save_for_backward(x, weight, bias, conv_state)
        ctx.activation = activation
        return k10.causal_conv(x, weight, bias, conv_state, activation)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        live = [a.detach().requires_grad_() if a is not None else None for a in args]
        with torch.enable_grad():
            y = causal_conv1d(live[0], live[1], live[2], activation=ctx.activation,
                              initial_state=live[3])
        present = [a for a in live if a is not None]
        grads = iter(torch.autograd.grad(y, present, g, allow_unused=True))
        return tuple(next(grads) if a is not None else None for a in live) + (None,)


def causal_conv1d(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    activation: Optional[str] = "silu",
    initial_state: Optional[Tensor] = None,
    return_final_state: bool = False,
    use_kernel: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """``y[b, l, d] = act(bias[d] + sum_w weight[w, d] * ctx[b, l + w, d])``.

    ``ctx`` is x left-extended with the last W-1 entries of ``initial_state``
    (or zeros). Returns y (B, L, D) in x.dtype, and with
    ``return_final_state`` also the new (B, D, W) window in x.dtype: the last
    W raw inputs of [state || x], sliced from the raw input on either route.
    """
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError(f"activation {activation!r} is not supported")
    seqlen = x.shape[1]
    w = weight.shape[0]
    if use_kernel:
        # Imported here: the kernel module builds its plain version from
        # this function.
        from videomamba_tpu_torch.ops.kernels import causal_conv as k10

        if k10.causal_conv_supported(w, seqlen):
            state_in = (initial_state if initial_state is not None
                        else x.new_zeros((x.shape[0], x.shape[2], w)))
            args = (x, weight, bias, state_in)
            if torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad for t in args):
                y = CausalConvFn.apply(*args, activation)
            else:
                y = k10.causal_conv(*args, activation)
            if not return_final_state:
                return y
            return y, conv_window(x, initial_state, w)
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


def causal_conv1d_update(
    x: Tensor,
    conv_state: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    activation: Optional[str] = "silu",
) -> Tuple[Tensor, Tensor]:
    """One token of the rolling-window conv (the decode path), pure: rolls
    the (B, D, W) window left by one, appends x (B, D) in the window's dtype,
    and convolves the window with weight (W, D) in fp32 (JAX
    causal_conv1d.py:150-184). Returns (y (B, D) in x.dtype, new_conv_state
    (B, D, W) in conv_state.dtype)."""
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError(f"activation {activation!r} is not supported")
    new_state = torch.cat([conv_state[:, :, 1:], x.to(conv_state.dtype)[:, :, None]], dim=2)
    y = torch.einsum("bdw,wd->bd", new_state.float(), weight.float())
    if bias is not None:
        y = y + bias.float()
    if activation in ("silu", "swish"):
        y = F.silu(y)
    return y.to(x.dtype), new_state
