"""Prenorm residual Block: Add -> Norm -> Mixer (PyTorch port).

Port of videomamba_tpu/models/block.py for inference: the block adds the
incoming hidden states to the running residual, normalizes (K2 when
``fused_add_norm``), runs the mixer, and returns the mixer output with the
post-add residual. There is no whole-block branch: the JAX package's
block-fused kernel (ops/pallas/block_fused.py) is not ported yet, and at fp32
VideoMamba-Base the JAX package does not take it either. Stochastic depth is
training and is not ported: a training-mode block with ``drop_path_rate > 0``
raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from videomamba_tpu_torch.models.mamba import LayerState, Mamba
from videomamba_tpu_torch.ops.norm import fused_add_norm

Tensor = torch.Tensor


class Norm(nn.Module):
    """fp32 ``weight`` (and ``bias`` for LayerNorm) of an RMS/LayerNorm."""

    def __init__(self, dim: int, bias: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(dim, device=device))
        else:
            self.register_parameter("bias", None)


class Block(nn.Module):
    """Add -> Norm -> Mamba with carried residual and streaming state."""

    def __init__(
        self,
        dim: int,
        mixer: Mamba,
        norm_type: str = "layer",
        norm_epsilon: float = 1e-5,
        fused_add_norm: bool = False,
        residual_in_fp32: bool = False,
        drop_path_rate: float = 0.0,
        layer_idx: Optional[int] = None,
        device=None,
    ):
        super().__init__()
        if norm_type not in ("layer", "rms"):
            raise ValueError(f"Unknown norm_type: {norm_type!r}")
        self.dim = dim
        self.mixer = mixer
        self.norm = Norm(dim, bias=norm_type == "layer", device=device)
        self.norm_type = norm_type
        self.norm_epsilon = norm_epsilon
        self.fused_add_norm = fused_add_norm
        self.residual_in_fp32 = residual_in_fp32
        self.drop_path_rate = drop_path_rate
        self.layer_idx = layer_idx

    def forward(
        self,
        hidden_states: Tensor,
        residual: Optional[Tensor] = None,
        state: Optional[LayerState] = None,
        return_state: bool = False,
        ssm_state: Optional[Tensor] = None,
        return_ssm_state: bool = False,
    ):
        """Returns (hidden, residual), or (hidden, residual, new_state) with
        ``return_state`` / ``return_ssm_state``."""
        if state is not None and ssm_state is not None:
            raise ValueError("Pass either state or ssm_state, not both.")
        if return_ssm_state and ssm_state is None:
            raise ValueError("return_ssm_state requires ssm_state.")
        if self.training and self.drop_path_rate > 0.0:
            raise NotImplementedError(
                "drop_path (training) is not ported; call .eval() to serve."
            )
        normed, new_residual = fused_add_norm(
            hidden_states, self.norm.weight, self.norm.bias, residual=residual,
            prenorm=True, residual_in_fp32=self.residual_in_fp32,
            eps=self.norm_epsilon, norm_type=self.norm_type,
            use_kernel=self.fused_add_norm,
        )
        if state is not None:
            mixer_out = self.mixer(normed, state=state, return_state=return_state)
        else:
            mixer_out = self.mixer(
                normed, ssm_state=ssm_state, return_ssm_state=return_ssm_state
            )
        if (return_state and state is not None) or return_ssm_state:
            hidden, new_state = mixer_out
            return hidden, new_residual, new_state
        return mixer_out, new_residual

    def allocate_state(self, batch_size: int, dtype=None, device=None) -> LayerState:
        return self.mixer.allocate_state(batch_size, dtype=dtype, device=device)


def create_block(
    d_model: int,
    ssm_cfg: Optional[Dict[str, object]] = None,
    norm_epsilon: float = 1e-5,
    drop_path: float = 0.0,
    rms_norm: bool = True,
    residual_in_fp32: bool = True,
    fused_add_norm: bool = True,
    layer_idx: Optional[int] = None,
    bimamba: bool = True,
    device=None,
    dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
) -> Block:
    """Block factory (videomamba_tpu/models/block.py:436-476). The inner
    mixer is unidirectional; ``ssm_cfg={"layer": "Mamba2"}`` (the SSD mixer)
    is not ported yet and raises."""
    del bimamba
    ssm_cfg = dict(ssm_cfg or {})
    ssm_cfg.pop("bimamba", None)
    layer_kind = str(ssm_cfg.pop("layer", "Mamba"))
    if layer_kind != "Mamba":
        raise NotImplementedError(f"ssm_cfg layer {layer_kind!r} is not ported")
    mixer = Mamba(d_model=d_model, layer_idx=layer_idx, device=device,
                  dtype=dtype, generator=generator, **ssm_cfg)
    return Block(
        dim=d_model,
        mixer=mixer,
        norm_type="rms" if rms_norm else "layer",
        norm_epsilon=norm_epsilon,
        fused_add_norm=fused_add_norm,
        residual_in_fp32=residual_in_fp32,
        drop_path_rate=drop_path,
        layer_idx=layer_idx,
        device=device,
    )
