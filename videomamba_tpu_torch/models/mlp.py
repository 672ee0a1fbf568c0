"""Gated MLP, the second sublayer of a hybrid language model's Block.

IBM Granite-4.0-H's ``shared_mlp`` (``GraniteMoeHybridMLP``): one bias-free
product ``input_linear`` to 2 x ``hidden_features`` columns split into a
gate g (the first half) and an up projection u (the second), then
``output_linear`` of silu(g) * u.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from videomamba_tpu_torch.models import initializers as init
from videomamba_tpu_torch.models.mamba import _linear
from videomamba_tpu_torch.runtime import resolve_device
from videomamba_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor


class GatedMLP(nn.Module):
    """(silu(g) * u) W_out^T with [g | u] = x W_in^T; weights drawn
    N(0, 0.02) (truncated at 2) from ``generator`` (default: seed 0)."""

    def __init__(self, d_model: int, hidden_features: int, device=None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.hidden_features = hidden_features
        self.input_linear = _linear(
            d_model, 2 * hidden_features,
            init.trunc_normal((2 * hidden_features, d_model), g), None, device, dtype)
        self.output_linear = _linear(
            hidden_features, d_model,
            init.trunc_normal((d_model, hidden_features), g), None, device, dtype)

    def forward(self, x: Tensor) -> Tensor:
        with annotate("vmt.model.mlp"):
            gu = x @ self.input_linear.weight.t()
            g, u = gu.split(self.hidden_features, dim=-1)
            return (F.silu(g) * u) @ self.output_linear.weight.t()
