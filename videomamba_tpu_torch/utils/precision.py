"""Precision: cast a model's weights to the compute dtype.

Port of videomamba_tpu/utils/precision.py. For serving,
:func:`cast_module_for_compute` casts a module's parameters in place; for
mixed-precision training, :func:`cast_params_for_compute` returns cast
copies for ``torch.func.functional_call`` through a differentiable cast, so
the fp32 master parameters receive fp32 gradients (JAX precision.py:38-55). Parameters that must stay fp32
for numerical fidelity keep their dtype: ``A_log``, ``D``, ``dt_proj.bias``,
every norm's weight and bias (a Block's ``norm2`` too), and ``pool_norm``;
everything else (products' weights, embeddings, conv taps and biases) is
cast. The selective scan and the norms compute in fp32 whatever the
storage dtype.
"""

from __future__ import annotations

import torch
from torch import nn

_KEEP_FP32_SUFFIXES = ("A_log", "D", "dt_proj.bias")
_KEEP_FP32_SEGMENTS = (".norm.", ".norm2.", "pool_norm")


def keep_fp32(name: str) -> bool:
    """Whether the parameter ``name`` (a ``named_parameters`` key) stays fp32."""
    if any(name.endswith(sfx) for sfx in _KEEP_FP32_SUFFIXES):
        return True
    padded = "." + name + "."
    return any(seg in padded for seg in _KEEP_FP32_SEGMENTS)


@torch.no_grad()
def cast_module_for_compute(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast ``module``'s fp32 parameters to ``dtype`` in place, except those
    :func:`keep_fp32` names, and return the module."""
    for name, param in module.named_parameters():
        if param.dtype == torch.float32 and not keep_fp32(name):
            param.data = param.data.to(dtype)
    return module


def cast_params_for_compute(module: nn.Module, dtype=torch.bfloat16):
    """Name -> tensor for every parameter of ``module``: fp32 parameters that
    :func:`keep_fp32` rejects are cast to ``dtype`` with ``.to`` (autograd
    records the cast), the others are the parameters themselves."""
    return {
        name: param.to(dtype) if param.dtype == torch.float32 and not keep_fp32(name)
        else param
        for name, param in module.named_parameters()
    }
