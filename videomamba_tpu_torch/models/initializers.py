"""Weight initializers of the reference's init passes, drawn from an explicit
``torch.Generator``.

Port of videomamba_tpu/models/initializers.py: PyTorch module defaults
(kaiming-uniform a=sqrt(5)), timm ``trunc_normal_(std=0.02)``, and Mamba's
dt-bias / S4D-real A initializations, with Mamba-2's per-head dt bias (the
same draw over heads) and A_log = log(U(A_init_range)). Every draw happens on the CPU from the
caller's generator and is then moved, so one seed gives the same weights on
every device. The JAX package draws from ``jax.random``, so the two packages
give different weights for one seed; tests share weights through
``checkpoint.params_from_jax``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

Tensor = torch.Tensor


def uniform(shape: Sequence[int], low: float, high: float,
             generator: torch.Generator) -> Tensor:
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return u * (high - low) + low


def trunc_normal(shape: Sequence[int], generator: torch.Generator,
                 std: float = 0.02, lower: float = -2.0,
                 upper: float = 2.0) -> Tensor:
    """timm trunc_normal_: N(0, std) clipped at absolute bounds [lower, upper]
    (at std 0.02 the bounds are ~100 sigma away)."""
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32) * std
    return x.clamp(lower, upper)


def kaiming_uniform(shape: Sequence[int], fan_in: int, generator: torch.Generator,
                    a: float = math.sqrt(5.0)) -> Tensor:
    """torch.nn.init.kaiming_uniform_ with leaky-relu slope ``a``; for the
    default a=sqrt(5) this is U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = gain * math.sqrt(3.0 / fan_in)
    return uniform(shape, -bound, bound, generator)


def default_bias(shape: Sequence[int], fan_in: int,
                 generator: torch.Generator) -> Tensor:
    """PyTorch Linear/Conv default bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return uniform(shape, -bound, bound, generator)


def dt_bias_init(d_inner: int, dt_min: float, dt_max: float,
                 dt_init_floor: float, generator: torch.Generator) -> Tensor:
    """Softplus-inverse dt bias: softplus(bias) lands log-uniformly in
    [dt_min, dt_max] (mamba_simple.py:251-261)."""
    u = torch.rand((d_inner,), generator=generator, dtype=torch.float32)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp(min=dt_init_floor)
    return dt + torch.log(-torch.expm1(-dt))


def a_log_uniform(nheads: int, low: float, high: float,
                  generator: torch.Generator) -> Tensor:
    """Mamba-2's per-head A init: A_log = log(U(low, high)) (JAX
    models/mamba2.py:145-150)."""
    if not 0 < low <= high:
        raise ValueError(f"A_init_range=({low}, {high}) must be positive")
    return torch.log(uniform((nheads,), low, high, generator))


def s4d_real_A_log(d_inner: int, d_state: int) -> Tensor:
    """S4D-real A init: A_log[d, n] = log(n + 1)."""
    a = torch.arange(1, d_state + 1, dtype=torch.float32)
    return torch.log(a).expand(d_inner, d_state).clone()
