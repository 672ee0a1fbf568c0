"""Kernel-or-plain routing, the one rule every kernel wrapper follows.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the
CPU goes to the kernel's plain PyTorch version, which is also the reference
the kernels are tested against. There is no fallback: a wrapper given a CUDA
tensor launches its kernel or raises. ``use_fast_path=False`` on a mixer, or
``VIDEOMAMBA_DISABLE_FUSED`` in the environment, selects the plain path
explicitly on any device (videomamba_tpu/models/mamba.py:50-54, 264-266).
"""

from __future__ import annotations

import os

import torch

FUSED_KILL_SWITCH = "VIDEOMAMBA_DISABLE_FUSED"


def fused_disabled_by_env() -> bool:
    return os.getenv(FUSED_KILL_SWITCH, "").lower() in {
        "1", "true", "yes", "y", "on"
    }


def runs_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel).

    Raises for any other device: there is no kernel for it and no silent
    substitute.
    """
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel route for device {t.device}")
