"""Kernel-or-plain routing, the one rule every kernel wrapper follows.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the
CPU goes to the kernel's plain PyTorch version, which is also the reference
the kernels are tested against. There is no fallback: a wrapper given a CUDA
tensor launches its kernel or raises. ``use_fast_path=False`` on a mixer, or
``VIDEOMAMBA_DISABLE_FUSED`` in the environment, selects the plain path
explicitly on any device (videomamba_tpu/models/mamba.py:50-54, 264-266).

The backward routes and the Mamba-2 (SSD) routes are the JAX package's own
switches, read at call time from the same environment variables, so one
environment drives both packages: ``VIDEOMAMBA_MIXER_BWD`` (mamba.py:107-113),
``VIDEOMAMBA_NORM_BWD`` (norm.py:59-61), ``VIDEOMAMBA_BLOCK_BWD``
(block.py:111-116), ``VIDEOMAMBA_SSD_METHOD`` and ``VIDEOMAMBA_SSD_PMIXER``
(dispatch.py:91-99, 176-195), ``VIDEOMAMBA_SSD_TRAIN_ROUTE`` and
``VIDEOMAMBA_SSD_BWD`` (dispatch.py:101-133).
"""

from __future__ import annotations

import os

import torch

FUSED_KILL_SWITCH = "VIDEOMAMBA_DISABLE_FUSED"


def fused_disabled_by_env() -> bool:
    return os.getenv(FUSED_KILL_SWITCH, "").lower() in {
        "1", "true", "yes", "y", "on"
    }


def _is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed`` DTensor (checked by type
    name, so no distributed module is imported here)."""
    return any(c.__name__ == "DTensor" for c in type(t).__mro__)


def runs_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel).

    Raises for any other device: there is no kernel for it and no silent
    substitute. Raises for a ``DTensor`` too: a kernel takes a rank's
    plain tensor (FSDP gathers a Block's parameters before its forward),
    never a distributed one, and no wrapper converts one quietly.
    """
    if _is_dtensor(t):
        raise TypeError(
            "a kernel wrapper was given a DTensor; pass the local or gathered plain tensor")
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def mixer_bwd_backend() -> str:
    """"fused" (K6, the default) or "composite" (a plain recompute of the
    conv and the products chained to K5), from VIDEOMAMBA_MIXER_BWD."""
    forced = os.getenv("VIDEOMAMBA_MIXER_BWD", "").strip().lower()
    return forced if forced in {"fused", "composite"} else "fused"


def norm_bwd_kernel() -> bool:
    """True when VIDEOMAMBA_NORM_BWD=pallas asks for the add-norm backward
    kernel (K8); otherwise the backward is autograd of the plain composition."""
    return os.getenv("VIDEOMAMBA_NORM_BWD", "").strip().lower() == "pallas"


def block_bwd_mode() -> str | None:
    """VIDEOMAMBA_BLOCK_BWD read once (JAX block.py:100-116): None when unset
    or unknown, else "fused" or "composite". It decides two things:

    - the backward of a differentiated whole-block call: K7, unless the mode
      is "composite" (autograd of a plain recompute whose scan is K1 / K5);
    - whether a training Block takes the whole-block route: only when the
      mode is "fused"; otherwise training takes the mixer route."""
    forced = os.getenv("VIDEOMAMBA_BLOCK_BWD", "").strip().lower()
    return forced if forced in {"fused", "composite"} else None


def block_bwd_backend() -> str:
    """"fused" (K7, the default) or "composite": :func:`block_bwd_mode` with
    an unset variable meaning K7."""
    return block_bwd_mode() or "fused"


def preferred_ssd_method() -> str:
    """The Mamba-2 fast path's SSD route, from VIDEOMAMBA_SSD_METHOD: "ref"
    (the sequential oracle) or "chunked" (plain chunked products) when
    forced, else "pallas", the kernel route (K14 or K12; their plain versions
    on CPU tensors). The JAX package picks "chunked" where Pallas cannot run;
    the port's kernels run on every device it builds on."""
    forced = os.getenv("VIDEOMAMBA_SSD_METHOD", "").strip().lower()
    return forced if forced in {"ref", "chunked"} else "pallas"


def ssd_pmixer_enabled() -> bool:
    """Whether a Mamba-2 layer may take the projected-mixer kernel (K14,
    in_proj and out_proj inside the kernel): on unless
    VIDEOMAMBA_SSD_PMIXER is 0/false/off/no, which selects the mixer kernel
    (K12) between ``torch.matmul`` projections."""
    return os.getenv("VIDEOMAMBA_SSD_PMIXER", "1").strip().lower() not in {
        "0", "false", "off", "no"
    }


def ssd_train_route() -> str:
    """How a differentiated projected-mixer call runs, from
    VIDEOMAMBA_SSD_TRAIN_ROUTE: "mixer" (the default) runs ``torch.matmul``
    projections around the mixer kernel's checkpointed forward (K12) and its
    backward (K13); "pmixer" runs the projected mixer's checkpointed forward
    and backward (K14). Serving calls take K14 either way."""
    v = os.getenv("VIDEOMAMBA_SSD_TRAIN_ROUTE", "mixer").strip().lower()
    return "pmixer" if v == "pmixer" else "mixer"


def ssd_bwd_fused_enabled() -> bool:
    """The mixer backward kernel (K13, the default) against the composite
    backward (VIDEOMAMBA_SSD_BWD=composite): a torch recompute of the conv
    and autograd of the epilogue around the bare scan's backward (K11)."""
    return os.getenv("VIDEOMAMBA_SSD_BWD", "fused").strip().lower() != "composite"
