"""Determinism: seeding and the numerics switches of PyTorch on CUDA.

Port of videomamba_tpu/determinism.py (the reference's determinism.py),
with the knobs PyTorch has:

  seed             -> seeds ``random``, NumPy and ``torch.manual_seed`` (every
                      device), and roots :func:`get_rng_key` /
                      :func:`next_rng_key`
  deterministic    -> ``torch.use_deterministic_algorithms(deterministic,
                      warn_only=warn_only)`` and ``cudnn.deterministic``
  cudnn_benchmark  -> ``torch.backends.cudnn.benchmark``
  allow_tf32       -> ``torch.backends.cuda.matmul.allow_tf32`` and
                      ``torch.backends.cudnn.allow_tf32``

``cudnn_benchmark`` and ``allow_tf32`` are tri-state: None means the
inverse of ``deterministic``, the reference's rule. So
``configure_determinism(seed, deterministic=False)`` turns TF32 on: fp32
products then round their inputs to 10 mantissa bits, and the port's fp32
bars (1e-5 against the JAX package) no longer hold. That is the reference's
contract; pass ``allow_tf32=False`` to keep fp32 products exact.

Deterministic mode has two costs to know of. cuBLAS refuses to run unless
``CUBLAS_WORKSPACE_CONFIG`` is set, so :func:`configure_determinism` sets it
to ``:4096:8`` when deterministic and unset (it takes full effect only if
no cuBLAS call ran before). And PyTorch fills every ``torch.empty`` with
NaN (``torch.utils.deterministic.fill_uninitialized_memory``), so a kernel
that reads lanes it never wrote shows it there.

The kernels of this package use no atomics in their reductions: their
results are bit-identical run to run in either mode.
"""

from __future__ import annotations

import argparse
import os
import random
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

CUBLAS_WORKSPACE = ":4096:8"


@dataclass(frozen=True)
class DeterminismConfig:
    seed: int = 0
    deterministic: bool = False
    warn_only: bool = True
    cudnn_benchmark: bool = True
    allow_tf32: bool = True


class _KeyCounter:
    """The root seed of the last :func:`configure_determinism` and the count
    of keys drawn since."""

    def __init__(self) -> None:
        self.seed = 0
        self.count = 0


_KEYS = _KeyCounter()


def _key_seed(seed: int, count: int) -> int:
    """The seed of key ``count`` under root ``seed``: the first 64-bit word
    of ``numpy.random.SeedSequence((seed, count))``. Count 0 is the root."""
    return int(np.random.SeedSequence((seed, count)).generate_state(1, np.uint64)[0])


def get_rng_key() -> torch.Generator:
    """A CPU ``torch.Generator`` seeded with the root key of the last
    :func:`configure_determinism` call (seed 0 before any call); each call
    returns a new generator in the same state."""
    return torch.Generator().manual_seed(_key_seed(_KEYS.seed, 0))


def next_rng_key() -> torch.Generator:
    """A CPU ``torch.Generator`` for the next key: key k (k = 1, 2, ... since
    the last :func:`configure_determinism`) is seeded with
    ``SeedSequence((seed, k))``'s first 64-bit word, so a seed and a count
    fix every draw."""
    _KEYS.count += 1
    return torch.Generator().manual_seed(_key_seed(_KEYS.seed, _KEYS.count))


def configure_determinism(
    seed: int,
    deterministic: bool,
    warn_only: bool = True,
    cudnn_benchmark: Optional[bool] = None,
    allow_tf32: Optional[bool] = None,
) -> DeterminismConfig:
    """Seed every RNG and set PyTorch's numerics switches; returns the
    resolved config. ``cudnn_benchmark`` and ``allow_tf32`` default to
    ``not deterministic``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    _KEYS.seed, _KEYS.count = int(seed), 0

    if cudnn_benchmark is None:
        cudnn_benchmark = not deterministic
    if allow_tf32 is None:
        allow_tf32 = not deterministic

    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(bool(deterministic), warn_only=bool(warn_only))
    torch.backends.cudnn.deterministic = bool(deterministic)
    torch.backends.cudnn.benchmark = bool(cudnn_benchmark)
    torch.backends.cuda.matmul.allow_tf32 = bool(allow_tf32)
    torch.backends.cudnn.allow_tf32 = bool(allow_tf32)

    return DeterminismConfig(
        seed=seed,
        deterministic=bool(deterministic),
        warn_only=bool(warn_only),
        cudnn_benchmark=bool(cudnn_benchmark),
        allow_tf32=bool(allow_tf32),
    )


def add_determinism_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's command-line flags, with the same names and choices."""
    parser.add_argument("--seed", type=int, default=0, help="Random seed.")
    parser.add_argument(
        "--deterministic",
        action="store_true",
        help="Enable deterministic algorithms (torch.use_deterministic_algorithms).",
    )
    parser.add_argument(
        "--deterministic-warn-only",
        action="store_true",
        help="Use warn-only mode for deterministic algorithm enforcement.",
    )
    parser.add_argument(
        "--cudnn-benchmark",
        choices=["on", "off", "auto"],
        default="auto",
        help="cuDNN autotuning. auto => inverse of --deterministic.",
    )
    parser.add_argument(
        "--allow-tf32",
        choices=["on", "off", "auto"],
        default="auto",
        help="TF32 in fp32 matmuls and convolutions. auto => inverse of --deterministic.",
    )
    return parser


def _tri_state_to_bool(value: str) -> Optional[bool]:
    if value == "on":
        return True
    if value == "off":
        return False
    return None


def configure_determinism_from_args(args: argparse.Namespace) -> DeterminismConfig:
    """:func:`configure_determinism` from :func:`add_determinism_args`' flags
    (warn-only off unless ``--deterministic-warn-only``)."""
    return configure_determinism(
        seed=int(args.seed),
        deterministic=bool(args.deterministic),
        warn_only=bool(args.deterministic_warn_only),
        cudnn_benchmark=_tri_state_to_bool(args.cudnn_benchmark),
        allow_tf32=_tri_state_to_bool(args.allow_tf32),
    )
