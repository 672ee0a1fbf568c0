"""Positional-embedding resampling, bit-matched to PyTorch F.interpolate.

Port of videomamba_tpu/ops/resample.py. The interpolation is an explicit
dense matrix built in NumPy on the host (PyTorch's source-index math,
bicubic a=-0.75, align_corners=False), applied as one fp32 product, so the
port resamples exactly as the JAX package does.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from videomamba_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

_CUBIC_A = -0.75  # PyTorch bicubic coefficient


def _cubic_conv1(t: np.ndarray, a: float) -> np.ndarray:
    return ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0


def _cubic_conv2(t: np.ndarray, a: float) -> np.ndarray:
    return ((a * t - 5.0 * a) * t + 8.0 * a) * t - 4.0 * a


@functools.lru_cache(maxsize=256)
def linear_resample_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) matrix matching F.interpolate(mode='linear',
    align_corners=False)."""
    m = np.zeros((out_len, in_len), dtype=np.float64)
    if in_len == out_len:
        np.fill_diagonal(m, 1.0)
        return m.astype(np.float32)
    scale = in_len / out_len
    for j in range(out_len):
        src = max((j + 0.5) * scale - 0.5, 0.0)
        i0 = int(math.floor(src))
        lam = src - i0
        i0 = min(i0, in_len - 1)
        i1 = min(i0 + 1, in_len - 1)
        m[j, i0] += 1.0 - lam
        m[j, i1] += lam
    return m.astype(np.float32)


@functools.lru_cache(maxsize=256)
def cubic_resample_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) matrix matching one axis of
    F.interpolate(mode='bicubic', align_corners=False) (separable)."""
    m = np.zeros((out_len, in_len), dtype=np.float64)
    if in_len == out_len:
        np.fill_diagonal(m, 1.0)
        return m.astype(np.float32)
    scale = in_len / out_len
    for j in range(out_len):
        src = (j + 0.5) * scale - 0.5  # no clamp for cubic
        i = int(math.floor(src))
        t = src - i
        coeffs = (
            _cubic_conv2(np.float64(t + 1.0), _CUBIC_A),
            _cubic_conv1(np.float64(t), _CUBIC_A),
            _cubic_conv1(np.float64(1.0 - t), _CUBIC_A),
            _cubic_conv2(np.float64(2.0 - t), _CUBIC_A),
        )
        for k, c in enumerate(coeffs):
            idx = min(max(i - 1 + k, 0), in_len - 1)  # border replicate
            m[j, idx] += c
    return m.astype(np.float32)


def _matrix(m: np.ndarray, like: Tensor, site: str) -> Tensor:
    """``m`` on ``like``'s device: a copy from pageable host memory, which
    waits for the card (the span ``vmt.sync.<site>``)."""
    with annotate(f"vmt.sync.{site}"):
        return torch.from_numpy(m).to(device=like.device)


def resample_linear_1d(x: Tensor, out_len: int) -> Tensor:
    """Resample (..., L, C) along L; fp32 math, returns fp32."""
    w = _matrix(linear_resample_matrix(x.shape[-2], out_len), x, "resample_1d")
    return torch.einsum("ol,...lc->...oc", w, x.float())


def resample_bicubic_2d(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Resample a (..., H, W, C) grid; fp32 math, returns fp32.

    Separable cubic interpolation, identical to PyTorch's bicubic.
    """
    out_h, out_w = out_hw
    wh = _matrix(cubic_resample_matrix(x.shape[-3], out_h), x, "resample_2d")
    ww = _matrix(cubic_resample_matrix(x.shape[-2], out_w), x, "resample_2d")
    x32 = torch.einsum("oh,...hwc->...owc", wh, x.float())
    return torch.einsum("pw,...owc->...opc", ww, x32)


def infer_spatial_grid(token_count: int, reference_grid: Tuple[int, int]) -> Tuple[int, int]:
    """Aspect-ratio-closest factorization of a token count into (H, W):
    among all h * w == token_count, minimize (|h/w - ref_ratio|,
    |h - ref_h| + |w - ref_w|)."""
    if token_count <= 0:
        raise ValueError("Position embedding must contain at least one spatial token.")
    ref_h, ref_w = reference_grid
    ref_ratio = float(ref_h) / float(ref_w)
    best_hw = None
    best_score = None
    for h in range(1, int(math.isqrt(token_count)) + 1):
        if token_count % h != 0:
            continue
        w = token_count // h
        for hh, ww in ((h, w), (w, h)):
            score = (
                abs((float(hh) / float(ww)) - ref_ratio),
                abs(hh - ref_h) + abs(ww - ref_w),
            )
            if best_score is None or score < best_score:
                best_score = score
                best_hw = (hh, ww)
    if best_hw is None:
        raise ValueError(f"Unable to infer spatial grid from token count {token_count}.")
    return best_hw
