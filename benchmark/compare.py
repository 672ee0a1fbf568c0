"""The comparisons that decide ``correct``."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in float64 on the host; 1 for a
    reference that is all zeros and an answer that is not, inf for a
    missing or non-finite answer."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        return float("inf")
    scale = want.abs().max().item()
    gap = (got - want).abs().max().item()
    if scale == 0.0:
        return 0.0 if gap == 0.0 else 1.0
    return gap / scale


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   names: Optional[Iterable[str]] = None, own: bool = False) -> float:
    """The largest |‖got‖ - ‖want‖| over leaves, each measured against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; with ``own``, against the leaf's own norm alone. A leaf one
    side lacks counts with norm 0 there."""
    names = sorted(set(got) | set(want)) if names is None else sorted(names)
    if not names:
        return float("inf")
    median = statistics.median(want.get(n, 0.0) for n in names)
    worst = 0.0
    for n in names:
        g, w = got.get(n, 0.0), want.get(n, 0.0)
        scale = w if own else max(w, median)
        gap = abs(g - w)
        if gap != gap:  # NaN
            return float("inf")
        worst = max(worst, gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf")))
    return worst


def moved_leaves(first_grad: Dict[str, float], share: float = 1e-3):
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(first_grad.values())
    return {n for n, g in first_grad.items() if g >= share * median}
