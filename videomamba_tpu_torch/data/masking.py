"""Mask generators for VideoMAE-style masked pretraining (PyTorch port).

Port of videomamba_tpu/data/masking.py, kept as NumPy code: a mask is
host-side data (the model validates it and computes the visible positions on
the host). The generators make masks that satisfy the model's contract by
construction:

* shape [B, 1 + T'*H'*W'] (CLS slot first, post-tubelet token grid),
* CLS always visible,
* the same number of visible tokens per sample (the reference's rule,
  which also gives the visible-token gather one shape per batch).

True = masked (hidden), False = visible, the reference's convention. For one
``np.random.default_rng(seed)`` the masks are bit-equal to the JAX
package's: the same ``shuffle`` calls in the same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class TubeMaskingGenerator:
    """Tube masking: one spatial mask shared across all temporal tokens
    (VideoMAE's strategy: masks 'tubes' through time)."""

    def __init__(self, input_size: Tuple[int, int, int], mask_ratio: float,
                 with_cls: bool = True):
        """input_size: (T', H', W') in post-tubelet token units."""
        self.frames, self.height, self.width = input_size
        self.num_patches_per_frame = self.height * self.width
        self.num_masks_per_frame = int(mask_ratio * self.num_patches_per_frame)
        self.with_cls = with_cls
        if not 0 <= self.num_masks_per_frame <= self.num_patches_per_frame:
            raise ValueError(f"mask_ratio {mask_ratio} out of range.")

    @property
    def tokens_per_sample(self) -> int:
        return (1 if self.with_cls else 0) + self.frames * self.num_patches_per_frame

    def __call__(self, batch_size: int = 1,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        masks = np.zeros((batch_size, self.tokens_per_sample), dtype=bool)
        offset = 1 if self.with_cls else 0
        for b in range(batch_size):
            frame_mask = np.zeros(self.num_patches_per_frame, dtype=bool)
            frame_mask[: self.num_masks_per_frame] = True
            rng.shuffle(frame_mask)
            masks[b, offset:] = np.tile(frame_mask, self.frames)
        return masks

    def __repr__(self):
        return (
            f"TubeMaskingGenerator(frames={self.frames}, "
            f"grid={self.height}x{self.width}, "
            f"masks_per_frame={self.num_masks_per_frame})"
        )


class RandomMaskingGenerator:
    """Uniform random masking with an exact per-sample visible count."""

    def __init__(self, input_size: Tuple[int, int, int], mask_ratio: float,
                 with_cls: bool = True):
        self.frames, self.height, self.width = input_size
        self.total_patches = self.frames * self.height * self.width
        self.num_masks = int(mask_ratio * self.total_patches)
        self.with_cls = with_cls
        if not 0 <= self.num_masks <= self.total_patches:
            raise ValueError(f"mask_ratio {mask_ratio} out of range.")

    @property
    def tokens_per_sample(self) -> int:
        return (1 if self.with_cls else 0) + self.total_patches

    def __call__(self, batch_size: int = 1,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        masks = np.zeros((batch_size, self.tokens_per_sample), dtype=bool)
        offset = 1 if self.with_cls else 0
        for b in range(batch_size):
            flat = np.zeros(self.total_patches, dtype=bool)
            flat[: self.num_masks] = True
            rng.shuffle(flat)
            masks[b, offset:] = flat
        return masks
