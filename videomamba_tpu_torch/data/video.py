"""Streaming chunk iteration over videos (PyTorch port).

Port of videomamba_tpu/data/video.py: slice a long video [B, C, T, H, W]
(a torch tensor or a NumPy array) into temporal chunks aligned to the
tubelet size, yielding (chunk, temporal_pos_offset) pairs that plug into
``model(chunk, ssm_state=state, temporal_pos_offset=o)`` or
``StreamingSession.process``.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union

import numpy as np
import torch

Video = Union[torch.Tensor, np.ndarray]


def chunk_video(total_frames: int, chunk_frames: int, tubelet_size: int = 1):
    """Yield (start_frame, end_frame, temporal_pos_offset) triples.

    The final chunk is truncated to the remaining frames, rounded down to a
    multiple of the tubelet size (frames that cannot form a whole tubelet
    are dropped, as the model requires divisibility).
    """
    if chunk_frames % tubelet_size != 0:
        raise ValueError(
            f"chunk_frames ({chunk_frames}) must be divisible by "
            f"tubelet_size ({tubelet_size})."
        )
    start = 0
    while start < total_frames:
        end = min(start + chunk_frames, total_frames)
        usable = ((end - start) // tubelet_size) * tubelet_size
        if usable == 0:
            return
        end = start + usable
        yield start, end, start // tubelet_size
        start = end


def iter_video_chunks(
    video: Video, chunk_frames: int, tubelet_size: int = 1
) -> Iterator[Tuple[Video, int]]:
    """Iterate (chunk [B, C, Tc, H, W], temporal_pos_offset) over a video;
    each chunk is a view of ``video``, of its type."""
    if video.ndim != 5:
        raise ValueError("video must have shape [B, C, T, H, W].")
    for start, end, offset in chunk_video(video.shape[2], chunk_frames, tubelet_size):
        yield video[:, :, start:end], offset
