"""Data-side helpers of the PyTorch port: mask generation, streaming chunk
iteration, datasets and the native clip loader (``data.native``)."""

from videomamba_tpu_torch.data.dataset import (
    load_file_list,
    make_clip_loader,
    scan_class_directories,
)
from videomamba_tpu_torch.data.masking import RandomMaskingGenerator, TubeMaskingGenerator
from videomamba_tpu_torch.data.video import chunk_video, iter_video_chunks

__all__ = [
    "RandomMaskingGenerator",
    "TubeMaskingGenerator",
    "chunk_video",
    "iter_video_chunks",
    "load_file_list",
    "make_clip_loader",
    "scan_class_directories",
]
