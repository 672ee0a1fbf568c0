"""Models of the PyTorch port (Mamba-1 VideoMamba)."""

from videomamba_tpu_torch.models.block import Block, create_block
from videomamba_tpu_torch.models.mamba import InferenceCache, Mamba
from videomamba_tpu_torch.models.presets import (
    videomamba_base,
    videomamba_middle,
    videomamba_small,
    videomamba_tiny,
)
from videomamba_tpu_torch.models.videomamba import (
    PatchEmbed,
    PretrainVideoMamba,
    build_videomamba,
)

__all__ = [
    "Block",
    "InferenceCache",
    "Mamba",
    "PatchEmbed",
    "PretrainVideoMamba",
    "build_videomamba",
    "create_block",
    "videomamba_base",
    "videomamba_middle",
    "videomamba_small",
    "videomamba_tiny",
]
