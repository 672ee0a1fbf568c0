"""Models of the PyTorch port (VideoMamba on the Mamba-1 and Mamba-2 mixers,
and the refiner)."""

from videomamba_tpu_torch.models.block import Block, create_block, drop_path
from videomamba_tpu_torch.models.mamba import InferenceCache, Mamba
from videomamba_tpu_torch.models.mamba2 import Mamba2
from videomamba_tpu_torch.models.presets import (
    M2_SSM_CFG,
    videomamba_base,
    videomamba_base_m2,
    videomamba_middle,
    videomamba_middle_m2,
    videomamba_small,
    videomamba_small_m2,
    videomamba_tiny,
    videomamba_tiny_m2,
)
from videomamba_tpu_torch.models.refiner import BiMambaRefinerBlock
from videomamba_tpu_torch.models.videomamba import (
    PatchEmbed,
    PretrainVideoMamba,
    build_videomamba,
)

__all__ = [
    "BiMambaRefinerBlock",
    "Block",
    "InferenceCache",
    "M2_SSM_CFG",
    "Mamba",
    "Mamba2",
    "PatchEmbed",
    "PretrainVideoMamba",
    "build_videomamba",
    "create_block",
    "drop_path",
    "videomamba_base",
    "videomamba_base_m2",
    "videomamba_middle",
    "videomamba_middle_m2",
    "videomamba_small",
    "videomamba_small_m2",
    "videomamba_tiny",
    "videomamba_tiny_m2",
]
