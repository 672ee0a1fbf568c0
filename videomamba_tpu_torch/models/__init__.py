"""Models of the PyTorch port (VideoMamba on the Mamba-1 and Mamba-2 mixers,
the refiner, and the hybrid Mamba-2 / attention language model)."""

from videomamba_tpu_torch.models.attention import Attention
from videomamba_tpu_torch.models.block import Block, create_block, drop_path
from videomamba_tpu_torch.models.hybrid_lm import HybridMambaLM
from videomamba_tpu_torch.models.mamba import InferenceCache, Mamba
from videomamba_tpu_torch.models.mamba2 import Mamba2
from videomamba_tpu_torch.models.mlp import GatedMLP
from videomamba_tpu_torch.models.presets import (
    GRANITE_4_0_H_MICRO,
    M2_SSM_CFG,
    granite_4_0_h_micro,
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
    "Attention",
    "BiMambaRefinerBlock",
    "Block",
    "GRANITE_4_0_H_MICRO",
    "GatedMLP",
    "HybridMambaLM",
    "InferenceCache",
    "M2_SSM_CFG",
    "Mamba",
    "Mamba2",
    "PatchEmbed",
    "PretrainVideoMamba",
    "build_videomamba",
    "create_block",
    "drop_path",
    "granite_4_0_h_micro",
    "videomamba_base",
    "videomamba_base_m2",
    "videomamba_middle",
    "videomamba_middle_m2",
    "videomamba_small",
    "videomamba_small_m2",
    "videomamba_tiny",
    "videomamba_tiny_m2",
]
