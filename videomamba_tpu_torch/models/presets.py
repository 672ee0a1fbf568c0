"""VideoMamba model-size presets (Mamba-1), as in videomamba_tpu/models/presets.py.

Tiny is the reference README quick-usage config; Small, Middle and Base
follow the VideoMamba paper sizing. The Mamba-2 (``*_m2``) constructors are
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba

PRESETS: Dict[str, Dict[str, Any]] = {
    "tiny": dict(embed_dim=192, depth=24),
    "small": dict(embed_dim=384, depth=24),
    "middle": dict(embed_dim=576, depth=32),
    "base": dict(embed_dim=768, depth=24),
}


def _build(preset: str, **overrides) -> PretrainVideoMamba:
    kwargs: Dict[str, Any] = dict(
        img_size=224,
        patch_size=16,
        channels=3,
        drop_path_rate=0.0,
        ssm_cfg=None,
        norm_epsilon=1e-5,
        fused_add_norm=True,
        rms_norm=True,
        residual_in_fp32=True,
        bimamba=True,
        pool_type="cls+avg",
        kernel_size=1,
        num_frames=8,
    )
    kwargs.update(PRESETS[preset])
    kwargs.update(overrides)
    return PretrainVideoMamba(**kwargs)


def videomamba_tiny(**overrides) -> PretrainVideoMamba:
    return _build("tiny", **overrides)


def videomamba_small(**overrides) -> PretrainVideoMamba:
    return _build("small", **overrides)


def videomamba_middle(**overrides) -> PretrainVideoMamba:
    return _build("middle", **overrides)


def videomamba_base(**overrides) -> PretrainVideoMamba:
    return _build("base", **overrides)
