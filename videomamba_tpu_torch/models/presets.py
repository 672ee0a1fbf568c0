"""VideoMamba model-size presets, as in videomamba_tpu/models/presets.py.

Tiny is the reference README quick-usage config; Small, Middle and Base
follow the VideoMamba paper sizing. The ``*_m2`` constructors build the same
sizes on the Mamba-2 (SSD) mixer with ``M2_SSM_CFG`` (d_state 64, headdim
64, chunk 128), any key of which ``ssm_cfg`` overrides.
"""

from __future__ import annotations

from typing import Any, Dict

from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba

M2_SSM_CFG: Dict[str, Any] = {
    "layer": "Mamba2",
    "d_state": 64,
    "headdim": 64,
    "chunk_size": 128,
}

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


def _build_m2(preset: str, **overrides) -> PretrainVideoMamba:
    ssm_cfg = dict(M2_SSM_CFG)
    user_cfg = overrides.pop("ssm_cfg", None)
    if user_cfg:
        ssm_cfg.update(user_cfg)
    return _build(preset, ssm_cfg=ssm_cfg, **overrides)


def videomamba_tiny_m2(**overrides) -> PretrainVideoMamba:
    return _build_m2("tiny", **overrides)


def videomamba_small_m2(**overrides) -> PretrainVideoMamba:
    return _build_m2("small", **overrides)


def videomamba_middle_m2(**overrides) -> PretrainVideoMamba:
    return _build_m2("middle", **overrides)


def videomamba_base_m2(**overrides) -> PretrainVideoMamba:
    return _build_m2("base", **overrides)
