"""VideoMamba model-size presets, as in videomamba_tpu/models/presets.py.

Tiny is the reference README quick-usage config; Small, Middle and Base
follow the VideoMamba paper sizing. The ``*_m2`` constructors build the same
sizes on the Mamba-2 (SSD) mixer with ``M2_SSM_CFG`` (d_state 64, headdim
64, chunk 128), any key of which ``ssm_cfg`` overrides.

:func:`granite_4_0_h_micro` builds the hybrid language model
(models/hybrid_lm.py) at IBM Granite-4.0-H-Micro's published sizes
(``GRANITE_4_0_H_MICRO``, the keys of
https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json
that shape the model).
"""

from __future__ import annotations

from typing import Any, Dict

from videomamba_tpu_torch.models.hybrid_lm import HybridMambaLM
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


_GRANITE_ATTENTION_AT = (5, 15, 25, 35)

GRANITE_4_0_H_MICRO: Dict[str, Any] = {
    "vocab_size": 100352,
    "hidden_size": 2048,
    "num_hidden_layers": 40,
    "layer_types": ["attention" if i in _GRANITE_ATTENTION_AT else "mamba"
                    for i in range(40)],
    "embedding_multiplier": 12,
    "residual_multiplier": 0.22,
    "logits_scaling": 8,
    "rms_norm_eps": 1e-5,
    "tie_word_embeddings": True,
    "intermediate_size": 8192,
    "shared_intermediate_size": 8192,
    "num_local_experts": 0,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "attention_multiplier": 0.015625,
    "attention_bias": False,
    "position_embedding_type": "nope",
    "mamba_n_heads": 64,
    "mamba_d_head": 64,
    "mamba_d_state": 128,
    "mamba_n_groups": 1,
    "mamba_d_conv": 4,
    "mamba_expand": 2,
    "mamba_chunk_size": 256,
    "mamba_conv_bias": True,
    "mamba_proj_bias": False,
    "max_position_embeddings": 131072,
}


def granite_4_0_h_micro(device=None, dtype=None, generator=None, **overrides) -> HybridMambaLM:
    """Granite-4.0-H-Micro (3,191,396,096 parameters); ``overrides`` replace
    configuration keys (``num_hidden_layers`` together with ``layer_types``)."""
    config = dict(GRANITE_4_0_H_MICRO)
    config.update(overrides)
    return HybridMambaLM(config, device=device, dtype=dtype, generator=generator)
