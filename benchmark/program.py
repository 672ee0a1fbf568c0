"""What the benchmark takes from the program (``videomamba_tpu_torch``): the
model built from a configuration file, and the kernels' launch counters.

Everything is imported inside the functions, after ``run.py`` has set the
cache directories; nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(config: dict) -> torch.dtype:
    return DTYPES[config["dtype"]]


def build_model(config: dict, weights: Dict[str, torch.Tensor], pool_type: str = "avg"):
    """The port's ``PretrainVideoMamba`` at the configuration's sizes, whose
    parameters are ``weights`` themselves, on their device (fp32 masters;
    the caller casts for serving). It is built on the meta device, so its
    constructor draws no weights of its own, and every parameter is then
    taken from ``weights`` by name (strict)."""
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba

    with torch.device("meta"):
        model = PretrainVideoMamba(
            img_size=config["img_size"], patch_size=config["patch_size"],
            depth=config["depth"], embed_dim=config["embed_dim"], channels=config["channels"],
            drop_path_rate=0.0, ssm_cfg=dict(config["ssm_cfg"]),
            norm_epsilon=config["norm_epsilon"], fused_add_norm=config["fused_add_norm"],
            rms_norm=config["rms_norm"], residual_in_fp32=config["residual_in_fp32"],
            bimamba=True, pool_type=pool_type, kernel_size=config["tubelet_size"],
            num_frames=config["num_frames"], device="meta",
        )
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def cast_for_serving(model, config: dict):
    """The port's bf16 serving cast (its own rule of which parameters stay
    fp32), or nothing at fp32."""
    from videomamba_tpu_torch.utils.precision import cast_module_for_compute

    dtype = compute_dtype(config)
    if dtype != torch.float32:
        cast_module_for_compute(model, dtype)
    return model


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's ``launches`` counter, by wrapper name."""
    import videomamba_tpu_torch.ops.kernels as kernels

    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        module = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for name, fn in vars(module).items():
            count = getattr(fn, "launches", None)
            if callable(fn) and isinstance(count, int):
                out[name] = count
    return out


def counts_launches(device) -> bool:
    """Whether the kernel wrappers launch, and count, on ``device``: on the
    card; on the host every wrapper runs its plain version."""
    return torch.device(device).type == "cuda"


def kernel_library():
    """The port's built kernel library (builds it on a first run in a
    checkout), or None where it has none to give (no card)."""
    if not torch.cuda.is_available():
        return None
    from videomamba_tpu_torch.ops.kernels import _build

    return _build.library()
