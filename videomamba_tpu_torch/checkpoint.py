"""Weights in and out of the PyTorch port.

``params_from_jax`` maps a videomamba_tpu parameter tree (as NumPy arrays)
onto this package's state_dict, with the layout mapping of
videomamba_tpu/checkpoint.py:224-277 (params_to_torch_state_dict):

  Linear ``kernel (in, out)``         -> ``weight (out, in)``
  depthwise conv ``weight (W, D)``    -> ``conv1d.weight (D, 1, W)``
  patch ``kernel (C*kt*p*p, E)``      -> ``patch_embed.proj.weight (E, C, kt, p, p)``
  everything else                     -> unchanged

for both mixers: Mamba-1's in_proj, conv1d, x_proj, dt_proj, A_log, D,
out_proj and Mamba-2's in_proj, conv1d, dt_bias, A_log, D, norm, out_proj.

It reads NumPy only and never imports jax. ``load_state_dict`` loads a
state_dict strictly: a missing or unexpected key raises. A bf16 tree (from
``cast_params_for_compute``) maps to fp32 tensors holding the same values,
which load exactly into a model built at bf16.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Tensor = torch.Tensor

# Mixer keys in state_dict order (the JAX exporter's, checkpoint.py:246-272).
_MAMBA1_KEYS = ("in_proj", "conv1d", "x_proj", "dt_proj", "A_log", "D", "out_proj")
_MAMBA2_KEYS = ("in_proj", "conv1d", "dt_bias", "A_log", "D", "norm", "out_proj")


def params_from_jax(tree: Mapping[str, Any], model) -> Dict[str, Tensor]:
    """State_dict (fp32 CPU tensors) for ``model`` from a JAX param tree.

    ``tree`` is ``PretrainVideoMamba.params`` of videomamba_tpu with NumPy
    leaves; ``model`` is this package's PretrainVideoMamba, which supplies the
    patch geometry the flat patch kernel does not carry.
    """
    sd: Dict[str, Tensor] = {}

    def put(name: str, v) -> None:
        sd[name] = torch.from_numpy(np.array(v, dtype=np.float32))

    e, c, kt, p1, p2 = model.patch_embed.proj.weight.shape
    put("patch_embed.proj.weight",
        np.asarray(tree["patch_embed"]["kernel"], np.float32).T.reshape(e, c, kt, p1, p2))
    put("patch_embed.proj.bias", tree["patch_embed"]["bias"])
    put("cls_token", tree["cls_token"])
    put("pos_embed", tree["pos_embed"])
    put("temporal_pos_embedding", tree["temporal_pos_embedding"])
    for i, lp in enumerate(tree["layers"]):
        pfx = f"layers.{i}."
        put(pfx + "norm.weight", lp["norm"]["weight"])
        if "bias" in lp["norm"]:
            put(pfx + "norm.bias", lp["norm"]["bias"])
        mx = lp["mixer"]
        mpfx = pfx + "mixer."
        names = _MAMBA1_KEYS if "x_proj" in mx else _MAMBA2_KEYS
        for name in (n for n in names if n in mx):
            leaf = mx[name]
            if not isinstance(leaf, Mapping):  # A_log, D, dt_bias
                put(mpfx + name, leaf)
                continue
            if name == "conv1d":
                w = np.asarray(leaf["weight"], np.float32).T[:, None, :]
            elif "kernel" in leaf:
                w = np.asarray(leaf["kernel"], np.float32).T
            else:  # Mamba-2's gated-norm weight
                w = leaf["weight"]
            put(mpfx + name + ".weight", w)
            if "bias" in leaf:
                put(mpfx + name + ".bias", leaf["bias"])
    put("norm.weight", tree["norm"]["weight"])
    if "bias" in tree["norm"]:
        put("norm.bias", tree["norm"]["bias"])
    if "pool_norm" in tree:
        put("pool_norm.weight", tree["pool_norm"]["weight"])
        put("pool_norm.bias", tree["pool_norm"]["bias"])
    return sd


def load_state_dict(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> None:
    """Copy ``state_dict`` (tensors or NumPy arrays) into ``model`` strictly;
    values are cast to each parameter's dtype and device."""
    sd = {
        k: v if isinstance(v, Tensor) else torch.from_numpy(np.asarray(v))
        for k, v in state_dict.items()
    }
    model.load_state_dict(sd, strict=True)
