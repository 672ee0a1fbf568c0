"""Optimizer factory — port of videomamba_tpu/utils/optimizer.py (30-159).

The same parameter grouping, as ``torch.optim`` parameter groups over the
model's parameter names (the reference's names, which are the port's own):

* no weight decay for 1-D parameters and ``*.bias`` (``filter_bias_and_bn``),
  for the names in ``model.no_weight_decay()``, and for the mixer's
  ``A_log`` and ``D``;
* a regex-matched group with its own learning rate (``different_lr``);
* sgd / nesterov / momentum / adam / adamw. Weight decay is L2 added to the
  gradient for sgd, momentum and adam (optax ``add_decayed_weights`` before
  the update) and decoupled for adamw, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional

import torch
from torch import nn

# Leaf names the reference tags with _no_weight_decay (mamba_simple.py:273,277).
_NO_DECAY_LEAF_NAMES = ("A_log", "D")


def weight_decay_mask(model: nn.Module, no_decay_list: Iterable[str] = (),
                      filter_bias_and_bn: bool = True) -> Dict[str, bool]:
    """Name -> True where weight decay applies (JAX weight_decay_mask)."""
    no_decay = set(no_decay_list)
    mask = {}
    for path, param in model.named_parameters():
        decay = True
        if filter_bias_and_bn and (param.ndim <= 1 or path.endswith(".bias")):
            decay = False
        elif any(path.endswith(n) or path == n for n in no_decay):
            decay = False
        if path.split(".")[-1] in _NO_DECAY_LEAF_NAMES:
            decay = False
        if path.split(".")[0] in no_decay:
            decay = False
        mask[path] = decay
    return mask


def different_lr_mask(model: nn.Module, diff_lr_names: Iterable[str]) -> Dict[str, bool]:
    """Name -> True where the alternate learning rate applies (regex search)."""
    patterns = list(diff_lr_names)
    return {path: any(re.search(p, path) is not None for p in patterns)
            for path, _ in model.named_parameters()}


def create_optimizer(args, model: nn.Module, filter_bias_and_bn: bool = True,
                     learning_rate: Optional[float] = None) -> torch.optim.Optimizer:
    """Build the optimizer from an args namespace (JAX optimizer.py:88-159).

    Recognised attributes: ``opt`` (sgd|nesterov|momentum|adam|adamw), ``lr``,
    ``weight_decay``, ``momentum``, ``opt_eps``, ``opt_betas``,
    ``different_lr.{enable,module_names,lr}``. ``learning_rate`` overrides
    ``args.lr``; a schedule is a ``torch.optim.lr_scheduler`` on the result
    (utils/scheduler.py)."""
    opt_lower = str(args.opt).lower().split("_")[-1]
    weight_decay = float(getattr(args, "weight_decay", 0.0))
    lr = float(learning_rate if learning_rate is not None else args.lr)
    no_decay = set(model.no_weight_decay()) if hasattr(model, "no_weight_decay") else set()
    wd_mask = weight_decay_mask(model, no_decay, filter_bias_and_bn)
    diff_cfg = getattr(args, "different_lr", None)
    diff_on = diff_cfg is not None and getattr(diff_cfg, "enable", False)
    diff_mask = (different_lr_mask(model, diff_cfg.module_names) if diff_on
                 else {k: False for k in wd_mask})

    groups: Dict[tuple, list] = {}
    for name, param in model.named_parameters():
        groups.setdefault((diff_mask[name], wd_mask[name]), []).append(param)
    param_groups = [
        {"params": params, "lr": float(diff_cfg.lr) if is_diff else lr,
         "weight_decay": weight_decay if decay else 0.0}
        for (is_diff, decay), params in groups.items()
    ]

    eps = getattr(args, "opt_eps", None)
    betas = getattr(args, "opt_betas", None)
    betas = tuple(betas) if betas is not None else (0.9, 0.999)
    eps = 1e-8 if eps is None else float(eps)
    if opt_lower in ("sgd", "nesterov", "momentum"):
        return torch.optim.SGD(param_groups, lr=lr, momentum=float(args.momentum),
                               nesterov=opt_lower != "momentum")
    if opt_lower == "adam":
        return torch.optim.Adam(param_groups, lr=lr, betas=betas, eps=eps)
    if opt_lower == "adamw":
        return torch.optim.AdamW(param_groups, lr=lr, betas=betas, eps=eps)
    raise ValueError(f"Invalid optimizer: {args.opt!r}")
