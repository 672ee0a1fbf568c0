"""Seeded weights of a hybrid language model configuration, and the port's
model built from them.

The configuration files of this kind (``configs/granite_h_micro.json``)
hold the keys of the model's published ``config.json``. The weights carry
the port's names (``embed_tokens.weight``, ``layers.{i}.mixer.*``,
``layers.{i}.mlp.*``, ...), which the port loads strictly and the plain
reference (``reference/granite_hybrid.py``) reads. Each leaf is one draw, in
a fixed order, from one ``torch.Generator`` on the device: the same seed
gives the same weights on every run. fp32 throughout: the port casts what
it computes in, the reference computes in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.seeds import torch_generator

# (name, shape, kind, argument). Kinds: "normal" (std), "uniform" (bound:
# U(-b, b)), "jitter" (1 + std * N), "dt_bias" (softplus inverse of a dt
# log-uniform in [1e-3, 1e-1]), "a_log" (log U(1, 16)).
Spec = List[Tuple[str, Tuple[int, ...], str, float]]

DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4
A_INIT_RANGE = (1.0, 16.0)
STD = 0.02


def spec(config: dict) -> Spec:
    """Every parameter of the configuration with its draw."""
    d, vocab = config["hidden_size"], config["vocab_size"]
    width = config.get("shared_intermediate_size") or config["intermediate_size"]
    out = [("embed_tokens.weight", (vocab, d), "normal", STD)]
    for i, kind in enumerate(config["layer_types"]):
        p, m = f"layers.{i}.", f"layers.{i}.mixer."
        out.append((p + "norm.weight", (d,), "jitter", 0.1))
        if kind == "mamba":
            h, hd = config["mamba_n_heads"], config["mamba_d_head"]
            g, n, w = config["mamba_n_groups"], config["mamba_d_state"], config["mamba_d_conv"]
            di = h * hd
            cd = di + 2 * g * n
            out += [
                (m + "in_proj.weight", (2 * di + 2 * g * n + h, d), "normal", STD),
                (m + "conv1d.weight", (cd, 1, w), "uniform", 1 / math.sqrt(w)),
                (m + "conv1d.bias", (cd,), "uniform", 1 / math.sqrt(w)),
                (m + "dt_bias", (h,), "dt_bias", 0.0),
                (m + "A_log", (h,), "a_log", 0.0),
                (m + "D", (h,), "jitter", 0.1),
                (m + "norm.weight", (di,), "jitter", 0.1),
                (m + "out_proj.weight", (d, di), "normal", STD),
            ]
        else:
            hq, hk = config["num_attention_heads"], config["num_key_value_heads"]
            hd = config.get("head_dim") or d // hq
            out += [
                (m + "q_proj.weight", (hq * hd, d), "normal", STD),
                (m + "k_proj.weight", (hk * hd, d), "normal", STD),
                (m + "v_proj.weight", (hk * hd, d), "normal", STD),
                (m + "o_proj.weight", (d, hq * hd), "normal", STD),
            ]
        out += [
            (p + "norm2.weight", (d,), "jitter", 0.1),
            (p + "mlp.input_linear.weight", (2 * width, d), "normal", STD),
            (p + "mlp.output_linear.weight", (d, width), "normal", STD),
        ]
    out.append(("norm.weight", (d,), "jitter", 0.1))
    return out


def count(config: dict) -> int:
    """The number of parameters."""
    return sum(math.prod(shape) for _, shape, _, _ in spec(config))


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights for ``seed``, fp32 on ``device``, by name."""
    g = torch_generator(seed, "weights", device)
    out = {}
    for name, shape, kind, arg in spec(config):
        if kind == "normal":
            t = torch.randn(shape, generator=g, device=device) * arg
        elif kind == "jitter":
            t = 1 + torch.randn(shape, generator=g, device=device) * arg
        else:
            u = torch.rand(shape, generator=g, device=device)
            if kind == "uniform":
                t = (2 * u - 1) * arg
            elif kind == "dt_bias":
                dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
                dt = dt.clamp(min=DT_FLOOR)
                t = dt + torch.log(-torch.expm1(-dt))
            else:
                lo, hi = A_INIT_RANGE
                t = torch.log(u * (hi - lo) + lo)
        out[name] = t
    return out


def build_model(config: dict, weights: Dict[str, torch.Tensor]):
    """The port's ``HybridMambaLM`` at the configuration's sizes, whose
    parameters are ``weights`` themselves, on their device (built on the
    meta device, so its constructor draws nothing; loaded strictly)."""
    from videomamba_tpu_torch.models.hybrid_lm import HybridMambaLM

    with torch.device("meta"):
        model = HybridMambaLM(config, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    return model
