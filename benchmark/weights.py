"""Seeded weights of a VideoMamba configuration, made on the device.

The names and layouts are the published VideoMamba / mamba_ssm checkpoint
layout (``layers.{i}.mixer.in_proj.weight`` ...), which the port loads
strictly and the plain reference reads. Every value comes from two draws of
a ``torch.Generator`` on the device, one normal and one uniform, each of
every element at once, cut into leaves and scaled; the same seed gives the
same weights on every run. fp32 throughout: the port casts what it
computes in, the reference computes in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.flops.model import mixer_dims
from benchmark.seeds import torch_generator

# (name, shape, kind, argument). Kinds: "normal" (std), "uniform" (bound:
# U(-b, b)), "jitter" (1 + std * N), "dt_bias" (softplus inverse of a dt
# log-uniform in [1e-3, 1e-1]), "s4d" (log(n + 1) + std * N), "a_log"
# (log U(1, 16)).
Spec = List[Tuple[str, Tuple[int, ...], str, float]]

DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4
A_INIT_RANGE = (1.0, 16.0)
_UNIFORM_KINDS = ("uniform", "dt_bias", "a_log")


def spec(config: dict) -> Spec:
    """Every parameter of the configuration with its draw."""
    e, depth = config["embed_dim"], config["depth"]
    c, kt, p = config["channels"], config["tubelet_size"], config["patch_size"]
    grid = (config["img_size"] // p) ** 2
    fan_patch = c * kt * p * p
    out = [
        ("patch_embed.proj.weight", (e, c, kt, p, p), "uniform", 1 / math.sqrt(fan_patch)),
        ("patch_embed.proj.bias", (e,), "uniform", 1 / math.sqrt(fan_patch)),
        ("cls_token", (1, 1, e), "normal", 0.02),
        ("pos_embed", (1, grid + 1, e), "normal", 0.02),
        ("temporal_pos_embedding", (1, config["num_frames"] // kt, e), "normal", 0.02),
    ]
    d = mixer_dims(config)
    di, n, w = d["d_inner"], d["d_state"], d["width"]
    out_bound = 1 / math.sqrt(di) / math.sqrt(depth)
    for i in range(depth):
        m = f"layers.{i}.mixer."
        out.append((f"layers.{i}.norm.weight", (e,), "jitter", 0.1))
        if d["kind"] == "Mamba2":
            h, g = d["nheads"], d["ngroups"]
            cd = di + 2 * g * n
            out += [
                (m + "in_proj.weight", (2 * di + 2 * g * n + h, e), "normal", 0.02),
                (m + "conv1d.weight", (cd, 1, w), "uniform", 1 / math.sqrt(w)),
                (m + "conv1d.bias", (cd,), "uniform", 1 / math.sqrt(w)),
                (m + "dt_bias", (h,), "dt_bias", 0.0),
                (m + "A_log", (h,), "a_log", 0.0),
                (m + "D", (h,), "jitter", 0.1),
                (m + "norm.weight", (di,), "jitter", 0.1),
                (m + "out_proj.weight", (e, di), "uniform", out_bound),
            ]
        else:
            r = d["dt_rank"]
            out += [
                (m + "in_proj.weight", (2 * di, e), "normal", 0.02),
                (m + "conv1d.weight", (di, 1, w), "uniform", 1 / math.sqrt(w)),
                (m + "conv1d.bias", (di,), "uniform", 1 / math.sqrt(w)),
                (m + "x_proj.weight", (r + 2 * n, di), "normal", 0.02),
                (m + "dt_proj.weight", (di, r), "normal", 0.02),
                (m + "dt_proj.bias", (di,), "dt_bias", 0.0),
                (m + "A_log", (di, n), "s4d", 0.1),
                (m + "D", (di,), "jitter", 0.1),
                (m + "out_proj.weight", (e, di), "uniform", out_bound),
            ]
    out += [
        ("norm.weight", (e,), "jitter", 0.1),
        ("pool_norm.weight", (e,), "jitter", 0.1),
        ("pool_norm.bias", (e,), "normal", 0.02),
    ]
    return out


def count(config: dict) -> int:
    """The number of parameters."""
    return sum(math.prod(shape) for _, shape, _, _ in spec(config))


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights for ``seed``, fp32 on ``device``, by name."""
    leaves = spec(config)
    n_uniform = sum(math.prod(s) for _, s, k, _ in leaves if k in _UNIFORM_KINDS)
    n_normal = sum(math.prod(s) for _, s, k, _ in leaves if k not in _UNIFORM_KINDS)
    g = torch_generator(seed, "weights", device)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    out, i_n, i_u = {}, 0, 0
    for name, shape, kind, arg in leaves:
        size = math.prod(shape)
        if kind in _UNIFORM_KINDS:
            u = uniform[i_u:i_u + size].view(shape)
            i_u += size
            if kind == "uniform":
                t = (2 * u - 1) * arg
            elif kind == "dt_bias":
                dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
                dt = dt.clamp(min=DT_FLOOR)
                t = dt + torch.log(-torch.expm1(-dt))
            else:
                lo, hi = A_INIT_RANGE
                t = torch.log(u * (hi - lo) + lo)
        else:
            z = normal[i_n:i_n + size].view(shape)
            i_n += size
            if kind == "normal":
                t = z * arg
            elif kind == "jitter":
                t = 1 + z * arg
            else:  # s4d
                t = torch.log(torch.arange(1, shape[-1] + 1, device=device, dtype=torch.float32)
                              ) + z * arg
        out[name] = t.contiguous()
    return out
