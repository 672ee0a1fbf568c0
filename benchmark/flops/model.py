"""Operations of a VideoMamba model step, for the whole step's share of the
card's peak (the ``step_mfu_pct`` metrics).

A forward counts 2 x tokens x the weight elements of every product (the
patch embedding over every patch token; in_proj, x_proj, dt_proj and
out_proj, or a Mamba-2 layer's in_proj and out_proj, over the tokens the
Blocks run) plus the sequence mix's own counts (``kernels.scan_flops`` and
the conv for Mamba-1, the chunked SSD products of ``kernels.ssd_flops`` for
Mamba-2). A training step counts three forwards. Norms, the pool and the
optimizer are not counted.
"""

from __future__ import annotations

from benchmark.flops import kernels


def mixer_dims(config: dict) -> dict:
    """The sizes of one Block's mixer from a configuration file's keys."""
    ssm = config["ssm_cfg"]
    e = config["embed_dim"]
    di = ssm.get("expand", 2) * e
    dims = dict(embed=e, d_inner=di, d_state=ssm["d_state"], width=ssm.get("d_conv", 4))
    if ssm.get("layer", "Mamba") == "Mamba2":
        p = ssm["headdim"]
        dims.update(kind="Mamba2", nheads=di // p, hdim=p, ngroups=ssm.get("ngroups", 1),
                    chunk=ssm["chunk_size"])
    else:
        dims.update(kind="Mamba", dt_rank=ssm["dt_rank"])
    return dims


def block_forward_flops_per_token(config: dict) -> float:
    """One Block's forward operations per token through it."""
    d = mixer_dims(config)
    e, di, n, w = d["embed"], d["d_inner"], d["d_state"], d["width"]
    if d["kind"] == "Mamba2":
        h, p, g, q = d["nheads"], d["hdim"], d["ngroups"], d["chunk"]
        cd = di + 2 * g * n
        weights = e * (2 * di + 2 * g * n + h) + di * e
        mix = q * (g * n + h * p) + 4 * h * p * n + 2 * w * cd
        return 2 * weights + mix
    r = d["dt_rank"]
    weights = e * 2 * di + di * (r + 2 * n) + r * di + di * e
    mix = kernels.scan_flops(1, 1, di, n)["fp32"] + 2 * w * di
    return 2 * weights + mix


def patch_flops_per_token(config: dict) -> float:
    """The patch embedding's operations per patch token."""
    patch = config["channels"] * config["tubelet_size"] * config["patch_size"] ** 2
    return 2 * patch * config["embed_dim"]


def forward_flops(config: dict, block_tokens: int, patch_tokens: int) -> float:
    """A forward's operations: ``block_tokens`` tokens through every Block
    (CLS included where it runs), ``patch_tokens`` patches embedded."""
    return (config["depth"] * block_tokens * block_forward_flops_per_token(config)
            + patch_tokens * patch_flops_per_token(config))


def train_step_flops(config: dict, block_tokens: int, patch_tokens: int) -> float:
    """A training step's operations: three forwards."""
    return 3 * forward_flops(config, block_tokens, patch_tokens)
