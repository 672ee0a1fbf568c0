"""Operations and bytes of the hybrid language model's serving calls, for
``step_mfu_pct.prefill`` and ``attention_roofline``.

A call runs ``chunk_tokens`` new tokens of each of ``batch`` rows over
caches that hold ``position`` tokens before it. It counts 2 x tokens x the
weight elements of every product (each Mamba-2 layer's in_proj and
out_proj, each attention layer's q, k, v and o projections, every Block's
MLP) and the head at the last position of each row (2 x vocab x hidden);
the SSD's chunk products (``kernels.ssd_flops``' own: the causal half of
C B^T and of m x, the chunk states and the inter-chunk readout); and the
attention's QK^T and PV over the keys each query sees (the cache and the
chunk, causal). Norms, the conv, the gate and the softmax are not counted.
"""

from __future__ import annotations


def dims(config: dict) -> dict:
    d = config["hidden_size"]
    hq = config["num_attention_heads"]
    kinds = config["layer_types"]
    return dict(
        hidden=d, vocab=config["vocab_size"],
        mlp=config.get("shared_intermediate_size") or config["intermediate_size"],
        n_mamba=kinds.count("mamba"), n_attention=kinds.count("attention"),
        heads=config["mamba_n_heads"], head_dim=config["mamba_d_head"],
        groups=config["mamba_n_groups"], state=config["mamba_d_state"],
        chunk=config["mamba_chunk_size"], q_heads=hq,
        kv_heads=config["num_key_value_heads"], attn_dim=config.get("head_dim") or d // hq)


def product_flops_per_token(config: dict) -> float:
    """Every layer's products, per token through the stack."""
    x = dims(config)
    d, di = x["hidden"], x["heads"] * x["head_dim"]
    gn = x["groups"] * x["state"]
    mamba = d * (2 * di + 2 * gn + x["heads"]) + di * d
    attention = 2 * d * x["attn_dim"] * (x["q_heads"] + x["kv_heads"])
    mlp = 3 * d * x["mlp"]
    return 2.0 * (x["n_mamba"] * mamba + x["n_attention"] * attention
                  + (x["n_mamba"] + x["n_attention"]) * mlp)


def ssd_flops_per_token(config: dict) -> float:
    """Every Mamba-2 layer's chunk products, per token."""
    x = dims(config)
    h, p, n = x["heads"], x["head_dim"], x["state"]
    return x["n_mamba"] * (x["chunk"] * (x["groups"] * n + h * p) + 4 * h * p * n)


def attention_keys(chunk_tokens: int, position: int) -> int:
    """Query-key pairs of one row and head: each of the chunk's queries
    over the ``position`` cached keys and the chunk's keys up to its own."""
    return chunk_tokens * position + chunk_tokens * (chunk_tokens + 1) // 2


def attention_flops(config: dict, batch: int, chunk_tokens: int, position: int) -> float:
    """One attention layer's QK^T and PV in one call."""
    x = dims(config)
    return 4.0 * batch * x["q_heads"] * x["attn_dim"] * attention_keys(chunk_tokens, position)


def attention_bytes(config: dict, batch: int, chunk_tokens: int, position: int,
                    elem: int = 2) -> int:
    """One attention layer's call: Q read and O written, the cache's keys
    and values read once (``position`` + ``chunk_tokens`` of each)."""
    x = dims(config)
    q_o = 2 * batch * x["q_heads"] * chunk_tokens * x["attn_dim"]
    kv = 2 * batch * x["kv_heads"] * (position + chunk_tokens) * x["attn_dim"]
    return elem * (q_o + kv)


def call_flops(config: dict, batch: int, chunk_tokens: int, position: int) -> float:
    """A serving call's operations."""
    x = dims(config)
    tokens = batch * chunk_tokens
    return (tokens * (product_flops_per_token(config) + ssd_flops_per_token(config))
            + x["n_attention"] * attention_flops(config, batch, chunk_tokens, position)
            + 2.0 * batch * x["vocab"] * x["hidden"])
