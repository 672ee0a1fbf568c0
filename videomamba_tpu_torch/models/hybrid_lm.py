"""A causal language model of Mamba-2 and attention layers, each with an MLP.

IBM Granite-4.0-H (``model_type`` ``granitemoehybrid``, no experts), built
from a dict with the keys of its published ``config.json``:

* ``h = E[ids] * embedding_multiplier`` (E: ``vocab_size`` x ``hidden_size``);
* ``num_hidden_layers`` Blocks, ``layer_types[i]`` "mamba" (a ``Mamba2``
  mixer: ``mamba_n_heads`` x ``mamba_d_head``, ``mamba_d_state``,
  ``mamba_n_groups``, ``mamba_d_conv``, ``mamba_chunk_size``) or
  "attention" (GQA: ``num_attention_heads`` over ``num_key_value_heads``,
  scores scaled by ``attention_multiplier``, no positional encoding); each
  Block ``h = h + m * mixer(RMSNorm(h))``, ``h = h + m * mlp(RMSNorm(h))``
  with ``m`` = ``residual_multiplier`` and the gated MLP of width
  ``shared_intermediate_size`` (models/block.py, models/mlp.py);
* a final RMSNorm and the head tied to the embedding, divided by
  ``logits_scaling``; only the last position's logits are computed.

The residual stream is fp32 and the add + norms are K2, as in the video
models. Streaming (``runtime.StreamingSession``): :meth:`allocate_state`
gives each Mamba-2 layer its ``(conv_state, ssm_state)`` and each attention
layer a ``streaming.KVCache`` of ``max_len`` positions; a chunk of ids
advances the position by its length.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from videomamba_tpu_torch.models import initializers as init
from videomamba_tpu_torch.models.block import Norm, create_block
from videomamba_tpu_torch.models.mamba import skip_init
from videomamba_tpu_torch.ops.norm import fused_add_norm
from videomamba_tpu_torch.runtime import resolve_device
from videomamba_tpu_torch.streaming import KVCache
from videomamba_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

LAYER_KINDS = ("mamba", "attention")


def _check_config(cfg: Dict[str, Any]) -> None:
    """Refuse what this model does not build, by the published keys."""
    unsupported = {
        "num_local_experts": lambda v: v not in (0, None),
        "position_embedding_type": lambda v: v not in ("nope", None),
        "attention_bias": bool,
        "tie_word_embeddings": lambda v: v is False,
        "hidden_act": lambda v: v not in ("silu", None),
        "normalization_function": lambda v: v not in ("rmsnorm", None),
    }
    bad = [k for k, refuse in unsupported.items() if k in cfg and refuse(cfg[k])]
    if bad:
        raise ValueError(f"HybridMambaLM builds no experts, no positional encoding, no "
                         f"attention bias, a tied head, SiLU and RMSNorm; refused: "
                         f"{', '.join(f'{k}={cfg[k]!r}' for k in bad)}")
    kinds = list(cfg["layer_types"])
    if len(kinds) != cfg["num_hidden_layers"] or set(kinds) - set(LAYER_KINDS):
        raise ValueError(f"layer_types must list {cfg['num_hidden_layers']} of "
                         f"{LAYER_KINDS}, got {kinds}")
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] != cfg["mamba_expand"] * cfg["hidden_size"]:
        raise ValueError("mamba_n_heads x mamba_d_head must equal mamba_expand x hidden_size")


class HybridMambaLM(nn.Module):
    """Token ids (B, L) -> the last position's logits (B, vocab) fp32.

    Parameters are drawn from ``generator`` (default: seed 0): products
    and the embedding N(0, 0.02) truncated at 2 (the Mamba-2 mixers keep
    their own init), on ``device`` (default: the card)."""

    def __init__(self, config: Dict[str, Any], device=None, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(config)
        self.config = dict(config)
        cfg = self.config
        device = resolve_device(device)
        g = torch.Generator().manual_seed(0) if generator is None else generator
        d = cfg["hidden_size"]
        self.embedding_multiplier = float(cfg["embedding_multiplier"])
        self.logits_scaling = float(cfg["logits_scaling"])
        self.norm_epsilon = float(cfg["rms_norm_eps"])
        self.embed_tokens = skip_init(nn.Embedding, cfg["vocab_size"], d, device=device,
                                      dtype=dtype)
        with torch.no_grad():
            self.embed_tokens.weight.copy_(init.trunc_normal((cfg["vocab_size"], d), g))
        mamba = dict(layer="Mamba2", d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
                     expand=cfg["mamba_expand"], headdim=cfg["mamba_d_head"],
                     ngroups=cfg["mamba_n_groups"], chunk_size=cfg["mamba_chunk_size"],
                     conv_bias=cfg["mamba_conv_bias"], bias=cfg["mamba_proj_bias"],
                     norm_epsilon=self.norm_epsilon)
        attn = dict(layer="attention", n_heads=cfg["num_attention_heads"],
                    n_kv_heads=cfg["num_key_value_heads"],
                    head_dim=cfg.get("head_dim") or d // cfg["num_attention_heads"],
                    scale=cfg["attention_multiplier"])
        width = cfg.get("shared_intermediate_size") or cfg["intermediate_size"]
        self.layers = nn.ModuleList(
            create_block(d, mamba if kind == "mamba" else attn, norm_epsilon=self.norm_epsilon,
                         layer_idx=i, device=device, dtype=dtype, generator=g,
                         mlp_cfg={"hidden_features": width},
                         residual_multiplier=cfg["residual_multiplier"])
            for i, kind in enumerate(cfg["layer_types"]))
        self.norm = Norm(d, bias=False, device=device)

    @property
    def attention_layers(self) -> List[int]:
        return [i for i, kind in enumerate(self.config["layer_types"]) if kind == "attention"]

    def allocate_state(self, batch_size: int, dtype=None, device=None, as_dict: bool = False,
                       max_len: Optional[int] = None):
        """Per-layer zero streaming state: ``(conv_state, ssm_state)`` (conv
        in ``dtype``, default fp32; SSM fp32) for a Mamba-2 layer, an empty
        ``KVCache`` of ``max_len`` positions in the model's dtype for an
        attention layer."""
        if max_len is None and self.attention_layers:
            raise ValueError("a model with attention layers needs max_len, the KV caches' "
                             "length in positions")
        states = [
            layer.mixer.allocate_state(batch_size, max_len, device=device)
            if kind == "attention"
            else layer.mixer.allocate_state(batch_size, dtype=dtype, device=device)
            for layer, kind in zip(self.layers, self.config["layer_types"])
        ]
        return dict(enumerate(states)) if as_dict else states

    def position_advance(self, ids: Tensor) -> int:
        """Positions a chunk of ids (B, L) advances the stream: L."""
        return ids.shape[1]

    def stream_forward(self, ids: Tensor, state, offset: int, mask=None,
                       keep_temporal: bool = False):
        """One streaming chunk (``runtime.StreamingSession``): (logits, new state)."""
        if mask is not None or keep_temporal:
            raise ValueError("a language model takes neither mask nor keep_temporal")
        return self(ids, ssm_state=state, position_offset=offset)

    def forward(self, ids: Tensor, ssm_state=None, position_offset: int = 0):
        """ids (B, L) -> logits (B, vocab) fp32 of the last position; with
        ``ssm_state`` (the streaming state of the positions before, whose KV
        caches hold ``position_offset`` positions) also the new state."""
        if ids.dim() != 2 or ids.shape[1] == 0:
            raise ValueError(f"ids must be (B, L) with L >= 1, got {tuple(ids.shape)}")
        if ssm_state is not None:
            ssm_state = list(ssm_state.values()) if isinstance(ssm_state, dict) else ssm_state
            for i in self.attention_layers:
                if not isinstance(ssm_state[i], KVCache) or ssm_state[i].length != position_offset:
                    raise ValueError(f"layer {i}'s KV cache does not hold the "
                                     f"{position_offset} positions before this chunk")
        with annotate("vmt.model.embed"):
            hidden = F.embedding(ids, self.embed_tokens.weight) * self.embedding_multiplier
        residual, new_state = None, []
        with annotate("vmt.model.blocks"):
            for i, layer in enumerate(self.layers):
                if ssm_state is None:
                    hidden, residual = layer(hidden, residual)
                else:
                    hidden, residual, s = layer(hidden, residual, state=ssm_state[i],
                                                return_state=True)
                    new_state.append(s)
        with annotate("vmt.model.norm"):
            last = fused_add_norm(
                hidden[:, -1:].contiguous(), self.norm.weight, None,
                residual=residual[:, -1:].contiguous(), prenorm=False, residual_in_fp32=True,
                eps=self.norm_epsilon, norm_type="rms", use_kernel=True)
        with annotate("vmt.model.lm_head"):
            logits = (last[:, 0] @ self.embed_tokens.weight.t()).float() / self.logits_scaling
        return logits if ssm_state is None else (logits, new_state)
