"""Grouped-query attention mixer with a KV cache carried across chunks.

The attention layers of a hybrid Mamba-2 / attention language model
(IBM Granite-4.0-H, ``GraniteMoeHybridAttention``): bias-free ``q_proj``,
``k_proj``, ``v_proj`` and ``o_proj``, ``n_heads`` query heads over
``n_kv_heads`` key and value heads of ``head_dim``, scores scaled by
``scale`` (the configuration's ``attention_multiplier``, not 1 /
sqrt(head_dim)) and no positional encoding. A chunk's queries attend
causally over the cache and the chunk (ops/kernels/attention.py).

Streaming contract (``streaming.KVCache``): a chunk writes its keys and
values into the preallocated cache at the filled length, in place, and
returns the entry with the new length; a chunk that would pass the cache's
end raises. Without a state the layer attends within the chunk alone.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from videomamba_tpu_torch.models import initializers as init
from videomamba_tpu_torch.models.mamba import _linear
from videomamba_tpu_torch.ops.kernels.attention import attention
from videomamba_tpu_torch.runtime import resolve_device
from videomamba_tpu_torch.streaming import KVCache
from videomamba_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor


class Attention(nn.Module):
    """Causal GQA mixer over a carried KV cache. Projections are drawn
    N(0, 0.02) (truncated at 2) from ``generator`` (default: seed 0)."""

    supports_block_fusion = False  # a Block runs add + norm, then this mixer

    def __init__(
        self,
        d_model: int,
        n_heads: int,
        n_kv_heads: int,
        head_dim: Optional[int] = None,
        scale: Optional[float] = None,
        layer_idx: Optional[int] = None,
        device=None,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        head_dim = d_model // n_heads if head_dim is None else head_dim
        if n_kv_heads <= 0 or n_heads % n_kv_heads:
            raise ValueError(f"n_heads={n_heads} must be a multiple of n_kv_heads={n_kv_heads}")
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.scale = head_dim ** -0.5 if scale is None else float(scale)
        self.layer_idx = layer_idx
        device = resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        g = torch.Generator().manual_seed(0) if generator is None else generator

        def lin(in_f, out_f):
            w = init.trunc_normal((out_f, in_f), g)
            return _linear(in_f, out_f, w, None, device, dtype)

        self.q_proj = lin(d_model, n_heads * head_dim)
        self.k_proj = lin(d_model, n_kv_heads * head_dim)
        self.v_proj = lin(d_model, n_kv_heads * head_dim)
        self.o_proj = lin(n_heads * head_dim, d_model)

    def _heads(self, x: Tensor, proj: nn.Linear, heads: int) -> Tensor:
        """(B, L, d_model) -> (B, heads, L, head_dim)."""
        b, L = x.shape[:2]
        return (x @ proj.weight.t()).view(b, L, heads, self.head_dim).transpose(1, 2)

    def forward(self, hidden_states: Tensor, state: Optional[KVCache] = None,
                return_state: bool = False):
        """(B, L, d_model) -> out, or (out, the new KVCache) with
        ``return_state``. With ``state`` the chunk's keys and values are
        written into its buffers at ``state.length`` and the queries attend
        over the filled cache."""
        if return_state and state is None:
            raise ValueError("return_state needs a KVCache state to carry.")
        with annotate("vmt.model.attention"):
            b, L = hidden_states.shape[:2]
            q = self._heads(hidden_states, self.q_proj, self.n_heads)
            k = self._heads(hidden_states, self.k_proj, self.n_kv_heads)
            v = self._heads(hidden_states, self.v_proj, self.n_kv_heads)
            if state is not None:
                end = state.length + L
                if end > state.key.shape[2]:
                    raise ValueError(
                        f"attention layer {self.layer_idx}: {state.length} cached positions "
                        f"and a chunk of {L} pass the cache's max_len {state.key.shape[2]}")
                state.key[:, :, state.length:end] = k
                state.value[:, :, state.length:end] = v
                k, v = state.key[:, :, :end], state.value[:, :, :end]
                state = state._replace(length=end)
            y = attention(q, k, v, self.scale)
            out = y.transpose(1, 2).reshape(b, L, self.n_heads * self.head_dim)
            out = out @ self.o_proj.weight.t()
        return (out, state) if return_state else out

    def kv_state_shape(self, batch_size: int, max_len: int):
        """The KV cache's buffer shape (read by streaming.expected_state_shapes)."""
        return (batch_size, self.n_kv_heads, max_len, self.head_dim)

    def allocate_state(self, batch_size: int, max_len: int, device=None) -> KVCache:
        """An empty cache of ``max_len`` positions in the projections' dtype
        (bf16 for a bf16 model)."""
        w = self.k_proj.weight
        device = w.device if device is None else device
        shape = self.kv_state_shape(batch_size, max_len)
        return KVCache(torch.zeros(shape, dtype=w.dtype, device=device),
                       torch.zeros(shape, dtype=w.dtype, device=device), 0)
