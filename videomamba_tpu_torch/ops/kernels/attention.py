"""Causal grouped-query attention of a chunk over a KV cache, on the card.

The hybrid language model's attention layers (``models/attention.py``) run
a chunk of L queries over the S >= L keys and values of their cache, the
chunk's own last: query i sees keys 0 .. S - L + i (the causal mask aligned
bottom-right), with n_heads query heads over n_kv_heads key and value heads
(each key head serves n_heads / n_kv_heads query heads) and the scale the
configuration gives.

On the card this is PyTorch's FlashAttention-2 kernel: ``scaled_dot_product_
attention`` with ``enable_gqa=True`` and ``torch.nn.attention.bias.
causal_lower_right(L, S)``, which hands that mask to the flash kernel as its
own causal mode (bottom-right when L < S), under ``sdpa_kernel`` held to the
flash backend, so the keys are never repeated across heads, no (L, S) mask
is built, and a call the flash kernel does not take raises instead of
falling back to a materialised mask. Each call sits in the
``vmt.kernel.attention`` range, so a trace finds what it launched, and
counts in ``attention.launches``. On the CPU the plain version below runs:
fp32 scores, the mask built, the keys repeated.
"""

from __future__ import annotations

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: q (B, H, L, D), k and v (B, Hkv, S, D) alike; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    (b, h, L, d), (bk, hk, S, dk) = q.shape, k.shape
    if b != bk or d != dk or hk == 0 or h % hk or S < L:
        raise ValueError(f"attention: q {tuple(q.shape)} against k {tuple(k.shape)}: batch "
                         f"and head dim must agree, the query heads be a multiple of the "
                         f"key heads and S >= L")


def attention_plain(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """The kernel's function in plain PyTorch, fp32: q (B, H, L, D), k and v
    (B, Hkv, S, D). Returns (B, H, L, D) in q's dtype."""
    _check(q, k, v)
    L, S = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = (q.float() @ kf.transpose(-1, -2)) * scale
    keep = torch.ones((L, S), dtype=torch.bool, device=q.device).tril(S - L)
    scores = scores.masked_fill(~keep, float("-inf"))
    return (torch.softmax(scores, dim=-1) @ vf).to(q.dtype)


def attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """Kernel wrapper with the contract of :func:`attention_plain`. On the
    card q, k and v are bf16 (or fp16) with unit-stride rows; k and v may
    be views into a longer cache."""
    if dispatch.runs_plain(q):
        return attention_plain(q, k, v, scale)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right

    _check(q, k, v)
    mask = causal_lower_right(q.shape[2], k.shape[2])
    with annotate("vmt.kernel.attention"), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)
    attention.launches += 1
    return out


attention.launches = 0
