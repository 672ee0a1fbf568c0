"""BiMambaRefinerBlock: bidirectionality composed outside the mixer (PyTorch port).

Port of videomamba_tpu/models/refiner.py: two independent unidirectional
Blocks (forward, and backward over the time-flipped tokens), a sigmoid
fusion gate over their concatenation, and an output projection. Only the
forward direction's state streams across chunks; the backward Block starts
every call from zeros (or the state the caller passes), as in the reference.
The Blocks take the routes every Block takes (models/block.py): at fp32
Base width K2 + K3 with the carried state, at bf16 the whole-block kernel
K4.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from videomamba_tpu_torch.models import initializers as init
from videomamba_tpu_torch.models.block import Block, create_block
from videomamba_tpu_torch.models.mamba import _linear
from videomamba_tpu_torch.runtime import resolve_device

Tensor = torch.Tensor
LayerState = Tuple[Tensor, Tensor]
PackedShape = Optional[Tuple[int, int, int]]


class BiMambaRefinerBlock(nn.Module):
    """Gated forward/backward fusion refiner over [B, L, C] or [B, T, N, C]
    tokens. ``block_kwargs`` go to :func:`create_block` for both Blocks
    (built with ``bimamba=False``); the backward Block's ``layer_idx`` is the
    forward one's plus 1 000 000 (a distinct cache namespace, as in the
    reference). Weights are drawn from ``generator`` (default: seed 0) on
    ``device`` (default: the card)."""

    def __init__(
        self,
        dim: int,
        ssm_cfg: Optional[Dict[str, object]] = None,
        device=None,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        **block_kwargs,
    ):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.dim = dim
        layer_idx = block_kwargs.pop("layer_idx", None)
        block_kwargs.pop("bimamba", None)
        common = dict(ssm_cfg=ssm_cfg, bimamba=False, device=device, dtype=dtype,
                      generator=g, **block_kwargs)
        self.block_fwd: Block = create_block(dim, layer_idx=layer_idx, **common)
        bwd_layer_idx = None if layer_idx is None else int(layer_idx) + 1_000_000
        self.block_bwd: Block = create_block(dim, layer_idx=bwd_layer_idx, **common)

        def lin(in_f, out_f):  # nn.Linear's default init, from the generator
            return _linear(in_f, out_f, init.kaiming_uniform((out_f, in_f), in_f, g),
                           init.default_bias((out_f,), in_f, g), device, dtype)

        self.fusion_gate = lin(2 * dim, dim)
        self.out_proj = lin(dim, dim)

    @staticmethod
    def _pack_tokens(x: Tensor) -> Tuple[Tensor, PackedShape]:
        if x.dim() == 3:
            return x, None
        if x.dim() == 4:
            b, t, n, c = x.shape
            return x.reshape(b, t * n, c), (b, t, n)
        raise ValueError("Expected x to be [B, L, C] or [B, T, N, C].")

    @staticmethod
    def _unpack_tokens(x: Tensor, packed_shape: PackedShape) -> Tensor:
        if packed_shape is None:
            return x
        b, t, n = packed_shape
        return x.reshape(b, t, n, x.shape[-1])

    @staticmethod
    def _flip_time(x: Tensor, packed_shape: PackedShape) -> Tensor:
        """Flip along time: the whole sequence of [B, L, C], the frame axis
        of packed [B, T, N, C] (tokens within a frame keep their order)."""
        if packed_shape is None:
            return torch.flip(x, dims=(1,))
        b, t, n = packed_shape
        return torch.flip(x.reshape(b, t, n, x.shape[-1]), dims=(1,)).reshape(
            b, t * n, x.shape[-1])

    def allocate_state(self, batch_size: int, dtype=None,
                       device=None) -> Tuple[LayerState, LayerState]:
        fwd = self.block_fwd.mixer.allocate_state(batch_size, dtype=dtype, device=device)
        bwd = self.block_bwd.mixer.allocate_state(batch_size, dtype=dtype, device=device)
        return fwd, bwd

    def forward(
        self,
        x: Tensor,
        state_fwd: Optional[LayerState] = None,
        state_bwd_init: Optional[LayerState] = None,
        use_checkpoint: bool = False,
    ) -> Tuple[Tensor, LayerState]:
        """Returns (refined tokens, streamed forward state). Missing states
        start as zeros at x's dtype. ``use_checkpoint`` runs both Blocks
        under ``torch.utils.checkpoint`` (non-reentrant): their activations
        are recomputed in the backward."""
        x_seq, packed_shape = self._pack_tokens(x)
        bsz = x_seq.shape[0]

        def run(block, xs, conv, ssm):
            return block(xs, state=(conv, ssm), return_state=True)

        def call(block, xs, st):
            if use_checkpoint and torch.is_grad_enabled():
                return _checkpoint(run, block, xs, *st, use_reentrant=False)
            return run(block, xs, *st)

        if state_fwd is None:
            state_fwd = self.block_fwd.mixer.allocate_state(bsz, dtype=x_seq.dtype)
        out_fwd, _, new_state_fwd = call(self.block_fwd, x_seq, tuple(state_fwd))

        if state_bwd_init is None:
            state_bwd_init = self.block_bwd.mixer.allocate_state(bsz, dtype=x_seq.dtype)
        x_rev = self._flip_time(x_seq, packed_shape)
        out_bwd_rev, _, _ = call(self.block_bwd, x_rev, tuple(state_bwd_init))
        out_bwd = self._flip_time(out_bwd_rev, packed_shape)

        gate = torch.sigmoid(self.fusion_gate(torch.cat([out_fwd, out_bwd], dim=-1)))
        out = self.out_proj(gate * out_fwd + (1.0 - gate) * out_bwd)
        return self._unpack_tokens(out, packed_shape), new_state_fwd
