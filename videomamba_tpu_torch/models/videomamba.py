"""PretrainVideoMamba — the video backbone, PyTorch port.

Port of videomamba_tpu/models/videomamba.py with the reference's parameter
names, so a reference state_dict loads strictly:

* Patch embedding is a reshape plus one matmul, exactly as in the JAX package
  (videomamba.py:103-118). The reference's Conv3d has kernel == stride, so
  this is the same function, and it keeps cuDNN's TF32 convolution off the
  fp32 path. ``patch_embed.proj`` holds the Conv3d-layout weight only.
* Positional embeddings are resolved per call: bicubic re-gridding when the
  spatial grid differs from the trained one, and linear temporal
  extrapolation past the trained horizon with the resample matrix built on
  the host (NumPy) and sliced to the chunk, as in the JAX package.
* Streaming state is threaded through the blocks; chunk 0 carries CLS,
  continuation chunks (``temporal_pos_offset > 0`` with full state) do not.

* Training (``model.train()``) runs every Block on the mixer route with
  per-layer stochastic-depth rates ``[0] + linspace(0, drop_path_rate,
  depth)`` and a final drop path before the last norm (JAX
  videomamba.py:185, 585-588). Masks are drawn from ``generator`` before
  the blocks run; ``use_checkpoint`` wraps the first ``checkpoint_num``
  blocks in ``torch.utils.checkpoint`` (non-reentrant), which recomputes
  them in the backward with the same masks.
* Masking (VideoMAE-style) is validated on the host and gathered on the
  device (JAX videomamba.py:441-538): the mask (True = hidden) must keep
  CLS visible and the same number of visible tokens in every sample, which
  gives the gather one shape; the visible positions are computed on the
  host and the tokens gathered after the CLS concat with
  ``torch.take_along_dim`` (unique positions per row, so its backward adds
  nothing twice). The Blocks then run on the visible tokens only, on the
  same kernels as an unmasked clip. The per-frame pool of a masked clip
  (``keep_temporal``) is a one-hot product in the tokens' dtype divided by
  host counts, deterministic (no atomic scatter).

Forward-return contract (streaming.py):
  add_pool_norm=True:  (x_vis, x_pool) | (x_vis, x_pool, next_state)
  add_pool_norm=False: x_vis | (x_vis, next_state)
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from videomamba_tpu_torch.checkpoint import load_checkpoint, load_state_dict, load_timm_npz
from videomamba_tpu_torch.models import initializers as init
from torch.utils.checkpoint import checkpoint as _checkpoint

from videomamba_tpu_torch.models.block import (
    Norm,
    create_block,
    drop_path,
    drop_path_mask,
)
from videomamba_tpu_torch.models.mamba import skip_init
from videomamba_tpu_torch.ops.norm import fused_add_norm, layer_norm
from videomamba_tpu_torch.ops.resample import (
    infer_spatial_grid,
    linear_resample_matrix,
    resample_bicubic_2d,
)
from videomamba_tpu_torch.runtime import resolve_device
from videomamba_tpu_torch.streaming import (
    STREAMING_CONTRACT_VERSION,
    ForwardReturnSemantics,
    StateShape,
    expected_state_shapes as contract_state_shapes,
    forward_return_semantics as get_forward_return_semantics,
)

logger = logging.getLogger(__name__)

Tensor = torch.Tensor
LayerState = Union[Tensor, Tuple[Tensor, Tensor]]
StateCollection = Union[List[LayerState], Tuple[LayerState, ...], Dict[int, LayerState]]


def _to_2tuple(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _host_mask(mask) -> Optional[np.ndarray]:
    """A token mask as a host NumPy array: an array as it is, a tensor (CPU
    or CUDA) copied to the host, once, as the JAX package's host-side
    ``np.asarray`` does."""
    if mask is None:
        return None
    if isinstance(mask, Tensor):
        return mask.detach().cpu().numpy()
    return np.asarray(mask)


def _checkpointed_block(layer: nn.Module, hidden: Tensor, residual, mask):
    """``layer`` under non-reentrant activation checkpointing, its parameters
    passed as explicit inputs: the recompute then sees the tensors this
    forward saw, also under ``torch.func.functional_call`` (the cast
    parameters of mixed-precision training), whose swap is undone before the
    backward recomputes."""
    names, values = zip(*layer.named_parameters())

    def run(h, r, m, *params):
        return torch.func.functional_call(
            layer, dict(zip(names, params)), (h,), {"residual": r, "drop_path_mask": m})

    return _checkpoint(run, hidden, residual, mask, *values, use_reentrant=False)


class PatchEmbed(nn.Module):
    """3D tubelet patchifier: (B, C, T, H, W) -> (B, T', H'*W', E)."""

    def __init__(
        self,
        img_size: Union[int, Tuple[int, int]] = 224,
        patch_size: Union[int, Tuple[int, int]] = 16,
        kernel_size: int = 1,
        in_chans: int = 3,
        embed_dim: int = 768,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.img_size = _to_2tuple(img_size)
        self.patch_size = _to_2tuple(patch_size)
        self.num_patches = (self.img_size[1] // self.patch_size[1]) * (
            self.img_size[0] // self.patch_size[0]
        )
        self.tubelet_size = int(kernel_size)
        self.in_chans = int(in_chans)
        self.embed_dim = int(embed_dim)
        # Holds the reference-layout (E, C, kt, p, p) weight and (E,) bias;
        # forward never runs the convolution.
        kt, (p1, p2) = self.tubelet_size, self.patch_size
        self.proj = skip_init(
            nn.Conv3d, in_chans, embed_dim, (kt, p1, p2), stride=(kt, p1, p2),
            device=device, dtype=dtype,
        )

    @property
    def patch_dim(self) -> int:
        return self.in_chans * self.tubelet_size * self.patch_size[0] * self.patch_size[1]

    def forward(self, x: Tensor) -> Tensor:
        """Each non-overlapping tubelet flattened in (c, kt, ph, pw) order —
        the flattened Conv3d weight's order — then one dense projection,
        accumulated in fp32 and rounded once to x's dtype, as the JAX
        package's bf16 product is (a bf16 cuBLAS product may reduce in
        bf16)."""
        bsz, c, t, h, w = x.shape
        kt = self.tubelet_size
        p1, p2 = self.patch_size
        gt, gh, gw = t // kt, h // p1, w // p2
        x = x.reshape(bsz, c, gt, kt, gh, p1, gw, p2)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)  # (B, gt, gh, gw, c, kt, p1, p2)
        x = x.reshape(bsz, gt, gh * gw, self.patch_dim)
        kernel = self.proj.weight.reshape(self.embed_dim, self.patch_dim)
        return (x.float() @ kernel.float().t()).to(x.dtype) + self.proj.bias


class PretrainVideoMamba(nn.Module):
    """VideoMamba encoder with streaming state, masking and pooling heads.

    ``forward`` mirrors the reference signature. Parameters are drawn from ``generator``
    (default: seed 0) with the reference's three init passes, on ``device``
    (default: the card, :func:`videomamba_tpu_torch.runtime.resolve_device`).
    """

    streaming_contract_version: str = STREAMING_CONTRACT_VERSION

    def __init__(
        self,
        img_size: Union[int, Tuple[int, int]] = 224,
        patch_size: int = 16,
        depth: int = 24,
        embed_dim: int = 192,
        channels: int = 3,
        drop_path_rate: float = 0.0,
        ssm_cfg: Optional[Dict[str, object]] = None,
        norm_epsilon: float = 1e-5,
        initializer_cfg: Optional[Dict[str, object]] = None,
        fused_add_norm: bool = True,
        rms_norm: bool = True,
        residual_in_fp32: bool = True,
        bimamba: bool = True,
        pool_type: str = "cls+avg",
        kernel_size: int = 1,
        num_frames: int = 8,
        device=None,
        dtype: Optional[torch.dtype] = None,
        use_checkpoint: bool = False,
        checkpoint_num: int = 0,
        add_pool_norm: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not bimamba:
            raise NotImplementedError("Only bimamba=True is supported.")
        del initializer_cfg
        device = resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.residual_in_fp32 = residual_in_fp32
        self.fused_add_norm = fused_add_norm
        self.depth = depth
        self.pool_type = pool_type
        self.d_model = self.num_features = self.embed_dim = embed_dim
        self.num_frames = num_frames
        self.norm_epsilon = norm_epsilon
        self.rms_norm = rms_norm
        self.drop_path_rate = drop_path_rate
        self.add_pool_norm = add_pool_norm
        self.use_checkpoint = use_checkpoint
        self.checkpoint_num = checkpoint_num

        self.patch_embed = PatchEmbed(
            img_size=img_size, patch_size=patch_size, kernel_size=kernel_size,
            in_chans=channels, embed_dim=embed_dim, device=device, dtype=dtype,
        )
        dpr = [float(x) for x in np.linspace(0, drop_path_rate, depth)]
        inter_dpr = [0.0] + dpr
        self.layers = nn.ModuleList(
            create_block(
                embed_dim, ssm_cfg=ssm_cfg, norm_epsilon=norm_epsilon,
                rms_norm=rms_norm, residual_in_fp32=residual_in_fp32,
                fused_add_norm=fused_add_norm, layer_idx=i, bimamba=bimamba,
                drop_path=inter_dpr[i], device=device, dtype=dtype, generator=g,
            )
            for i in range(depth)
        )
        tubelets = num_frames // self.patch_embed.tubelet_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device, dtype=dtype))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.patch_embed.num_patches + 1, embed_dim, device=device, dtype=dtype)
        )
        self.temporal_pos_embedding = nn.Parameter(
            torch.zeros(1, tubelets, embed_dim, device=device, dtype=dtype)
        )
        self.norm = Norm(embed_dim, bias=not rms_norm, device=device)
        if add_pool_norm:
            self.pool_norm = Norm(embed_dim, bias=True, device=device)
        self._init_weights(g)

    def no_weight_decay(self):
        """Parameter names kept out of weight decay (JAX videomamba.py:347)."""
        return {"pos_embed", "cls_token", "temporal_pos_embedding"}

    def _drop_path_masks(self, batch: int, generator, device) -> List[Optional[Tensor]]:
        """Per-layer masks, then the final norm's; None where no drop path
        runs (eval, a zero rate). Drawn in layer order from ``generator``."""
        if not self.training or self.drop_path_rate <= 0.0:
            return [None] * (self.depth + 1)
        rates = [layer.drop_path_rate for layer in self.layers] + [self.drop_path_rate]
        return [drop_path_mask(batch, r, generator, device) if r > 0.0 else None
                for r in rates]

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        """The reference's init passes (videomamba_tpu/models/videomamba.py:
        213-269): Conv3d default for the patch projection, trunc_normal(0.02)
        on pos_embed and on every mixer Linear weight with dt_proj.bias
        zeroed (segm_init), then out_proj kaiming-uniform / sqrt(depth);
        a Mamba-2 mixer's Linear weights are in_proj and out_proj (JAX
        videomamba.py:242-249)."""
        pe = self.patch_embed
        pe.proj.weight.copy_(
            init.kaiming_uniform(pe.proj.weight.shape, pe.patch_dim, g)
        )
        pe.proj.bias.copy_(init.default_bias(pe.proj.bias.shape, pe.patch_dim, g))
        self.pos_embed.copy_(init.trunc_normal(self.pos_embed.shape, g))
        for block in self.layers:
            mx = block.mixer
            mamba1 = hasattr(mx, "x_proj")
            for lin in (mx.in_proj, mx.x_proj, mx.dt_proj) if mamba1 else (mx.in_proj,):
                lin.weight.copy_(init.trunc_normal(lin.weight.shape, g))
            if mamba1:
                mx.dt_proj.bias.zero_()
            mx.out_proj.weight.copy_(
                init.kaiming_uniform(mx.out_proj.weight.shape, mx.d_inner, g)
                / np.sqrt(self.depth)
            )
            for lin in (mx.in_proj, mx.out_proj):
                if lin.bias is not None:
                    lin.bias.zero_()

    # -------------------------------------------------------- state handling

    def _get_layer_state(
        self, state: Optional[StateCollection], layer_idx: int
    ) -> Optional[LayerState]:
        if state is None:
            return None
        if isinstance(state, dict):
            return state.get(layer_idx)
        if isinstance(state, (list, tuple)):
            return state[layer_idx]
        raise TypeError("state must be a list, tuple, or dict indexed by layer id")

    def allocate_state(
        self, batch_size: int, dtype=None, device=None, as_dict: bool = False
    ) -> StateCollection:
        """Per-layer zero streaming state, on the model's device by default."""
        states = [
            layer.allocate_state(batch_size, dtype=dtype, device=device)
            for layer in self.layers
        ]
        return dict(enumerate(states)) if as_dict else states

    def init_state(self, batch_size: int, dtype=None, device=None, as_dict: bool = False):
        """Backward-compatible alias for :meth:`allocate_state`."""
        return self.allocate_state(batch_size, dtype=dtype, device=device, as_dict=as_dict)

    def allocate_inference_cache(self, batch_size: int, max_seqlen: int = 1, dtype=None,
                                 device=None, **kwargs) -> Dict[int, LayerState]:
        """Per-layer zero decode-cache states keyed by layer index (JAX
        videomamba.py:317-322), for an ``InferenceCache``."""
        del kwargs
        return {
            i: layer.allocate_inference_cache(batch_size, max_seqlen, dtype=dtype,
                                              device=device)
            for i, layer in enumerate(self.layers)
        }

    def init_ssm_state(
        self, batch_size: int, dtype=None, device=None, as_dict: bool = False
    ):
        """SSM-only per-layer states (no conv context carried)."""
        states = [
            layer.allocate_state(batch_size, dtype=dtype, device=device)[1]
            for layer in self.layers
        ]
        return dict(enumerate(states)) if as_dict else states

    def expected_state_shapes(self, batch_size: int) -> Dict[int, StateShape]:
        """Per-layer state shapes of the streaming contract."""
        return contract_state_shapes(self, batch_size)

    def forward_return_semantics(self) -> ForwardReturnSemantics:
        return get_forward_return_semantics(self.add_pool_norm)

    def get_num_layers(self) -> int:
        return len(self.layers)

    def load_pretrained(self, checkpoint_path: str, prefix: str = "") -> None:
        """Load the ViT subset of a timm ``.npz`` checkpoint
        (:func:`videomamba_tpu_torch.checkpoint.load_timm_npz`) into this
        model."""
        load_state_dict(self, load_timm_npz(checkpoint_path, self, prefix=prefix))

    # ----------------------------------------------- host-side shape helpers

    def _validate_temporal_length(self, frame_count: int) -> int:
        tubelet = self.patch_embed.tubelet_size
        if frame_count <= 0:
            raise ValueError("Input must contain at least one frame.")
        if frame_count % tubelet != 0:
            raise ValueError(
                f"Input frame count ({frame_count}) must be divisible by "
                f"tubelet size ({tubelet})."
            )
        return frame_count // tubelet

    def _spatial_token_grid(self, height: int, width: int) -> Tuple[int, int]:
        patch_h, patch_w = self.patch_embed.patch_size
        if height < patch_h or width < patch_w:
            raise ValueError(
                "Input spatial size must be at least one patch: "
                f"got ({height}, {width}) with patch size ({patch_h}, {patch_w})."
            )
        return height // patch_h, width // patch_w

    def _has_cls_token_for_forward(
        self, ssm_state: Optional[StateCollection], temporal_pos_offset: int
    ) -> bool:
        """CLS only in the first chunk of a full-state streaming run."""
        if ssm_state is None or temporal_pos_offset <= 0:
            return True
        layer_state = self._get_layer_state(ssm_state, 0)
        is_full_state = isinstance(layer_state, (list, tuple)) and len(layer_state) == 2
        return not is_full_state

    # ------------------------------------------- positional-embedding access

    def _get_spatial_pos_embedding(self, grid_h: int, grid_w: int, dtype) -> Tensor:
        """Patch positional embeddings for a runtime grid; bicubic re-grid when
        it differs from the trained grid."""
        patch_pos = self.pos_embed[:, 1:]
        base_h = self.patch_embed.img_size[0] // self.patch_embed.patch_size[0]
        base_w = self.patch_embed.img_size[1] // self.patch_embed.patch_size[1]
        if base_h * base_w != patch_pos.shape[1]:
            base_h, base_w = infer_spatial_grid(patch_pos.shape[1], (base_h, base_w))
        if (grid_h, grid_w) == (base_h, base_w):
            return patch_pos.to(dtype)
        pos = patch_pos.reshape(1, base_h, base_w, self.embed_dim)
        pos = resample_bicubic_2d(pos, (grid_h, grid_w))
        return pos.reshape(1, grid_h * grid_w, self.embed_dim).to(dtype)

    def _get_temporal_pos_embedding(self, seqlen: int, offset: int, dtype) -> Tensor:
        """Temporal pos-embed slice [offset, offset + seqlen), linearly
        extrapolated past the trained horizon: the embedding is resampled to
        length offset + seqlen and the chunk's rows are taken, so chunked and
        full runs differ past the horizon, as in the reference."""
        if offset < 0:
            raise ValueError("temporal_pos_offset must be non-negative.")
        pos_embed = self.temporal_pos_embedding
        pos_len = pos_embed.shape[1]
        end = offset + seqlen
        if end <= pos_len:
            return pos_embed[:, offset:end].to(dtype)
        m = torch.from_numpy(linear_resample_matrix(pos_len, end)[offset:end])
        pos = torch.einsum("ol,blc->boc", m.to(pos_embed.device), pos_embed.float())
        return pos.to(dtype)

    # --------------------------------------------------------------- masking

    def _normalize_mask(
        self,
        mask,
        batch_size: int,
        token_count: int,
        require_cls_visible: bool,
    ) -> Optional[np.ndarray]:
        """Host-side mask validation (JAX videomamba.py:441-467). True =
        masked."""
        if mask is None:
            return None
        mask = _host_mask(mask)
        if mask.ndim != 2:
            raise ValueError("mask must be 2D with shape [B, N].")
        if mask.shape[0] != batch_size:
            raise ValueError(
                f"mask batch size mismatch: expected {batch_size}, got {mask.shape[0]}."
            )
        mask = mask.astype(bool)
        if mask.shape[1] != token_count:
            raise ValueError(
                f"mask token length mismatch: expected {token_count}, got {mask.shape[1]}."
            )
        if require_cls_visible and token_count > 0 and bool(mask[:, 0].any()):
            raise ValueError(
                "mask must keep CLS token visible (mask[:, 0] must be False)."
            )
        return mask

    def _visible_token_positions(
        self,
        mask,
        batch_size: int,
        token_count: int,
        require_cls_visible: bool,
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """The normalized mask and each sample's visible positions in
        ascending order, on the host (JAX videomamba.py:469-499). Every
        sample must keep the same number of visible tokens."""
        normalized = self._normalize_mask(
            mask, batch_size, token_count, require_cls_visible
        )
        if normalized is None:
            return None, None
        visible_mask = ~normalized
        visible_counts = visible_mask.sum(axis=1)
        if visible_counts.size > 0 and not (visible_counts == visible_counts[0]).all():
            raise ValueError(
                "mask must keep the same number of visible tokens per sample; "
                f"got per-sample counts: {visible_counts.tolist()}."
            )
        if visible_counts.size > 0 and int(visible_counts[0]) <= 0:
            raise ValueError("mask must keep at least one visible token per sample.")
        positions = np.arange(token_count)[None, :].repeat(batch_size, axis=0)
        positions = np.where(visible_mask, positions, token_count)
        num_visible = int(visible_counts[0]) if visible_counts.size > 0 else 0
        visible_positions = np.sort(positions, axis=1)[:, :num_visible]
        return normalized, visible_positions

    # ------------------------------------------------------------- encoder

    def _encoder(
        self,
        x: Tensor,
        spatial_pos: Tensor,
        temporal_pos: Tensor,
        state: Optional[List[Optional[LayerState]]],
        has_cls: bool,
        generator: Optional[torch.Generator] = None,
        visible_positions: Optional[np.ndarray] = None,
    ) -> Tuple[Tensor, Optional[List[Optional[LayerState]]]]:
        """Patchify -> pos-add -> (CLS) -> (visible-token gather) -> depth x
        Block -> final norm."""
        compute_dtype = self.patch_embed.proj.weight.dtype
        tokens = self.patch_embed(x.to(compute_dtype))  # (B, T', HW, E)
        bsz = tokens.shape[0]
        tokens = tokens + spatial_pos.to(compute_dtype)[:, None]
        tokens = tokens + temporal_pos.to(compute_dtype)[:, :, None]
        tokens = tokens.reshape(bsz, -1, self.embed_dim)
        if has_cls:
            cls_tok = (self.cls_token + self.pos_embed[:, :1]).to(compute_dtype)
            tokens = torch.cat([cls_tok.expand(bsz, 1, self.embed_dim), tokens], dim=1)
        if visible_positions is not None:
            index = torch.from_numpy(visible_positions).to(tokens.device)
            tokens = torch.take_along_dim(tokens, index[:, :, None], dim=1)

        hidden_states, residual = tokens, None
        masks = self._drop_path_masks(bsz, generator, tokens.device)
        new_states = [None] * self.depth if state is not None else None
        for idx, layer in enumerate(self.layers):
            layer_state = self._get_layer_state(state, idx)
            mask = masks[idx]
            if isinstance(layer_state, (list, tuple)) and len(layer_state) == 2:
                hidden_states, residual, new_states[idx] = layer(
                    hidden_states, residual=residual, state=tuple(layer_state),
                    return_state=True, drop_path_mask=mask,
                )
            elif layer_state is not None:
                hidden_states, residual, new_states[idx] = layer(
                    hidden_states, residual=residual, ssm_state=layer_state,
                    return_ssm_state=True, drop_path_mask=mask,
                )
            elif (self.use_checkpoint and idx < self.checkpoint_num
                  and torch.is_grad_enabled()):
                hidden_states, residual = _checkpointed_block(
                    layer, hidden_states, residual, mask)
            else:
                hidden_states, residual = layer(
                    hidden_states, residual=residual, drop_path_mask=mask
                )

        if masks[-1] is not None:
            hidden_states = drop_path(hidden_states, masks[-1], self.drop_path_rate)
        hidden_states = fused_add_norm(
            hidden_states, self.norm.weight, self.norm.bias, residual=residual,
            prenorm=False, residual_in_fp32=self.residual_in_fp32,
            eps=self.norm_epsilon, norm_type="rms" if self.rms_norm else "layer",
            use_kernel=self.fused_add_norm,
        )
        return hidden_states, new_states

    # ---------------------------------------------------------------- public

    def forward_features(
        self,
        x: Tensor,
        mask=None,
        use_image: bool = False,
        ssm_state: Optional[StateCollection] = None,
        temporal_pos_offset: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        """Encoder features; returns (x_vis, next_state) when state is passed,
        in the container type that was passed (list, tuple or dict).
        ``generator`` draws the stochastic-depth masks in training.

        ``mask`` (True = hidden) is a NumPy array or a CPU or CUDA tensor of
        shape (B, [1 +] T'*H'*W'), the CLS slot first in a chunk that has
        CLS; a tensor is copied to the host once, where the mask is checked
        and the visible positions are computed. x_vis holds the visible
        tokens only."""
        del use_image
        if x.ndim != 5:
            raise ValueError("x must have shape [B, C, T, H, W].")
        t_tokens = self._validate_temporal_length(x.shape[2])
        grid_h, grid_w = self._spatial_token_grid(x.shape[-2], x.shape[-1])
        compute_dtype = self.patch_embed.proj.weight.dtype
        spatial_pos = self._get_spatial_pos_embedding(grid_h, grid_w, compute_dtype)
        temporal_pos = self._get_temporal_pos_embedding(
            t_tokens, temporal_pos_offset, compute_dtype
        )
        has_cls = self._has_cls_token_for_forward(ssm_state, temporal_pos_offset)
        token_count = t_tokens * grid_h * grid_w + (1 if has_cls else 0)
        _, visible_positions = self._visible_token_positions(
            mask, x.shape[0], token_count, require_cls_visible=has_cls
        )
        state_list, container, any_full = self._canonicalize_state(ssm_state)

        x_vis, new_states = self._encoder(
            x, spatial_pos, temporal_pos, state_list, has_cls, generator,
            visible_positions,
        )
        if new_states is not None:
            return x_vis, self._repack_state(
                new_states, container, allow_missing=not any_full
            )
        return x_vis

    def _canonicalize_state(self, ssm_state: Optional[StateCollection]):
        """State collection -> (list form, container tag, any_full_state)."""
        if ssm_state is None:
            return None, None, False
        if isinstance(ssm_state, dict):
            items = [ssm_state.get(i) for i in range(self.depth)]
            container = "dict"
        elif isinstance(ssm_state, (list, tuple)):
            items = list(ssm_state)
            container = "tuple" if isinstance(ssm_state, tuple) else "list"
        else:
            raise TypeError("state must be a list, tuple, or dict indexed by layer id")
        any_full = any(isinstance(s, (list, tuple)) and len(s) == 2 for s in items)
        return items, container, any_full

    def _repack_state(
        self, states: List[Optional[LayerState]], container: str,
        allow_missing: bool = False,
    ) -> StateCollection:
        """Rebuild the caller's container from per-layer advanced states.
        Layers of an ssm-only collection with no state ran stateless and stay
        absent; a full-state collection must cover every layer."""
        if not allow_missing and any(s is None for s in states):
            raise ValueError("Expected full state for all layers.")
        if container == "dict":
            return {i: s for i, s in enumerate(states) if s is not None}
        if container == "tuple":
            return tuple(states)
        return list(states)

    def forward(
        self,
        x: Tensor,
        mask=None,
        use_image: bool = False,
        keep_temporal: bool = False,
        ssm_state: Optional[StateCollection] = None,
        temporal_pos_offset: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        """Full forward with pooling head (reference videomamba.py:943-1067).
        ``generator`` draws the stochastic-depth masks in training; ``mask``
        as in :meth:`forward_features` (a tensor is copied to the host once
        here, for the features and the pool)."""
        mask = _host_mask(mask)
        if x.ndim != 5:
            raise ValueError("x must have shape [B, C, T, H, W].")
        grid_h, grid_w = self._spatial_token_grid(x.shape[-2], x.shape[-1])
        tokens_per_frame = grid_h * grid_w
        temporal_tokens = self._validate_temporal_length(x.shape[2])
        has_cls = self._has_cls_token_for_forward(ssm_state, temporal_pos_offset)

        features = self.forward_features(
            x, mask, use_image, ssm_state=ssm_state,
            temporal_pos_offset=temporal_pos_offset, generator=generator,
        )
        if ssm_state is None:
            x_vis, next_state = features, None
        else:
            x_vis, next_state = features

        if not self.add_pool_norm:
            return x_vis if ssm_state is None else (x_vis, next_state)

        cls_token = x_vis[:, :1] if has_cls else None
        patch_tokens = x_vis[:, 1:] if has_cls else x_vis
        if self.pool_type in {"cls", "cls+avg", "cls_cat_avg"} and cls_token is None:
            raise ValueError(
                f"pool_type='{self.pool_type}' requires a CLS token, but "
                "continuation streaming chunks (temporal_pos_offset > 0 with "
                "full state) do not include CLS. Use pool_type='avg' for "
                "chunked streaming."
            )
        if self.pool_type != "cls" and patch_tokens.shape[1] == 0:
            raise ValueError(
                "mask must keep at least one patch token visible when using "
                f"pool_type='{self.pool_type}'."
            )
        x_pool = self._pool(
            cls_token, patch_tokens, mask, keep_temporal, temporal_tokens,
            tokens_per_frame, has_cls, x.shape[0],
        )
        if ssm_state is None:
            return patch_tokens, x_pool
        return patch_tokens, x_pool, next_state

    def _pool(
        self,
        cls_token: Optional[Tensor],
        patch_tokens: Tensor,
        mask: Optional[np.ndarray],
        keep_temporal: bool,
        temporal_tokens: int,
        tokens_per_frame: int,
        has_cls: bool,
        batch_size: int,
    ) -> Tensor:
        """Pooling head with pool_norm (LayerNorm, eps 1e-5); a masked clip's
        per-frame means count only its visible tokens."""
        pn = self.pool_norm

        def pool_norm(v: Tensor) -> Tensor:
            return layer_norm(v, pn.weight, pn.bias, eps=1e-5)

        if self.pool_type == "cls":
            return pool_norm(cls_token)
        if keep_temporal and mask is None:
            bsz, _, c = patch_tokens.shape
            temporal_avg = patch_tokens.reshape(
                bsz, temporal_tokens, tokens_per_frame, c
            ).mean(dim=2)
        elif keep_temporal:
            full_token_count = (1 if has_cls else 0) + temporal_tokens * tokens_per_frame
            _, visible_positions = self._visible_token_positions(
                mask, batch_size, full_token_count, require_cls_visible=has_cls
            )
            temporal_avg = self._masked_temporal_average(
                patch_tokens, visible_positions, temporal_tokens, tokens_per_frame, has_cls
            )
        else:
            temporal_avg = patch_tokens.mean(dim=1, keepdim=True)
        if self.pool_type == "cls+avg":
            return pool_norm(cls_token + temporal_avg)
        if self.pool_type == "cls_cat_avg":
            return pool_norm(torch.cat([cls_token, temporal_avg], dim=1))
        if self.pool_type == "avg":
            return pool_norm(temporal_avg)
        raise ValueError(f"Unsupported pool_type: {self.pool_type}")

    def _masked_temporal_average(
        self,
        patch_tokens: Tensor,
        visible_positions: np.ndarray,
        temporal_tokens: int,
        tokens_per_frame: int,
        has_cls: bool,
    ) -> Tensor:
        """Per-frame mean of the visible patch tokens under any mask (JAX
        videomamba.py:856-903): a one-hot (B, Nvis, T') product in the
        tokens' dtype, divided by the per-frame counts taken on the host."""
        if patch_tokens.dim() != 3:
            raise ValueError("patch_tokens must have shape [B, N, C].")
        if visible_positions.ndim != 2:
            raise ValueError("visible_positions must have shape [B, N_total_visible].")
        if patch_tokens.shape[0] != visible_positions.shape[0]:
            raise ValueError(
                "Batch size mismatch between patch_tokens and visible_positions."
            )
        expected = patch_tokens.shape[1] + (1 if has_cls else 0)
        if visible_positions.shape[1] != expected:
            raise ValueError(
                "visible_positions and patch_tokens lengths are inconsistent."
            )
        if has_cls and visible_positions.size > 0 and not (
            visible_positions[:, 0] == 0
        ).all():
            raise ValueError("mask must keep CLS token visible for temporal pooling.")

        patch_positions = visible_positions[:, 1:] - 1 if has_cls else visible_positions
        frame_indices = patch_positions // tokens_per_frame
        counts = np.zeros((patch_tokens.shape[0], temporal_tokens), np.int64)
        for b in range(frame_indices.shape[0]):
            counts[b] = np.bincount(frame_indices[b], minlength=temporal_tokens)
        if (counts == 0).any():
            raise ValueError(
                "keep_temporal with masking requires at least one visible patch "
                "token for each temporal slice."
            )
        device, dtype = patch_tokens.device, patch_tokens.dtype
        one_hot = torch.nn.functional.one_hot(
            torch.from_numpy(frame_indices).to(device), temporal_tokens
        ).to(dtype)  # (B, Nvis, T')
        temporal_sum = torch.einsum("bvt,bvc->btc", one_hot, patch_tokens)
        return temporal_sum / torch.from_numpy(counts).to(device=device, dtype=dtype)[:, :, None]


def build_videomamba(config, add_pool_norm: bool = True, device=None,
                     dtype: Optional[torch.dtype] = None,
                     generator: Optional[torch.Generator] = None) -> PretrainVideoMamba:
    """Build the model from a config namespace (videomamba_tpu/models/
    videomamba.py:906-947). ``config.vision_encoder.channels`` is required.
    With ``vision_encoder.pretrained`` set, the ``.pt`` file it names is
    loaded strictly by :func:`videomamba_tpu_torch.checkpoint.load_checkpoint`
    (pos-embed re-grid, temporal resample from ``ckpt_num_frame``)."""
    vision_cfg = config.vision_encoder
    channels = vision_cfg.channels
    model = PretrainVideoMamba(
        img_size=vision_cfg.img_size,
        patch_size=vision_cfg.patch_size,
        depth=vision_cfg.depth,
        embed_dim=vision_cfg.embed_dim,
        channels=channels,
        drop_path_rate=vision_cfg.drop_path_rate,
        ssm_cfg=vision_cfg.ssm_cfg,
        norm_epsilon=vision_cfg.norm_epsilon,
        fused_add_norm=vision_cfg.fused_add_norm,
        rms_norm=vision_cfg.rms_norm,
        residual_in_fp32=vision_cfg.residual_in_fp32,
        bimamba=vision_cfg.bimamba,
        pool_type=vision_cfg.pool_type,
        kernel_size=vision_cfg.kernel_size,
        num_frames=vision_cfg.num_frames,
        use_checkpoint=vision_cfg.use_checkpoint,
        checkpoint_num=vision_cfg.checkpoint_num,
        add_pool_norm=add_pool_norm,
        device=device,
        dtype=dtype,
        generator=generator,
    )
    pretrained_path = getattr(vision_cfg, "pretrained", None)
    if pretrained_path is not None:
        load_checkpoint(
            pretrained_path=pretrained_path,
            model=model,
            ckpt_num_frame=vision_cfg.ckpt_num_frame,
            num_frames=vision_cfg.num_frames,
        )
    else:
        logger.info("No pretrained weights!!!")
    return model
