"""Prenorm residual Block: Add -> Norm -> Mixer [-> Add -> Norm -> MLP] (PyTorch port).

Port of videomamba_tpu/models/block.py: the block adds the incoming hidden
states (after stochastic depth in training) to the running residual,
normalizes, runs the mixer, and returns the mixer output with the post-add
residual. A Block of a hybrid language model (``create_block(mlp_cfg=...)``,
mamba_ssm 2's ``Block(mlp_cls=...)``) also carries a second sublayer: the
mixer output is added to the residual and normalized again (``norm2``, K2
where ``fused_add_norm``), and the Block returns the MLP's output with that
residual; each sublayer's output is scaled by ``residual_multiplier``
(Granite-4.0-H's 0.22) before it enters the residual, a multiply on the
branch output (the published form; no weight is folded). The mixer is a
``Mamba``, a ``Mamba2`` or an ``Attention`` (models/attention.py) layer.
Two routes, chosen as the JAX package chooses them
(block.py:274-280, 318-342):

* whole block (K4, ops/kernels/block_fused.py) in eval mode when the Block
  and its mixer are on their fast paths with the reference's biases and the
  JAX package's byte rule admits the widths: every published size at bf16,
  and Tiny/Small/Middle at fp32; in training only under
  ``VIDEOMAMBA_BLOCK_BWD=fused`` (the JAX package's opt-in). When autograd
  records the call it runs as :class:`BlockFusedFn` (the JAX package's
  ``_block_fused``, block.py:82-205): K4 with checkpoints forward, K7
  (ops/kernels/block_bwd.py) backward, or under
  ``VIDEOMAMBA_BLOCK_BWD=composite`` autograd of a plain recompute whose
  scan is K1 / K5;
* otherwise add + norm (K2 when ``fused_add_norm``) then the mixer (K3, or K1
  on its unfused branch): fp32 Base, either flag off, every default training
  call (the JAX package's ``deterministic=False``), whose backward is K6 (or
  K5) and autograd of the norm (or K8), and every decode-cache call
  (``inference_params``).

Stochastic depth takes its mask from the caller (:func:`drop_path_mask`),
drawn before the block runs, so a block recomputed under activation
checkpointing sees the same mask; it applies to ``hidden`` before either
route.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from videomamba_tpu_torch.models.attention import Attention
from videomamba_tpu_torch.models.mamba import InferenceCache, LayerState, Mamba
from videomamba_tpu_torch.models.mamba2 import Mamba2
from videomamba_tpu_torch.models.mlp import GatedMLP
from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d, conv_window
from videomamba_tpu_torch.ops.kernels.block_bwd import block_bwd
from videomamba_tpu_torch.ops.kernels.block_fused import block_fused, block_fused_supported
from videomamba_tpu_torch.ops.kernels.mixer_fused import project
from videomamba_tpu_torch.ops.norm import fused_add_norm, layer_norm, rms_norm
from videomamba_tpu_torch.ops.selective_scan import selective_scan_bld
from videomamba_tpu_torch.runtime import resolve_device

Tensor = torch.Tensor


def drop_path_mask(batch: int, rate: float, generator: Optional[torch.Generator] = None,
                   device=None) -> Tensor:
    """A (batch, 1, 1) stochastic-depth mask: 1 where a sample is kept
    (probability 1 - rate), else 0, drawn on the CPU from ``generator`` (the
    default generator when None) and moved to ``device``."""
    keep = torch.full((batch, 1, 1), 1.0 - rate)
    return torch.bernoulli(keep, generator=generator).to(device)


def drop_path(x: Tensor, mask: Tensor, rate: float) -> Tensor:
    """Stochastic depth with timm semantics (scale_by_keep), as the JAX
    package's drop_path (block.py:208-216): x * mask / (1 - rate)."""
    return x * (mask.to(x.dtype) / (1.0 - rate))


def _block_recompute(hidden, residual, norm_w, norm_b, in_proj_w, out_proj_w, conv_w,
                     conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, h0, conv_state,
                     norm_type, eps, residual_fp32):
    """The whole Block in plain torch with K4's rounding points (JAX
    block.py:33-79), its scan through K1 / K5 (``SelectiveScanFn``): the
    composite backward differentiates this. Each product's input is rounded
    to the weight dtype (a no-op at fp32) and summed in fp32, the JAX
    recompute's ``jnp.dot(..., preferred_element_type=float32)``; z stays
    fp32 here, as in the JAX recompute."""
    res_out = hidden.float() + residual.float()
    normed = (rms_norm(res_out, norm_w, eps=eps) if norm_type == "rms"
              else layer_norm(res_out, norm_w, norm_b, eps=eps))
    xz = project(normed, in_proj_w)
    di = in_proj_w.shape[0] // 2
    x, z = xz[..., :di], xz[..., di:]
    conv_out = causal_conv1d(x, conv_w.t(), conv_b, activation="silu",
                             initial_state=conv_state)
    r, n = dt_proj_w.shape[1], A.shape[1]
    xdbl = project(conv_out, x_proj_w)
    delta_raw = project(xdbl[..., :r], dt_proj_w)
    y, h_last = selective_scan_bld(
        conv_out, delta_raw, A, xdbl[..., r:r + n], xdbl[..., r + n:], D=D, z=z,
        delta_bias=dt_bias, delta_softplus=True, initial_state=h0,
        return_last_state=True, method="kernel",
    )
    out = project(y, out_proj_w)
    res_dtype = torch.float32 if residual_fp32 else hidden.dtype
    return out.to(hidden.dtype), res_out.to(res_dtype), h_last


class BlockFusedFn(torch.autograd.Function):
    """K4 forward with segment checkpoints; K7 (or composite) backward.

    The backward linearises at ``res_out = f32(hidden) + f32(residual)``,
    recomputed in fp32 whatever ``residual_fp32`` says (JAX block.py:
    154-159), and fans its cotangent out to hidden and residual."""

    @staticmethod
    def forward(ctx, hidden, residual, norm_w, norm_b, in_proj_w, out_proj_w, conv_w,
                conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, h0, conv_state, norm_type,
                eps, residual_fp32):
        out, res_out, h_last, ckpt = block_fused(
            hidden, residual, norm_w, norm_b, in_proj_w, out_proj_w, conv_w, conv_b,
            x_proj_w, dt_proj_w, dt_bias, A, D, h0, conv_state, norm_type=norm_type,
            eps=eps, residual_fp32=residual_fp32, checkpoints=True,
        )
        ctx.save_for_backward(hidden, residual, norm_w, norm_b, in_proj_w, out_proj_w,
                              conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, h0,
                              conv_state, ckpt)
        ctx.cfg = (norm_type, eps, residual_fp32)
        return out, res_out, h_last

    @staticmethod
    def backward(ctx, g_out, g_res, g_hlast):
        *args, ckpt = ctx.saved_tensors
        (hidden, residual, norm_w, norm_b, in_proj_w, out_proj_w, conv_w, conv_b,
         x_proj_w, dt_proj_w, dt_bias, A, D, h0, conv_state) = args
        norm_type, eps, residual_fp32 = ctx.cfg
        none3 = (None, None, None)
        if dispatch.block_bwd_backend() == "fused":
            res_out = hidden.float() + residual.float()
            (dres, dnorm_w, dnorm_b, *weights, dh0, dconv_state) = block_bwd(
                res_out, norm_w, norm_b, in_proj_w, out_proj_w, conv_w, conv_b,
                x_proj_w, dt_proj_w, dt_bias, A, D, conv_state, ckpt, g_out, g_res,
                g_hlast, norm_type=norm_type, eps=eps,
            )
            return (dres.to(hidden.dtype), dres.to(residual.dtype), dnorm_w,
                    dnorm_b if norm_b is not None else None, *weights,
                    dh0.to(h0.dtype), dconv_state) + none3
        live = [a.detach().requires_grad_() if a is not None else None for a in args]
        with torch.enable_grad():
            outs = _block_recompute(*live, norm_type, eps, residual_fp32)
        present = [a for a in live if a is not None]
        grads = iter(torch.autograd.grad(outs, present, (g_out, g_res, g_hlast),
                                         allow_unused=True))
        return tuple(next(grads) if a is not None else None for a in live) + none3


class Norm(nn.Module):
    """fp32 ``weight`` (and ``bias`` for LayerNorm) of an RMS/LayerNorm."""

    def __init__(self, dim: int, bias: bool, device=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(dim, device=device))
        else:
            self.register_parameter("bias", None)


class Block(nn.Module):
    """Add -> Norm -> mixer, and with ``mlp`` Add -> Norm -> MLP, with
    carried residual and streaming state."""

    def __init__(
        self,
        dim: int,
        mixer: nn.Module,
        norm_type: str = "layer",
        norm_epsilon: float = 1e-5,
        fused_add_norm: bool = False,
        residual_in_fp32: bool = False,
        drop_path_rate: float = 0.0,
        layer_idx: Optional[int] = None,
        device=None,
        mlp: Optional[nn.Module] = None,
        residual_multiplier: float = 1.0,
    ):
        super().__init__()
        if norm_type not in ("layer", "rms"):
            raise ValueError(f"Unknown norm_type: {norm_type!r}")
        self.dim = dim
        self.mixer = mixer
        self.norm = Norm(dim, bias=norm_type == "layer", device=device)
        self.mlp = mlp
        if mlp is not None:
            self.norm2 = Norm(dim, bias=norm_type == "layer", device=device)
        self.residual_multiplier = float(residual_multiplier)
        self.norm_type = norm_type
        self.norm_epsilon = norm_epsilon
        self.fused_add_norm = fused_add_norm
        self.residual_in_fp32 = residual_in_fp32
        self.drop_path_rate = drop_path_rate
        self.layer_idx = layer_idx

    def forward(
        self,
        hidden_states: Tensor,
        residual: Optional[Tensor] = None,
        state: Optional[LayerState] = None,
        return_state: bool = False,
        ssm_state: Optional[Tensor] = None,
        return_ssm_state: bool = False,
        drop_path_mask: Optional[Tensor] = None,
        inference_params: Optional[InferenceCache] = None,
    ):
        """Returns (hidden, residual), or (hidden, residual, new_state) with
        ``return_state`` / ``return_ssm_state``. In training with
        ``drop_path_rate > 0`` and a residual, ``drop_path_mask`` (from
        :func:`drop_path_mask`) drops whole samples of the incoming hidden
        states; the first block, which has no residual, is never dropped.
        ``inference_params`` (the decode cache) goes to the mixer, which
        updates it in place; it bypasses the whole-block route."""
        if state is not None and ssm_state is not None:
            raise ValueError("Pass either state or ssm_state, not both.")
        if return_ssm_state and ssm_state is None:
            raise ValueError("return_ssm_state requires ssm_state.")
        if self.training and self.drop_path_rate > 0.0 and residual is not None:
            if drop_path_mask is None:
                raise ValueError(
                    "drop_path with rate > 0 in training mode needs a drop_path_mask."
                )
            hidden_states = drop_path(hidden_states, drop_path_mask, self.drop_path_rate)
        if inference_params is None and self._use_block_fused() and (
                not self.training or dispatch.block_bwd_mode() == "fused"):
            return self._call_block_fused(
                hidden_states, residual, state, return_state, ssm_state,
                return_ssm_state,
            )
        normed, new_residual = fused_add_norm(
            hidden_states, self.norm.weight, self.norm.bias, residual=residual,
            prenorm=True, residual_in_fp32=self.residual_in_fp32,
            eps=self.norm_epsilon, norm_type=self.norm_type,
            use_kernel=self.fused_add_norm,
        )
        if state is not None:
            mixer_out = self.mixer(normed, state=state, return_state=return_state)
        elif ssm_state is None and inference_params is None:
            mixer_out = self.mixer(normed)
        else:
            mixer_out = self.mixer(
                normed, ssm_state=ssm_state, return_ssm_state=return_ssm_state,
                inference_params=inference_params,
            )
        if (return_state and state is not None) or return_ssm_state:
            hidden, new_state = mixer_out
            return (*self._second_sublayer(hidden, new_residual), new_state)
        return self._second_sublayer(mixer_out, new_residual)

    def _second_sublayer(self, mixer_out: Tensor, residual: Tensor):
        """The mixer output scaled by ``residual_multiplier``, and with an MLP
        the add + norm (K2 where ``fused_add_norm``) and the MLP's scaled
        output: (hidden, residual) as the Block returns them."""
        m = self.residual_multiplier
        if m != 1.0:
            mixer_out = mixer_out * m
        if self.mlp is None:
            return mixer_out, residual
        normed, residual = fused_add_norm(
            mixer_out, self.norm2.weight, self.norm2.bias, residual=residual,
            prenorm=True, residual_in_fp32=self.residual_in_fp32,
            eps=self.norm_epsilon, norm_type=self.norm_type,
            use_kernel=self.fused_add_norm,
        )
        out = self.mlp(normed)
        return (out * m if m != 1.0 else out), residual

    def _use_block_fused(self) -> bool:
        """The JAX package's whole-block gate (block.py:318-342): fused norm,
        the mixer's fast path, no in_proj/out_proj bias, a conv bias, and the
        byte rule of :func:`block_fused_supported` at 4 bytes a weight for
        fp32 and 2 for bf16. The rule is the TPU kernel's VMEM budget, ported
        to keep both packages on one route, not a limit of this card. A
        Mamba-2 mixer never takes it, nor a sequence-parallel mixer (JAX
        block.py:325: its route owns the mixer call) or a mixer split over
        tensor-parallel ranks (K4 sums x_proj over every channel). (The JAX
        gate's scan-backend condition has no counterpart here: the port's
        fast path is its kernels.)"""
        mx = self.mixer
        if self.mlp is not None or self.residual_multiplier != 1.0:
            return False  # K4 is the Block with nothing after its mixer
        if not getattr(mx, "supports_block_fusion", True):
            return False  # Mamba2, Attention: add + norm, then their own kernels
        if not (self.fused_add_norm and mx.use_fast_path):
            return False
        if mx.sp_axis is not None or mx.tp_group is not None:
            return False
        if (mx.in_proj.bias is not None or mx.out_proj.bias is not None
                or mx.conv1d.bias is None):
            return False
        wbytes = 4 if mx.in_proj.weight.dtype == torch.float32 else 2
        return block_fused_supported(
            self.dim, mx.d_inner, mx.dt_rank, mx.d_state, weight_bytes_per_el=wbytes
        )

    def block_fused_weights(self) -> Dict[str, object]:
        """The Block's weights and settings as K4 (and its plain version)
        take them, after hidden, residual, h0 and conv_state."""
        mx = self.mixer
        return dict(
            norm_w=self.norm.weight, norm_b=self.norm.bias,
            in_proj_w=mx.in_proj.weight, out_proj_w=mx.out_proj.weight,
            conv_w=mx.conv1d.weight.squeeze(1), conv_b=mx.conv1d.bias,
            x_proj_w=mx.x_proj.weight, dt_proj_w=mx.dt_proj.weight,
            dt_bias=mx.dt_proj.bias.float(), A=-torch.exp(mx.A_log.float()),
            D=mx.D.float(), norm_type=self.norm_type, eps=self.norm_epsilon,
            residual_fp32=self.residual_in_fp32,
        )

    def _call_block_fused(self, hidden_states, residual, state, return_state,
                          ssm_state, return_ssm_state):
        """The whole-block route (JAX block.py:344-404): missing residual,
        conv window and SSM state start as zeros (fp32, hidden dtype, fp32);
        new states take the incoming states' dtypes. Through
        :class:`BlockFusedFn` when autograd records the call (any input or
        weight requires grad), else the bare K4 call, as the mixer guards
        K3."""
        mx = self.mixer
        bsz = hidden_states.shape[0]
        conv_state = None
        if state is not None:
            conv_state, ssm_state = state
        h0 = (
            ssm_state.float()
            if ssm_state is not None
            else hidden_states.new_zeros((bsz, mx.d_inner, mx.d_state), dtype=torch.float32)
        )
        cstate_in = (
            conv_state
            if conv_state is not None
            else hidden_states.new_zeros((bsz, mx.d_inner, mx.d_conv))
        )
        res_in = (
            residual
            if residual is not None
            else torch.zeros_like(hidden_states, dtype=torch.float32)
        )
        w = self.block_fused_weights()
        args = (hidden_states, res_in, w["norm_w"], w["norm_b"], w["in_proj_w"],
                w["out_proj_w"], w["conv_w"], w["conv_b"], w["x_proj_w"], w["dt_proj_w"],
                w["dt_bias"], w["A"], w["D"], h0, cstate_in)
        cfg = (w["norm_type"], w["eps"], w["residual_fp32"])
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
            out, res_out, h_last = BlockFusedFn.apply(*args, *cfg)
        else:
            out, res_out, h_last = block_fused(
                *args, norm_type=cfg[0], eps=cfg[1], residual_fp32=cfg[2])
        if return_ssm_state:
            return out, res_out, h_last.to(ssm_state.dtype)
        if state is None or not return_state:
            return out, res_out
        new_conv = self._tail_conv_window(res_out, conv_state)
        if conv_state is not None:
            new_conv = new_conv.to(conv_state.dtype)
        return out, res_out, (new_conv, h_last.to(ssm_state.dtype))

    def _tail_conv_window(self, res_out: Tensor, conv_state: Optional[Tensor]) -> Tensor:
        """New conv window (JAX block.py:406-427): K4 never writes the conv
        input x, so it is recomputed for the last W positions from res_out
        (norm, then the x half of in_proj with the kernel's rounding)."""
        mx = self.mixer
        w = mx.d_conv
        tail = res_out[:, -w:].float()
        if self.norm_type == "rms":
            normed = rms_norm(tail, self.norm.weight, eps=self.norm_epsilon)
        else:
            normed = layer_norm(tail, self.norm.weight, self.norm.bias,
                                eps=self.norm_epsilon)
        win = mx.in_proj.weight[:mx.d_inner]
        x_tail = normed.to(win.dtype).float() @ win.float().t()
        return conv_window(x_tail, conv_state, w)

    def allocate_state(self, batch_size: int, dtype=None, device=None) -> LayerState:
        return self.mixer.allocate_state(batch_size, dtype=dtype, device=device)

    def allocate_inference_cache(self, batch_size: int, max_seqlen: int = 1, dtype=None,
                                 device=None) -> LayerState:
        return self.mixer.allocate_inference_cache(batch_size, max_seqlen, dtype=dtype,
                                                   device=device)


def create_block(
    d_model: int,
    ssm_cfg: Optional[Dict[str, object]] = None,
    norm_epsilon: float = 1e-5,
    drop_path: float = 0.0,
    rms_norm: bool = True,
    residual_in_fp32: bool = True,
    fused_add_norm: bool = True,
    layer_idx: Optional[int] = None,
    bimamba: bool = True,
    device=None,
    dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
    mlp_cfg: Optional[Dict[str, object]] = None,
    residual_multiplier: float = 1.0,
) -> Block:
    """Block factory (videomamba_tpu/models/block.py:436-476). The inner
    mixer is unidirectional; ``ssm_cfg={"layer": "Mamba2", ...}`` selects the
    SSD mixer (models/mamba2.py), ``{"layer": "attention", "n_heads": ...,
    "n_kv_heads": ..., "head_dim": ..., "scale": ...}`` the GQA mixer
    (models/attention.py). ``mlp_cfg={"hidden_features": ...}`` adds the
    gated MLP sublayer (models/mlp.py) with its own norm;
    ``residual_multiplier`` scales both sublayers' outputs."""
    del bimamba
    ssm_cfg = dict(ssm_cfg or {})
    ssm_cfg.pop("bimamba", None)
    layer_kind = str(ssm_cfg.pop("layer", "Mamba"))
    mixers = {"Mamba": Mamba, "Mamba2": Mamba2, "attention": Attention}
    if layer_kind not in mixers:
        raise ValueError(f"unknown ssm_cfg layer {layer_kind!r}: create_block builds "
                         f"{', '.join(repr(k) for k in mixers)}")
    mixer = mixers[layer_kind](d_model=d_model, layer_idx=layer_idx, device=device,
                               dtype=dtype, generator=generator, **ssm_cfg)
    mlp = (GatedMLP(d_model, device=device, dtype=dtype, generator=generator, **mlp_cfg)
           if mlp_cfg else None)
    return Block(
        dim=d_model,
        mixer=mixer,
        norm_type="rms" if rms_norm else "layer",
        norm_epsilon=norm_epsilon,
        fused_add_norm=fused_add_norm,
        residual_in_fp32=residual_in_fp32,
        drop_path_rate=drop_path,
        layer_idx=layer_idx,
        device=device,
        mlp=mlp,
        residual_multiplier=residual_multiplier,
    )
