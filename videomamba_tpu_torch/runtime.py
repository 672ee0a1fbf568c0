"""Serving runtime: stateful sessions over the chunk forward and token decode.

Port of videomamba_tpu/runtime.py. ``StreamingSession`` carries per-layer
(conv_state, ssm_state) and the temporal offset across chunk calls; each
batch row is an independent video stream. ``DecodeSession`` advances the
whole layer stack one token at a time (K9 for Mamba-1, K15 for Mamba-2).
:func:`resolve_device` is the port's one rule for a device that the caller
did not name; :func:`time_fn` times a call on the host.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch


def resolve_device(device=None) -> torch.device:
    """The device to build on: ``device`` when given, else the CUDA card.

    The port runs on the card unless the caller asks for the CPU; without a
    card, ``device=None`` raises instead of building on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; pass device=\"cpu\" to build on the CPU"
        )
    return torch.device("cuda")


class StreamingSession:
    """Carries per-layer (conv_state, ssm_state) across chunk calls.

    Example:
        session = StreamingSession(model, batch_size=4)
        for chunk in video_chunks:         # (B, C, Tc, H, W) each
            x_vis, x_pool = session.process(chunk)

    CLS appears in chunk 0 only, so pooled outputs need ``pool_type='avg'``
    from chunk 1 on. Reset rows with :meth:`reset` when their streams end.
    States are fp32 unless ``dtype`` says otherwise, at a bf16 model too.
    """

    def __init__(
        self,
        model,
        batch_size: int,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        self.model = model
        self.batch_size = batch_size
        self.state = model.allocate_state(batch_size, dtype=dtype, device=device)
        self.offset = 0  # temporal tokens (post-tubelet)

    @torch.no_grad()
    def process(self, chunk: torch.Tensor, mask=None, keep_temporal: bool = False):
        """Run one chunk; returns the model's forward outputs minus the state,
        which the session keeps."""
        out = self.model(
            chunk,
            mask=mask,
            keep_temporal=keep_temporal,
            ssm_state=self.state,
            temporal_pos_offset=self.offset,
        )
        *outputs, self.state = out
        self.offset += chunk.shape[2] // self.model.patch_embed.tubelet_size
        return tuple(outputs) if len(outputs) > 1 else outputs[0]

    def reset(self, rows: Optional[List[int]] = None) -> None:
        """Zero the carried state (all rows and the offset, or given rows).
        Zeroes in place: the session owns its state tensors."""
        if rows is None:
            conv, _ = self.state[0]
            self.state = self.model.allocate_state(
                self.batch_size, dtype=conv.dtype, device=conv.device
            )
            self.offset = 0
            return
        idx = torch.as_tensor(rows, dtype=torch.long)
        for conv, ssm in self.state:
            conv[idx.to(conv.device)] = 0
            ssm[idx.to(ssm.device)] = 0


class DecodeSession:
    """Token-level decode through the whole layer stack (JAX runtime.py:79-372).

    Works on token embeddings (B, d_model): embed video patches upstream
    (e.g. with a streaming prefill and :meth:`load_streaming_state`) and feed
    tokens one at a time; :meth:`step` returns the final-norm features.

    ``use_kernel=None`` takes the whole-stack decode kernel when it takes the
    model (bias-free projections, RMS or LayerNorm, its width gate; any
    batch size): K9 (ops/kernels/decode_step.py ``decode_stack``) for a
    Mamba-1 model, K15 (``decode_stack_m2``: one B/C group, d_inner a
    multiple of 128) for a Mamba-2 one. On the card the kernel, on the CPU
    its plain version, by the dispatch rule; the final norm goes through K2.
    A model outside that gate runs every layer through its mixer's ``step``
    (plain torch), as the JAX package falls back to its XLA route. ``True``
    raises on such a model; ``False`` always takes the per-layer route. The
    layer weights are stacked once here; the states are the streaming
    contract's stacked on depth, (depth, B, d_inner, d_conv) and (depth, B,
    d_inner, d_state) for Mamba-1, (depth, B, conv_dim, d_conv) and (depth,
    B, nheads, headdim, d_state) fp32 for Mamba-2; the conv window (and the
    Mamba-1 state) is fp32 unless ``dtype`` says otherwise. The kernel route
    advances them in place.
    """

    def __init__(self, model, batch_size: int, dtype: Optional[torch.dtype] = None,
                 use_kernel: Optional[bool] = None):
        from videomamba_tpu_torch.models.mamba2 import Mamba2

        self.model = model
        self.batch_size = batch_size
        block = model.layers[0]
        self.mixer = block.mixer
        self.is_m2 = isinstance(self.mixer, Mamba2)
        self.norm_type = block.norm_type
        self.eps = block.norm_epsilon
        self.residual_in_fp32 = block.residual_in_fp32
        conv, ssm = self.mixer.allocate_state(batch_size, dtype=dtype)
        depth = len(model.layers)
        self.conv_states = conv.expand((depth,) + tuple(conv.shape)).contiguous()
        self.ssm_states = ssm.expand((depth,) + tuple(ssm.shape)).contiguous()
        self.use_kernel = self._kernel_ok(use_kernel)
        self.stacked = self._stack_weights() if self.use_kernel else None
        self.kernel_kw = dict(norm_type=self.norm_type, eps=self.eps)
        if self.is_m2:
            self.kernel_kw.update(ngroups=self.mixer.ngroups, gate_eps=self.mixer.norm_epsilon)
        self.launch = None
        self._prepare()

    def _prepare(self) -> None:
        """On the card, validate the stacked weights and the states, plan the
        kernel and allocate its buffers once (here, after a batch change in
        :meth:`load_streaming_state`); :meth:`step` then submits each token
        through the unchecked launch."""
        from videomamba_tpu_torch.ops import dispatch
        from videomamba_tpu_torch.ops.kernels.decode_step import (
            prepare_decode_stack,
            prepare_decode_stack_m2,
        )

        self.launch = None
        if not self.use_kernel or dispatch.runs_plain(self.ssm_states):
            return
        prepare = prepare_decode_stack_m2 if self.is_m2 else prepare_decode_stack
        self.launch = prepare(self.batch_size, self.ssm_states.device, **self.stacked,
                              conv_states=self.conv_states, ssm_states=self.ssm_states,
                              **self.kernel_kw)
        # The stacks the kernel advances (views of its padded storage where
        # d_inner is not a multiple of 8).
        self.conv_states, self.ssm_states = self.launch.states

    def _kernel_ok(self, use_kernel: Optional[bool]) -> bool:
        """The decode kernel's eligibility (JAX runtime.py:128-168), forced
        or automatic."""
        from videomamba_tpu_torch.ops.kernels.decode_step import (
            decode_stack_m2_supported,
            decode_stack_supported,
        )

        if use_kernel is False:
            return False
        mx = self.mixer
        if self.is_m2:
            widths = decode_stack_m2_supported(mx.d_model, mx.d_inner, mx.nheads, mx.ngroups,
                                               mx.d_state)
        else:
            widths = decode_stack_supported(mx.d_model, mx.d_inner, mx.dt_rank, mx.d_state)
        compatible = (
            mx.in_proj.bias is None and mx.out_proj.bias is None
            and self.norm_type in ("rms", "layer") and widths
        )
        if use_kernel and not compatible:
            raise ValueError(
                "use_kernel=True but the decode kernel does not support this model "
                "(needs bias-free projections, rms/layer norm, a schedule that fits "
                "shared memory, and for Mamba-2 one B/C group and d_inner a multiple of "
                "128)."
            )
        return compatible

    def _stack_weights(self) -> dict:
        """The layers' weights stacked on depth in the kernel's layouts, once."""
        layers = self.model.layers
        mixers = [layer.mixer for layer in layers]

        def stack(fn):
            return torch.stack([fn(m) for m in mixers]).contiguous()

        with torch.no_grad():
            norm_b = (torch.stack([layer.norm.bias.float() for layer in layers])
                      if self.norm_type == "layer" else None)
            common = dict(
                norm_w=torch.stack([layer.norm.weight.float() for layer in layers]),
                norm_b=norm_b,
                in_proj_w=stack(lambda m: m.in_proj.weight),
                out_proj_w=stack(lambda m: m.out_proj.weight),
                conv_w=stack(lambda m: m.conv1d.weight.squeeze(1)),
                conv_b=stack(lambda m: m.conv1d.bias.float() if m.conv1d.bias is not None
                             else torch.zeros(m.conv1d.weight.shape[0], device=m.A_log.device)),
                A=stack(lambda m: -torch.exp(m.A_log.float())),
                D=stack(lambda m: m.D.float()),
            )
            if self.is_m2:
                return dict(
                    common, dt_bias=stack(lambda m: m.dt_bias.float()),
                    gate_w=stack(lambda m: m.norm.weight.float()) if self.mixer.rmsnorm
                    else None)
            return dict(
                common,
                x_proj_w=stack(lambda m: m.x_proj.weight),
                dt_proj_w=stack(lambda m: m.dt_proj.weight),
                dt_bias=stack(lambda m: m.dt_proj.bias.float()),
            )

    @torch.no_grad()
    def step(self, token: torch.Tensor) -> torch.Tensor:
        """Advance one token (B, d_model); returns (B, d_model) final-norm
        features."""
        from videomamba_tpu_torch.ops.kernels.decode_step import decode_stack, decode_stack_m2
        from videomamba_tpu_torch.ops.norm import fused_add_norm

        model = self.model
        if self.launch is not None:
            if tuple(token.shape) != (self.batch_size, model.embed_dim):
                raise ValueError(f"DecodeSession.step: token has shape {tuple(token.shape)}, "
                                 f"expected ({self.batch_size}, {model.embed_dim})")
            hidden, residual = self.launch.run(token)
        elif self.use_kernel:  # the kernel's plain version, on the CPU
            kernel = decode_stack_m2 if self.is_m2 else decode_stack
            hidden, residual, self.conv_states, self.ssm_states = kernel(
                token, **self.stacked, conv_states=self.conv_states,
                ssm_states=self.ssm_states, **self.kernel_kw)
        if self.use_kernel:
            return fused_add_norm(
                hidden.to(self.conv_states.dtype), model.norm.weight, model.norm.bias,
                residual=residual, prenorm=False, residual_in_fp32=self.residual_in_fp32,
                eps=self.eps, norm_type=self.norm_type, use_kernel=True)
        hidden = token[:, None, :]
        residual = torch.zeros_like(
            hidden, dtype=torch.float32 if self.residual_in_fp32 else hidden.dtype)
        convs, ssms = [], []
        for k, layer in enumerate(model.layers):
            normed, residual = fused_add_norm(
                hidden, layer.norm.weight, layer.norm.bias, residual=residual, prenorm=True,
                residual_in_fp32=self.residual_in_fp32, eps=self.eps,
                norm_type=self.norm_type)
            hidden, conv, ssm = layer.mixer.step(normed, self.conv_states[k],
                                                 self.ssm_states[k])
            convs.append(conv)
            ssms.append(ssm)
        self.conv_states = torch.stack(convs)
        self.ssm_states = torch.stack(ssms)
        feat = fused_add_norm(
            hidden, model.norm.weight, model.norm.bias, residual=residual, prenorm=False,
            residual_in_fp32=self.residual_in_fp32, eps=self.eps, norm_type=self.norm_type)
        return feat[:, 0]

    def load_streaming_state(self, state) -> None:
        """Adopt a streaming-contract state (a list, tuple or dict of
        per-layer (conv_state, ssm_state), e.g. after a chunked prefill).

        The states are copied into the session's own tensors, so a prepared
        kernel launch reads them; a state of another batch size replaces them
        and prepares the launch again. Any other shape raises here."""
        items = list(state.values()) if isinstance(state, dict) else list(state)
        conv = torch.stack([s[0] for s in items])
        ssm = torch.stack([s[1] for s in items])
        bsz = conv.shape[1] if conv.dim() > 1 else -1
        for name, got, have in (("conv_state", conv, self.conv_states),
                                ("ssm_state", ssm, self.ssm_states)):
            want = (have.shape[0], bsz) + tuple(have.shape[2:])
            if tuple(got.shape) != want:
                raise ValueError(
                    f"load_streaming_state: the {name}s stack to {tuple(got.shape)}, expected "
                    f"{want} (depth, batch, ...) for this model")
        if bsz == self.batch_size:
            self.conv_states.copy_(conv)
            self.ssm_states.copy_(ssm)
            return
        self.batch_size = bsz
        self.conv_states = conv.to(self.conv_states.dtype).contiguous()
        self.ssm_states = ssm.to(self.ssm_states.dtype).contiguous()
        self._prepare()


def time_fn(fn, *args, warmup: int = 2, iters: int = 10,
            device=None) -> Tuple[float, List[float]]:
    """(median seconds, every call's seconds) of ``fn(*args)`` on the host
    clock (JAX runtime.py:375). On a CUDA ``device`` (default: the card when
    there is one) each call ends in ``torch.cuda.synchronize``, so a time
    covers the device's work and not only its enqueue."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn(*args)
        sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    times_sorted = sorted(times)
    return times_sorted[len(times_sorted) // 2], times
