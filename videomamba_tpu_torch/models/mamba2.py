"""Mamba-2 (SSD) mixer, PyTorch port.

Port of videomamba_tpu/models/mamba2.py with the reference parameter names
of ``mamba_ssm.modules.mamba2.Mamba2``: ``in_proj`` producing [z | x B C |
dt] (bias-free by default), a depthwise ``conv1d`` over the [x B C] slab
(conv_dim = d_inner + 2 ngroups d_state), per-head ``dt_bias``, ``A_log`` and
``D``, the gated RMSNorm weight ``norm.weight`` (d_inner) and ``out_proj``.
The decay is a scalar per head, so the sequence mix is the SSD chunk walk
(ops/ssd.py).

Routes, as the JAX package picks them (mamba2.py:245-381):

* the projected mixer (K14, ops/kernels/ssd_pmixer.py: in_proj through
  out_proj in one kernel span) when the fast path takes the kernel route
  and :meth:`Mamba2._pmixer_ok` passes: ``VIDEOMAMBA_SSD_PMIXER`` on,
  bias-free projections and the JAX package's width and byte rule (Base
  and Small m2 at fp32 and bf16);
* else the mixer kernel (K12, ops/kernels/ssd_mixer.py) between
  ``torch.matmul`` projections (Tiny and Middle m2, or any preset under
  ``VIDEOMAMBA_SSD_PMIXER=0``);
* ``VIDEOMAMBA_SSD_METHOD=chunked``: the plain chunked SSD;
  ``use_fast_path=False`` or ``VIDEOMAMBA_SSD_METHOD=ref``: the sequential
  oracle.

On the card the kernel route is taken whatever the shapes: a shape outside
the kernels' gate raises there. Only a CPU tensor, whose kernel route runs
the kernels' plain versions, takes the chunked SSD for such a shape.

A call that autograd records runs through the kernels' autograd Functions
(ops/kernels/ssd_mixer_bwd.py ``SsdMixerFn``, ops/kernels/ssd_pmixer.py
``SsdPmixerFn``), on the card and on the CPU alike: the forward keeps the
chunk walk's checkpoints, the backward is K13 (or, under
``VIDEOMAMBA_SSD_BWD=composite``, torch around K11's backward), and a
projected-mixer layer follows ``VIDEOMAMBA_SSD_TRAIN_ROUTE`` ("mixer", the
default: the K12 route above, ``torch.matmul`` projections around K12 and
K13; "pmixer": K14 and its backward), as the JAX package routes a
differentiated layer. dt enters the Functions post-softplus, so autograd
carries softplus, ``dt_bias`` and the dt columns of ``in_proj``.

Streaming contract: ``conv_state (B, conv_dim, d_conv)`` raw-input window,
``ssm_state (B, nheads, headdim, d_state)`` fp32. ``state=(conv_state,
ssm_state), return_state=True`` reproduces full-sequence execution chunk
by chunk; the bare ``ssm_state``/``return_ssm_state`` path restarts the conv
from zeros each call and returns the advanced SSM state. The decode cache
(``inference_params``) and :meth:`Mamba2.step` follow the Mamba-1 mixer's.
``sp_axis`` (a process group) makes the forward take this rank's time
shard through ``parallel.sequence.sequence_parallel_mixer_m2`` (the conv
halo, the chunked SSD and the segment combine), as the JAX package routes
it. Under tensor parallelism a Mamba-2 Block's parameters are only stored
sharded (``parallel.init_train_state``): they are gathered whole before
its forward, so K12 and K13 see whole weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from videomamba_tpu_torch.models import initializers as init
from videomamba_tpu_torch.models.mamba import (
    InferenceCache,
    LayerState,
    _linear,
    check_sp_axis,
    skip_init,
)
from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.causal_conv1d import (
    causal_conv1d,
    causal_conv1d_update,
    conv_window,
)
from videomamba_tpu_torch.ops.kernels.ssd_mixer import ssd_kernel_supported, ssd_mixer
from videomamba_tpu_torch.ops.kernels.ssd_mixer_bwd import SsdMixerFn
from videomamba_tpu_torch.ops.kernels.ssd_pmixer import (
    SsdPmixerFn,
    dt_projection,
    pmixer_route_ok,
    ssd_pmixer,
)
from videomamba_tpu_torch.ops.norm import rms_norm
from videomamba_tpu_torch.ops.ssd import _prepare_dt, ssd_chunked, ssd_ref, ssd_state_update
from videomamba_tpu_torch.runtime import resolve_device

Tensor = torch.Tensor


def _records(args) -> bool:
    """Whether autograd records a call on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args)


class GatedNormWeight(nn.Module):
    """The gated RMSNorm's fp32 ``weight`` (d_inner), as ``norm.weight``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=resolve_device(device)))


class Mamba2(nn.Module):
    """SSD mixer with the JAX package's hyperparameters. Parameters are
    drawn from ``generator`` (default: seed 0); ``dt_bias``, ``A_log``,
    ``D`` and ``norm.weight`` are fp32 at every model dtype."""

    supports_block_fusion = False  # a Block runs add + norm, then this mixer

    def __init__(
        self,
        d_model: int,
        d_state: int = 64,
        d_conv: int = 4,
        expand: int = 2,
        headdim: int = 64,
        ngroups: int = 1,
        A_init_range: Tuple[float, float] = (1.0, 16.0),
        dt_min: float = 0.001,
        dt_max: float = 0.1,
        dt_init_floor: float = 1e-4,
        conv_bias: bool = True,
        bias: bool = False,
        rmsnorm: bool = True,
        norm_epsilon: float = 1e-5,
        chunk_size: int = 64,
        use_fast_path: bool = True,
        layer_idx: Optional[int] = None,
        bimamba: bool = False,
        sp_axis=None,
        device=None,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del bimamba  # accepted for create_block parity
        self.sp_axis = check_sp_axis(sp_axis)
        self.d_model = d_model
        self.d_state = d_state
        self.d_conv = d_conv
        self.expand = expand
        self.headdim = headdim
        self.ngroups = ngroups
        self.rmsnorm = rmsnorm
        self.norm_epsilon = norm_epsilon
        self.chunk_size = chunk_size
        self.use_fast_path = use_fast_path
        self.layer_idx = layer_idx
        self.d_inner = int(expand * d_model)
        if self.d_inner % headdim:
            raise ValueError(f"d_inner={self.d_inner} must be a multiple of headdim={headdim}")
        self.nheads = self.d_inner // headdim
        if self.nheads % ngroups:
            raise ValueError(f"nheads={self.nheads} must be a multiple of ngroups={ngroups}")
        self.conv_dim = self.d_inner + 2 * ngroups * d_state
        self.d_in_proj = 2 * self.d_inner + 2 * ngroups * d_state + self.nheads
        device = resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        g = torch.Generator().manual_seed(0) if generator is None else generator

        def lin(in_f, out_f):
            w = init.kaiming_uniform((out_f, in_f), in_f, g)
            b = init.default_bias((out_f,), in_f, g) if bias else None
            return _linear(in_f, out_f, w, b, device, dtype)

        self.in_proj = lin(d_model, self.d_in_proj)
        cd = self.conv_dim
        self.conv1d = skip_init(nn.Conv1d, cd, cd, d_conv, groups=cd, padding=d_conv - 1,
                                bias=conv_bias, device=device, dtype=dtype)
        with torch.no_grad():
            self.conv1d.weight.copy_(init.kaiming_uniform((cd, 1, d_conv), d_conv, g))
            if conv_bias:
                self.conv1d.bias.copy_(init.default_bias((cd,), d_conv, g))
        self.dt_bias = nn.Parameter(
            init.dt_bias_init(self.nheads, dt_min, dt_max, dt_init_floor, g).to(device))
        self.A_log = nn.Parameter(
            init.a_log_uniform(self.nheads, *A_init_range, generator=g).to(device))
        self.D = nn.Parameter(torch.ones(self.nheads, device=device))
        if rmsnorm:
            self.norm = GatedNormWeight(self.d_inner, device=device)
        self.out_proj = lin(self.d_inner, d_model)

    # ------------------------------------------------------------- forward

    def forward(
        self,
        hidden_states: Tensor,
        state: Optional[LayerState] = None,
        return_state: bool = False,
        ssm_state: Optional[Tensor] = None,
        return_ssm_state: bool = False,
        inference_params: Optional[InferenceCache] = None,
    ):
        """Apply the mixer to (B, L, d_model); the Mamba-1 mixer's returns:
        out, or (out, (conv_state, ssm_state)) with ``return_state``, or
        (out, ssm_state) with ``return_ssm_state``. Without incoming state
        the conv window takes the input dtype and ssm_state is fp32."""
        if state is not None and ssm_state is not None:
            raise ValueError("Pass either state or ssm_state, not both.")
        if return_ssm_state and ssm_state is None:
            raise ValueError("return_ssm_state requires ssm_state.")
        if self.sp_axis is not None:
            # hidden_states is this rank's time shard (JAX mamba2.py:213-232).
            if inference_params is not None:
                raise ValueError(
                    "inference_params is not supported under sequence parallelism; "
                    "decode on a single shard.")
            from videomamba_tpu_torch.parallel.sequence import sequence_parallel_mixer_m2

            return sequence_parallel_mixer_m2(
                self, hidden_states, group=self.sp_axis, state=state,
                return_state=return_state, ssm_state=ssm_state,
                return_ssm_state=return_ssm_state)
        if inference_params is not None:
            if state is not None or ssm_state is not None:
                raise ValueError("state is not supported with inference_params.")
            return self._forward_cached(hidden_states, inference_params)
        conv_state = None
        if state is not None:
            conv_state, ssm_state = state
        need_state = return_state or return_ssm_state
        method = self._method(hidden_states)
        if method == "pallas":
            out, new_ssm, raw = self._kernel_route(hidden_states, conv_state, ssm_state,
                                                   return_state)
            new_conv = conv_window(raw, conv_state, self.d_conv) if return_state else None
        else:
            out, new_conv, new_ssm = self._plain_route(hidden_states, conv_state, ssm_state,
                                                       return_state, need_state, method)
        if not need_state:
            return out
        if ssm_state is not None:
            new_ssm = new_ssm.to(ssm_state.dtype)
        if return_ssm_state:
            return out, new_ssm
        if conv_state is not None:
            new_conv = new_conv.to(conv_state.dtype)
        return out, (new_conv, new_ssm)

    def _method(self, hidden: Tensor) -> str:
        """The SSD route: "ref" off the fast path, else the dispatch
        switch's. "pallas" (the kernels) holds for every shape on the card,
        where the wrappers raise outside their gate; on the CPU a shape
        outside it takes "chunked"."""
        if not self.use_fast_path:
            return "ref"
        method = dispatch.preferred_ssd_method()
        if method == "pallas" and dispatch.runs_plain(hidden) and not ssd_kernel_supported(
                self.nheads, self.headdim, self.ngroups, self.d_state, self.chunk_size):
            return "chunked"
        return method

    def _pmixer_ok(self) -> bool:
        """The projected-mixer gate (JAX mamba2.py:383-400): the switch on,
        bias-free projections, and the JAX package's width and byte rule at
        4 bytes a weight for fp32 and 2 for bf16. The rule is the TPU
        kernel's VMEM budget, kept so both packages route a preset alike."""
        if not dispatch.ssd_pmixer_enabled():
            return False
        if self.in_proj.bias is not None or self.out_proj.bias is not None:
            return False
        wbytes = 4 if self.in_proj.weight.dtype == torch.float32 else 2
        return pmixer_route_ok(self.d_model, self.nheads, self.headdim, self.ngroups,
                               self.d_state, weight_bytes_per_el=wbytes)

    def _kernel_route(self, hidden: Tensor, conv_state: Optional[Tensor],
                      ssm_state: Optional[Tensor], return_state: bool):
        """K14, or K12 between the projections. Returns (out, h_last, the raw
        [x B C] rows the new conv window is taken from, or None)."""
        di, cd, w = self.d_inner, self.conv_dim, self.d_conv
        A = -torch.exp(self.A_log.float())
        h0 = ssm_state.float() if ssm_state is not None else None
        weights = (self.conv1d.weight.squeeze(1), self.conv1d.bias, self.D, self.dt_bias)
        norm_w = self.norm.weight if self.rmsnorm else None
        cfg = (self.norm_epsilon, self.chunk_size, self.nheads, self.headdim, self.ngroups,
               self.d_state)
        raw = None
        args = (hidden, A, self.in_proj.weight, self.out_proj.weight, *weights, h0, conv_state,
                norm_w)
        recorded = _records(args + (self.in_proj.bias,))
        # A recorded call on the "mixer" train route is K12 between the
        # projections below, as JAX _pmixer_vjp_fwd runs it.
        if self._pmixer_ok() and (not recorded or dispatch.ssd_train_route() == "pmixer"):
            if recorded:
                dt_p = dt_projection(hidden, self.in_proj.weight, self.nheads, self.dt_bias)
                out, h_last = SsdPmixerFn.apply(hidden, dt_p, A, self.in_proj.weight,
                                                self.out_proj.weight, *weights[:3], h0,
                                                conv_state, norm_w, cfg)
            else:
                out, h_last = ssd_pmixer(*args, *cfg)
            if return_state:
                # The kernel never writes zx: the window's raw rows for the
                # last W positions are recomputed (JAX mamba2.py:279-290).
                raw = hidden[:, -w:] @ self.in_proj.weight[di:di + cd].t()
            return out, h_last, raw
        zxbcdt = hidden @ self.in_proj.weight.t()
        if self.in_proj.bias is not None:
            zxbcdt = zxbcdt + self.in_proj.bias
        if recorded:
            dt_p = _prepare_dt(zxbcdt[..., di + cd:], self.dt_bias, True)
            gated, h_last = SsdMixerFn.apply(zxbcdt, dt_p, A, *weights[:3], h0, conv_state,
                                             norm_w, cfg)
        else:
            gated, h_last = ssd_mixer(zxbcdt, A, *weights, h0, conv_state, norm_w, *cfg)
        out = gated @ self.out_proj.weight.t()
        if self.out_proj.bias is not None:
            out = out + self.out_proj.bias
        if return_state:
            raw = zxbcdt[..., di:di + cd]
        return out, h_last, raw

    def _plain_route(self, hidden: Tensor, conv_state: Optional[Tensor],
                     ssm_state: Optional[Tensor], return_state: bool, need_state: bool,
                     method: str):
        """The JAX package's XLA route: conv, then the chunked SSD or the
        sequential oracle, then the gate and out_proj (mamba2.py:330-381)."""
        zxbcdt = hidden @ self.in_proj.weight.t()
        if self.in_proj.bias is not None:
            zxbcdt = zxbcdt + self.in_proj.bias
        z, xbc, dt = self._split_zxbcdt(zxbcdt)
        conv_out = causal_conv1d(xbc, self.conv1d.weight.squeeze(1).t(), self.conv1d.bias,
                                 activation="silu", initial_state=conv_state,
                                 return_final_state=return_state)
        new_conv = None
        if return_state:
            conv_out, new_conv = conv_out
        bsz, seqlen = hidden.shape[:2]
        h, p, g, n = self.nheads, self.headdim, self.ngroups, self.d_state
        x, B, C = self._split_xbc(conv_out)
        kwargs = dict(D=self.D, dt_bias=self.dt_bias, dt_softplus=True,
                      initial_state=ssm_state.float() if ssm_state is not None else None,
                      return_last_state=need_state)
        if method == "ref":
            y = ssd_ref(x.reshape(bsz, seqlen, h, p), dt, -torch.exp(self.A_log.float()),
                        B.reshape(bsz, seqlen, g, n), C.reshape(bsz, seqlen, g, n), **kwargs)
        else:
            y = ssd_chunked(x.reshape(bsz, seqlen, h, p), dt, -torch.exp(self.A_log.float()),
                            B.reshape(bsz, seqlen, g, n), C.reshape(bsz, seqlen, g, n),
                            chunk_size=self.chunk_size, **kwargs)
        new_ssm = None
        if need_state:
            y, new_ssm = y
        out = self._gate_and_project(y.reshape(bsz, seqlen, self.d_inner), z)
        return out, new_conv, new_ssm

    def _split_zxbcdt(self, zxbcdt: Tensor):
        di, cd = self.d_inner, self.conv_dim
        return zxbcdt[..., :di], zxbcdt[..., di:di + cd], zxbcdt[..., di + cd:]

    def _split_xbc(self, xbc: Tensor):
        di, gn = self.d_inner, self.ngroups * self.d_state
        return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]

    def _gate_and_project(self, y: Tensor, z: Tensor) -> Tensor:
        gated = y.float() * F.silu(z.float())
        if self.rmsnorm:
            gated = rms_norm(gated, self.norm.weight, eps=self.norm_epsilon)
        out = gated.to(z.dtype) @ self.out_proj.weight.t()
        if self.out_proj.bias is not None:
            out = out + self.out_proj.bias
        return out

    # -------------------------------------------------------------- decode

    def _forward_cached(self, hidden_states: Tensor,
                        inference_params: InferenceCache) -> Tensor:
        """The decode-cache route (JAX mamba2.py:454-472): a prefill runs the
        sequence with a zero conv window from the cached SSM state, later
        tokens go through :meth:`step`; both overwrite this layer's entry."""
        conv_state, cache_ssm = self._get_states_from_cache(
            inference_params, hidden_states.shape[0])
        if inference_params.seqlen_offset > 0:
            out, new_conv, new_ssm = self.step(hidden_states, conv_state, cache_ssm)
        else:
            out, (new_conv, new_ssm) = self(
                hidden_states, state=(torch.zeros_like(conv_state), cache_ssm),
                return_state=True)
        inference_params.key_value_memory_dict[self.layer_idx] = (new_conv, new_ssm)
        return out

    def step(self, hidden_states: Tensor, conv_state: Tensor,
             ssm_state: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """One decode token (JAX mamba2.py:404-452): hidden_states (B, 1,
        d_model). Returns (out (B, 1, d_model), new_conv_state in its dtype,
        new_ssm_state fp32), plain torch."""
        if hidden_states.shape[1] != 1:
            raise ValueError("step() decodes exactly one token at a time.")
        zxbcdt = hidden_states[:, 0] @ self.in_proj.weight.t()
        if self.in_proj.bias is not None:
            zxbcdt = zxbcdt + self.in_proj.bias
        z, xbc, dt = self._split_zxbcdt(zxbcdt)
        xbc, new_conv_state = causal_conv1d_update(
            xbc, conv_state, self.conv1d.weight.squeeze(1).t(), self.conv1d.bias)
        x, B, C = self._split_xbc(xbc)
        bsz = x.shape[0]
        h, p, g, n = self.nheads, self.headdim, self.ngroups, self.d_state
        y, new_ssm_state = ssd_state_update(
            ssm_state.float(), x.reshape(bsz, h, p), dt, -torch.exp(self.A_log.float()),
            B.reshape(bsz, g, n), C.reshape(bsz, g, n), D=self.D, dt_bias=self.dt_bias,
            dt_softplus=True)
        out = self._gate_and_project(y.reshape(bsz, self.d_inner)[:, None], z[:, None])
        return out, new_conv_state, new_ssm_state

    # ---------------------------------------------------------- state alloc

    def state_shapes(self, batch_size: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Streaming-contract shapes (read by streaming.expected_state_shapes)."""
        return ((batch_size, self.conv_dim, self.d_conv),
                (batch_size, self.nheads, self.headdim, self.d_state))

    def allocate_state(self, batch_size: int, dtype: Optional[torch.dtype] = None,
                       device=None) -> LayerState:
        """Zero (conv_state, ssm_state); conv_state in ``dtype`` (default
        fp32), ssm_state always fp32 (the SSD recurrence is fp32)."""
        dtype = torch.float32 if dtype is None else dtype
        device = self.A_log.device if device is None else device
        conv_shape, ssm_shape = self.state_shapes(batch_size)
        return (torch.zeros(conv_shape, dtype=dtype, device=device),
                torch.zeros(ssm_shape, dtype=torch.float32, device=device))

    def allocate_inference_cache(self, batch_size: int, max_seqlen: int = 1,
                                 dtype: Optional[torch.dtype] = None,
                                 device=None) -> LayerState:
        del max_seqlen
        return self.allocate_state(batch_size, dtype=dtype, device=device)

    def _get_states_from_cache(self, inference_params: InferenceCache,
                               batch_size: int) -> LayerState:
        """This layer's cached states, allocated on first use and again when
        the batch size changes (JAX mamba2.py:498-510)."""
        if self.layer_idx is None:
            raise ValueError("inference_params requires a layer_idx.")
        cache = inference_params.key_value_memory_dict
        entry = cache.get(self.layer_idx)
        if entry is None or entry[0].shape[0] != batch_size or entry[1].shape[0] != batch_size:
            cache[self.layer_idx] = self.allocate_state(batch_size)
        return cache[self.layer_idx]
