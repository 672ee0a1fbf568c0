"""Mamba selective-SSM mixer (Mamba-1), PyTorch port.

Port of videomamba_tpu/models/mamba.py with the reference's parameter names
(``in_proj``, ``conv1d``, ``x_proj``, ``dt_proj``, ``A_log``, ``D``,
``out_proj``) and layouts, so a reference state_dict loads strictly.

Per token sequence x (B, L, d_model):

    xz = x @ W_in^T ;  x', z = split(xz)                 torch.matmul
    y, h = fused mixer core(x', z, conv, x_proj, dt_proj, scan, gate)
                                                         K3 (fused branch)
       or conv -> x_proj -> dt_proj -> K1 scan            (unfused branch)
    out = y @ W_out^T                                    torch.matmul

Training: when autograd records the fused branch it runs as
:class:`MixerFusedFn` (the JAX package's ``_fused_mixer``, mamba.py:68-215):
K3 with checkpoints forward; K6 backward, or under
``VIDEOMAMBA_MIXER_BWD=composite`` a plain recompute of the conv and the
products chained to K5. The unfused branch runs K1 / K5 through
``ops.selective_scan.SelectiveScanFn``. in_proj and out_proj stay
``torch.matmul`` under autograd, as the JAX package leaves them to XLA.

Streaming contract 1.0.0: ``conv_state (B, d_inner, d_conv)`` holds the last
d_conv raw conv inputs, ``ssm_state (B, d_inner, d_state)`` the recurrence;
``state=(conv_state, ssm_state), return_state=True`` returns the advanced
pair, so chunked execution reproduces full-sequence execution. New states
keep the incoming states' dtypes.

Decode cache (JAX mamba.py:218-232, 408-440, 574-665): with
``inference_params`` (an :class:`InferenceCache`) the mixer allocates its
layer's (conv_state, ssm_state) in the cache on first use (again when the
batch size changes); a prefill (``seqlen_offset == 0``) runs the sequence
with a zero conv window from the cached SSM state, and later calls decode
one token through :meth:`Mamba.step` (``causal_conv1d_update`` and
``selective_state_update``, plain torch). Either way the cache dict is
updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn.utils import skip_init as _skip_init

from videomamba_tpu_torch.models import initializers as init
from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.causal_conv1d import (
    causal_conv1d,
    causal_conv1d_update,
    conv_window,
)
from videomamba_tpu_torch.ops.kernels.block_fused import mixer_fused_supported
from videomamba_tpu_torch.ops.kernels.mixer_bwd import mixer_bwd
from videomamba_tpu_torch.ops.kernels.mixer_fused import mixer_fused
from videomamba_tpu_torch.ops.kernels.scan import selective_scan_bwd
from videomamba_tpu_torch.ops.selective_scan import (
    selective_scan_bld,
    selective_state_update,
)
from videomamba_tpu_torch.runtime import resolve_device

Tensor = torch.Tensor
LayerState = Tuple[Tensor, Tensor]


def skip_init(module_cls, *args, device=None, **kwargs) -> nn.Module:
    """Build a module without running its default init (the caller fills the
    parameters from its generator), on ``device`` (default: the card, see
    :func:`videomamba_tpu_torch.runtime.resolve_device`)."""
    return _skip_init(module_cls, *args, device=resolve_device(device), **kwargs)


def _composite_bwd(x, z, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D,
                   conv_state, ckpt, g_y, g_hlast):
    """The JAX package's composite mixer backward (mamba.py:160-212): the
    conv recomputed under autograd, the products recomputed in torch with
    the same roundings, K5 for the scan, torch for the rest."""
    r = dt_proj_w.shape[1]
    n = A.shape[1]
    leaves = [t.detach().requires_grad_() for t in (x, conv_w, conv_b, conv_state)]
    with torch.enable_grad():
        conv_out = causal_conv1d(leaves[0], leaves[1].t(), leaves[2],
                                 activation="silu", initial_state=leaves[3])
    cy = conv_out.detach()
    mm_in = cy.to(x_proj_w.dtype)
    xdbl = (mm_in @ x_proj_w.t()).float()
    delta_raw = (xdbl[..., :r].to(dt_proj_w.dtype) @ dt_proj_w.t()).float()
    du, ddelta, dA, dB, dC, dD, dz, dbias, dh0 = selective_scan_bwd(
        cy, delta_raw, A, xdbl[..., r:r + n], xdbl[..., r + n:], D, z, dt_bias,
        ckpt, g_y, g_hlast, True,
    )
    ddelta = ddelta.float()
    dxdbl = torch.cat([ddelta @ dt_proj_w.float(), dB.float(), dC.float()], dim=-1)
    dwdt = torch.einsum("blr,bld->dr", xdbl[..., :r], ddelta).to(dt_proj_w.dtype)
    dwx = torch.einsum("bld,blp->pd", mm_in.float(), dxdbl).to(x_proj_w.dtype)
    dconv_out = (du.float() + dxdbl @ x_proj_w.float()).to(conv_out.dtype)
    dx, dcw, dcb, dcst = torch.autograd.grad(conv_out, leaves, dconv_out)
    return (dx.to(x.dtype), dz, dcw.to(conv_w.dtype), dcb.to(conv_b.dtype), dwx, dwdt,
            dbias, dA, dD, dh0, dcst.to(conv_state.dtype))


class MixerFusedFn(torch.autograd.Function):
    """K3 forward with segment checkpoints; K6 (or composite) backward."""

    @staticmethod
    def forward(ctx, x, z, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D,
                h0, conv_state):
        y, h_last, ckpt = mixer_fused(x, z, conv_w, conv_b, x_proj_w, dt_proj_w,
                                      dt_bias, A, D, h0, conv_state, checkpoints=True)
        ctx.save_for_backward(x, z, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias,
                              A, D, h0, conv_state, ckpt)
        return y, h_last

    @staticmethod
    def backward(ctx, g_y, g_hlast):
        (x, z, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, h0,
         conv_state, ckpt) = ctx.saved_tensors
        fn = mixer_bwd if dispatch.mixer_bwd_backend() == "fused" else _composite_bwd
        grads = fn(x, z, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D,
                   conv_state, ckpt, g_y, g_hlast)
        *head, dh0, dcst = grads
        return (*head, dh0.to(h0.dtype), dcst)


@dataclasses.dataclass
class InferenceCache:
    """Decode-time cache (JAX mamba.py:218-232): per-layer (conv_state,
    ssm_state) keyed by ``layer_idx``. ``seqlen_offset`` 0 means the next
    call is a prefill; above 0, each call decodes one token. The mixers
    replace their entries in ``key_value_memory_dict`` in place, so the
    caller threads one cache object through its calls."""

    seqlen_offset: int = 0
    key_value_memory_dict: Dict[int, LayerState] = dataclasses.field(default_factory=dict)


def _linear(in_f: int, out_f: int, weight: Tensor, bias: Optional[Tensor],
            device, dtype) -> nn.Linear:
    lin = skip_init(nn.Linear, in_f, out_f, bias=bias is not None,
                    device=device, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(weight)
        if bias is not None:
            lin.bias.copy_(bias)
    return lin


class Mamba(nn.Module):
    """Selective-SSM mixer.

    ``use_fast_path=True`` routes the mixer core through the hand-written
    kernels (plain versions on CPU tensors); ``False``, or
    ``VIDEOMAMBA_DISABLE_FUSED`` in the environment, runs the plain path.
    ``bimamba`` is accepted for config parity; the mixer is unidirectional.
    Parameters are drawn from ``generator`` (default: seed 0).
    """

    def __init__(
        self,
        d_model: int,
        d_state: int = 16,
        d_conv: int = 4,
        expand: int = 2,
        dt_rank: Union[int, str] = "auto",
        dt_min: float = 0.001,
        dt_max: float = 0.1,
        dt_init: str = "random",
        dt_scale: float = 1.0,
        dt_init_floor: float = 1e-4,
        conv_bias: bool = True,
        bias: bool = False,
        use_fast_path: bool = True,
        layer_idx: Optional[int] = None,
        bimamba: bool = True,
        device=None,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del bimamba
        device = resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.d_model = d_model
        self.d_state = d_state
        self.d_conv = d_conv
        self.expand = expand
        self.d_inner = int(expand * d_model)
        self.dt_rank = math.ceil(d_model / 16) if dt_rank == "auto" else int(dt_rank)
        self.use_fast_path = use_fast_path and not dispatch.fused_disabled_by_env()
        self.layer_idx = layer_idx
        d_in, r, n = self.d_inner, self.dt_rank, d_state

        def lin(in_f, out_f, with_bias):
            w = init.kaiming_uniform((out_f, in_f), in_f, g)
            b = init.default_bias((out_f,), in_f, g) if with_bias else None
            return _linear(in_f, out_f, w, b, device, dtype)

        self.in_proj = lin(d_model, 2 * d_in, bias)
        self.conv1d = skip_init(
            nn.Conv1d, d_in, d_in, d_conv, groups=d_in, padding=d_conv - 1,
            bias=conv_bias, device=device, dtype=dtype,
        )
        with torch.no_grad():
            self.conv1d.weight.copy_(init.kaiming_uniform((d_in, 1, d_conv), d_conv, g))
            if conv_bias:
                self.conv1d.bias.copy_(init.default_bias((d_in,), d_conv, g))
        self.x_proj = lin(d_in, r + 2 * n, False)

        dt_init_std = r ** -0.5 * dt_scale
        if dt_init == "constant":
            dt_w = torch.full((d_in, r), dt_init_std)
        elif dt_init == "random":
            dt_w = init.uniform((d_in, r), -dt_init_std, dt_init_std, g)
        else:
            raise NotImplementedError(f"dt_init={dt_init!r}")
        self.dt_proj = _linear(r, d_in, dt_w, None, device, dtype)
        # dt_proj.bias, A_log and D stay fp32 at every model dtype.
        self.dt_proj.bias = nn.Parameter(
            init.dt_bias_init(d_in, dt_min, dt_max, dt_init_floor, g).to(device)
        )
        self.A_log = nn.Parameter(init.s4d_real_A_log(d_in, n).to(device))
        self.D = nn.Parameter(torch.ones(d_in, device=device))
        self.out_proj = lin(d_in, d_model, bias)

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
        """Apply the mixer to (B, L, d_model).

        Returns out (B, L, d_model); with ``return_state`` also the new
        (conv_state, ssm_state); with ``ssm_state`` and ``return_ssm_state``
        (the reference's bare-SSM-state path) also the advanced ssm state.
        Without incoming state, conv_state takes the input dtype and
        ssm_state is fp32. With ``inference_params`` (the decode cache) it
        returns out only and leaves the advanced state in the cache.
        """
        if state is not None and ssm_state is not None:
            raise ValueError("Pass either state or ssm_state, not both.")
        if return_ssm_state and ssm_state is None:
            raise ValueError("return_ssm_state requires ssm_state.")
        if inference_params is not None:
            if state is not None:
                raise ValueError("state is not supported with inference_params.")
            if return_ssm_state:
                raise ValueError(
                    "return_ssm_state is not supported with inference_params; "
                    "the decode cache already carries the advanced state."
                )
            return self._forward_cached(hidden_states, ssm_state, inference_params)
        conv_state = None
        if state is not None:
            conv_state, ssm_state = state
        need_state = return_state or return_ssm_state

        xz = hidden_states @ self.in_proj.weight.t()
        if self.in_proj.bias is not None:
            xz = xz + self.in_proj.bias
        x, z = xz.chunk(2, dim=-1)
        A = -torch.exp(self.A_log.float())
        new_conv_state = None

        if self._use_fused_mixer():
            bsz = x.shape[0]
            h0 = (
                ssm_state.float()
                if ssm_state is not None
                else x.new_zeros((bsz, self.d_inner, self.d_state), dtype=torch.float32)
            )
            cstate_in = (
                conv_state
                if conv_state is not None
                else x.new_zeros((bsz, self.d_inner, self.d_conv))
            )
            args = (x, z, self.conv1d.weight.squeeze(1), self.conv1d.bias,
                    self.x_proj.weight, self.dt_proj.weight,
                    self.dt_proj.bias.float(), A, self.D.float(), h0, cstate_in)
            if torch.is_grad_enabled() and any(t.requires_grad for t in args):
                y, new_ssm_state = MixerFusedFn.apply(*args)
            else:
                y, new_ssm_state = mixer_fused(*args)
            if return_state:
                new_conv_state = conv_window(x, conv_state, self.d_conv)
        else:
            conv_out = causal_conv1d(
                x, self.conv1d.weight.squeeze(1).t(), self.conv1d.bias,
                activation="silu", initial_state=conv_state,
                return_final_state=return_state,
            )
            if return_state:
                conv_out, new_conv_state = conv_out
            x_dbl = conv_out @ self.x_proj.weight.t()
            r, n = self.dt_rank, self.d_state
            dt = x_dbl[..., :r] @ self.dt_proj.weight.t()
            scan_out = selective_scan_bld(
                conv_out, dt, A, x_dbl[..., r:r + n], x_dbl[..., r + n:],
                D=self.D.float(), z=z, delta_bias=self.dt_proj.bias.float(),
                delta_softplus=True, initial_state=ssm_state,
                return_last_state=need_state,
                method="kernel" if self.use_fast_path else "ref",
            )
            y, new_ssm_state = scan_out if need_state else (scan_out, None)

        out = y @ self.out_proj.weight.t()
        if self.out_proj.bias is not None:
            out = out + self.out_proj.bias
        if not need_state:
            return out
        if ssm_state is not None:
            new_ssm_state = new_ssm_state.to(ssm_state.dtype)
        if return_ssm_state:
            return out, new_ssm_state
        if conv_state is not None:
            new_conv_state = new_conv_state.to(conv_state.dtype)
        return out, (new_conv_state, new_ssm_state)

    def _forward_cached(self, hidden_states: Tensor, ssm_state: Optional[Tensor],
                        inference_params: InferenceCache) -> Tensor:
        """The decode-cache route (JAX mamba.py:408-440): prefill convs with
        a zero window from the cached (or given) SSM state, later tokens go
        through :meth:`step`; both overwrite this layer's cache entry."""
        conv_state, cache_ssm = self._get_states_from_cache(
            inference_params, hidden_states.shape[0])
        if ssm_state is None:
            ssm_state = cache_ssm
        if inference_params.seqlen_offset > 0:
            out, new_conv, new_ssm = self.step(hidden_states, conv_state, ssm_state)
        else:
            out, (new_conv, new_ssm) = self(
                hidden_states, state=(torch.zeros_like(conv_state), ssm_state),
                return_state=True)
        inference_params.key_value_memory_dict[self.layer_idx] = (new_conv, new_ssm)
        return out

    def step(self, hidden_states: Tensor, conv_state: Tensor,
             ssm_state: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """One decode token (JAX mamba.py:574-616): hidden_states (B, 1,
        d_model). Returns (out (B, 1, d_model), new_conv_state,
        new_ssm_state), the states in their incoming dtypes."""
        if hidden_states.shape[1] != 1:
            raise ValueError("step() decodes exactly one token at a time.")
        xz = hidden_states[:, 0] @ self.in_proj.weight.t()
        if self.in_proj.bias is not None:
            xz = xz + self.in_proj.bias
        x, z = xz.chunk(2, dim=-1)
        x, new_conv_state = causal_conv1d_update(
            x, conv_state, self.conv1d.weight.squeeze(1).t(), self.conv1d.bias)
        x_db = x @ self.x_proj.weight.t()
        r, n = self.dt_rank, self.d_state
        dt = x_db[..., :r] @ self.dt_proj.weight.t()
        y, new_ssm_state = selective_state_update(
            ssm_state, x, dt, -torch.exp(self.A_log.float()), x_db[..., r:r + n],
            x_db[..., r + n:], D=self.D, z=z, dt_bias=self.dt_proj.bias, dt_softplus=True,
        )
        out = y @ self.out_proj.weight.t()
        if self.out_proj.bias is not None:
            out = out + self.out_proj.bias
        return out[:, None], new_conv_state, new_ssm_state

    def _use_fused_mixer(self) -> bool:
        """The fused core (K3) needs the fast path, a conv bias and the JAX
        package's shape rule (d_inner a multiple of 128, dt_rank and d_state
        up to 128, d_state a multiple of 8), as in
        videomamba_tpu/models/mamba.py:552-560; other layers take the
        unfused branch, whose scan is K1."""
        return (self.use_fast_path and self.conv1d.bias is not None
                and mixer_fused_supported(self.d_inner, self.dt_rank, self.d_state))

    def allocate_state(
        self, batch_size: int, dtype: Optional[torch.dtype] = None, device=None
    ) -> LayerState:
        """Zero (conv_state, ssm_state) for streaming; dtype defaults to fp32."""
        dtype = torch.float32 if dtype is None else dtype
        device = self.A_log.device if device is None else device
        conv_state = torch.zeros(
            (batch_size, self.d_inner, self.d_conv), dtype=dtype, device=device
        )
        ssm_state = torch.zeros(
            (batch_size, self.d_inner, self.d_state), dtype=dtype, device=device
        )
        return conv_state, ssm_state

    def allocate_inference_cache(self, batch_size: int, max_seqlen: int = 1,
                                 dtype: Optional[torch.dtype] = None,
                                 device=None) -> LayerState:
        """Decode-cache allocation: the shapes of :meth:`allocate_state`
        (JAX mamba.py:633-639)."""
        del max_seqlen
        return self.allocate_state(batch_size, dtype=dtype, device=device)

    def _get_states_from_cache(self, inference_params: InferenceCache,
                               batch_size: int) -> LayerState:
        """This layer's cached states, allocated on first use and again when
        the batch size changes (JAX mamba.py:641-665)."""
        if self.layer_idx is None:
            raise ValueError("inference_params requires a layer_idx.")
        cache = inference_params.key_value_memory_dict
        entry = cache.get(self.layer_idx)
        if entry is None or entry[0].shape[0] != batch_size or entry[1].shape[0] != batch_size:
            cache[self.layer_idx] = self.allocate_state(batch_size)
        return cache[self.layer_idx]
