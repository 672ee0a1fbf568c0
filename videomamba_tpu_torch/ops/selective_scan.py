"""Selective scan (Mamba S6) in the (B, L, D) layout of videomamba_tpu.

Port of videomamba_tpu/ops/selective_scan.py: ``selective_scan_ref`` is the
sequential fp32 oracle (the plain version of K1), and
``selective_scan_bld`` with ``method`` "chunked" (the default, as in the
JAX package), "pallas" or "kernel" routes through the hand-written K1 kernel
(ops/kernels/scan.py) — on a CPU tensor that is the same oracle.
:func:`selective_scan` is the reference-layout twin, (B, D, L) activations.
State is always (B, D, N) fp32. When autograd records a kernel call it runs
as :class:`SelectiveScanFn`, the counterpart of the JAX package's
``_pallas_fused_scan`` (selective_scan.py:371-407): K1 with checkpoints
forward, K5 backward. :func:`selective_state_update` is the single-token
step of the decode path (selective_scan.py:579-626).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from videomamba_tpu_torch.ops.kernels import scan as _scan

Tensor = torch.Tensor

DEFAULT_CHUNK_SIZE = 64  # the JAX package's chunked-scan chunk (selective_scan.py:43)
KERNEL_METHODS = ("chunked", "pallas", "kernel")  # every one runs K1


class SelectiveScanFn(torch.autograd.Function):
    """K1 forward with segment checkpoints; K5 backward."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, h0, softplus_delta):
        y, h_last, ckpt = _scan.selective_scan(
            u, delta, A, B, C, D, z, delta_bias, h0, softplus_delta, checkpoints=True
        )
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias, h0, ckpt)
        ctx.softplus_delta = softplus_delta
        return y, h_last

    @staticmethod
    def backward(ctx, g_out, g_hlast):
        u, delta, A, B, C, D, z, delta_bias, h0, ckpt = ctx.saved_tensors
        du, ddelta, dA, dB, dC, dD, dz, dbias, dh0 = _scan.selective_scan_bwd(
            u, delta, A, B, C, D, z, delta_bias, ckpt, g_out, g_hlast,
            ctx.softplus_delta,
        )
        return du, ddelta, dA, dB, dC, dD, dz, dbias, dh0.to(h0.dtype), None


def _kernel_fn(*args):
    """K1, through SelectiveScanFn when autograd records the call."""
    if torch.is_grad_enabled() and any(
        isinstance(t, Tensor) and t.requires_grad for t in args
    ):
        return SelectiveScanFn.apply(*args)
    return _scan.selective_scan(*args)


def _run(fn, u, delta, A, B, C, D, z, delta_bias, delta_softplus,
         initial_state, return_last_state):
    if u.ndim != 3 or B.ndim != 3 or C.ndim != 3:
        raise ValueError("u, B, C must be rank-3: (B, L, D) and (B, L, N).")
    bsz, _, d = u.shape
    h0 = (
        torch.zeros((bsz, d, A.shape[1]), dtype=torch.float32, device=u.device)
        if initial_state is None
        else initial_state.float()
    )
    out, h_last = fn(u, delta, A, B, C, D, z, delta_bias, h0, delta_softplus)
    out = out.to(u.dtype)
    return (out, h_last) if return_last_state else out


def selective_scan_ref(
    u: Tensor,
    delta: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor] = None,
    z: Optional[Tensor] = None,
    delta_bias: Optional[Tensor] = None,
    delta_softplus: bool = False,
    initial_state: Optional[Tensor] = None,
    return_last_state: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Sequential oracle; same arguments as :func:`selective_scan_bld`."""
    return _run(_scan.selective_scan_plain, u, delta, A, B, C, D, z,
                delta_bias, delta_softplus, initial_state, return_last_state)


def selective_scan_bld(
    u: Tensor,
    delta: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor] = None,
    z: Optional[Tensor] = None,
    delta_bias: Optional[Tensor] = None,
    delta_softplus: bool = False,
    initial_state: Optional[Tensor] = None,
    return_last_state: bool = False,
    method: str = "chunked",
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Selective scan in (B, L, D) layout.

    Args:
        u, delta, z: (B, L, D); B, C: (B, L, N); A: (D, N) real; D,
            delta_bias: (D,); initial_state: (B, D, N) or None (zeros).
        delta_softplus: apply softplus to delta + delta_bias.
        return_last_state: also return the final (B, D, N) fp32 state.
        method: "chunked" (the default), "pallas" or "kernel" run K1 (its
            plain version on a CPU tensor); "ref" the sequential oracle.
            K1 takes every shape the JAX package's chunked and Pallas scans
            take (any D, any N: ops/kernels/scan.py pads or slices the
            state), so no method falls back to another; a CUDA operand K1
            refuses (mixed dtypes, an unsupported device) raises.
        chunk_size: accepted as the JAX function accepts it (a positive
            int). It selects no route: K1 cuts time into chunks of its own
            (``ops/kernels/scan.py walk_chunk``), and every method computes
            the same recurrence.

    Returns:
        out (B, L, D) in u.dtype, or (out, last_state).
    """
    if int(chunk_size) < 1:
        raise ValueError(f"chunk_size must be a positive int, got {chunk_size!r}")
    if method in KERNEL_METHODS:
        fn = _kernel_fn
    elif method == "ref":
        fn = _scan.selective_scan_plain
    else:
        raise ValueError(f"Unknown selective_scan method: {method!r}")
    return _run(fn, u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                initial_state, return_last_state)


def selective_scan(
    u: Tensor,
    delta: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor] = None,
    z: Optional[Tensor] = None,
    delta_bias: Optional[Tensor] = None,
    delta_softplus: bool = False,
    initial_state: Optional[Tensor] = None,
    return_last_state: bool = False,
    method: str = "chunked",
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Reference-layout selective scan: u, delta, z (B, D, L); B, C (B, N, L).

    The layout twin of the reference's ``selective_scan_fn`` (JAX
    selective_scan.py:535-576): copies the activations to (B, L, D) rows
    (the layout K1 reads), runs :func:`selective_scan_bld` with the same
    arguments and returns y as a (B, D, L) view. The last state is
    (B, D, N) fp32 in both layouts.
    """
    if u.ndim != 3 or B.ndim != 3 or C.ndim != 3:
        raise ValueError("u, B, C must be rank-3: (B, D, L) and (B, N, L).")

    def rows(t):
        return None if t is None else t.transpose(1, 2).contiguous()

    out = selective_scan_bld(
        rows(u), rows(delta), A, rows(B), rows(C), D=D, z=rows(z),
        delta_bias=delta_bias, delta_softplus=delta_softplus,
        initial_state=initial_state, return_last_state=return_last_state,
        method=method, chunk_size=chunk_size,
    )
    if return_last_state:
        y, h = out
        return y.transpose(1, 2), h
    return out.transpose(1, 2)


def selective_state_update(
    state: Tensor,
    x: Tensor,
    dt: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor] = None,
    z: Optional[Tensor] = None,
    dt_bias: Optional[Tensor] = None,
    dt_softplus: bool = False,
) -> Tuple[Tensor, Tensor]:
    """One recurrence step for one token (the decode path), pure: returns
    ``(y, new_state)`` instead of updating ``state`` in place.

    state: (B, D, N); x, dt, z: (B, D); A: (D, N); B, C: (B, N); D, dt_bias:
    (D,). The math is fp32; y comes back in x.dtype and new_state in
    state.dtype.
    """
    x32 = x.float()
    dt32 = dt.float()
    if dt_bias is not None:
        dt32 = dt32 + dt_bias.float()
    if dt_softplus:
        dt32 = _scan.softplus(dt32)
    dA = torch.exp(dt32[:, :, None] * A.float())
    dBx = (dt32 * x32)[:, :, None] * B.float()[:, None, :]
    new_state = dA * state.float() + dBx
    y = torch.einsum("bdn,bn->bd", new_state, C.float())
    if D is not None:
        y = y + x32 * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(x.dtype), new_state.to(state.dtype)
