"""K1: selective scan (Mamba-1 S6), hand-written CUDA for Hopper.

Replaces videomamba_tpu/ops/pallas/scan.py (scan_chunked_pallas,
``_scan_kernel``). The kernel is csrc/selective_scan.cu over the walk in
csrc/scan_walk.cuh: one thread per (batch, channel) keeps its N fp32 states
in registers and walks L in order; a block of 128 channels stages each tile
of B_t/C_t, shared by all its channels, in shared memory. delta bias and
softplus, the D skip and the silu(z) gate run inside the walk. The walk is a
serial chain, so at batch 1 the kernel is latency-bound with only
ceil(D/128) blocks in flight; it keeps the state out of device memory and
the loads of a tile in flight together. fp32 only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

STATE_SIZES = (8, 16, 32, 64)  # N the library is built for


def softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)) as jax.nn.softplus computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def selective_scan_plain(
    u: Tensor,
    delta: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor],
    z: Optional[Tensor],
    delta_bias: Optional[Tensor],
    h0: Tensor,
    softplus_delta: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version: a sequential walk over time, fp32 internals.

    u, delta, z: (Bt, L, D); B, C: (Bt, L, N); A: (D, N); D, delta_bias:
    (D,); h0: (Bt, D, N). Returns (y (Bt, L, D) in u.dtype, h_last
    (Bt, D, N) fp32) — the contract of scan_chunked_pallas.
    """
    u32 = u.float()
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if softplus_delta:
        dt = softplus(dt)
    A32 = A.float()
    B32 = B.float()
    C32 = C.float()
    du = dt * u32
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A32)                 # (Bt, D, N)
        h = dA * h + du[:, t, :, None] * B32[:, t, None, :]
        ys.append((h * C32[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(u32)
    if D is not None:
        y = y + u32 * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(u.dtype), h


def selective_scan(
    u: Tensor,
    delta: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor],
    z: Optional[Tensor],
    delta_bias: Optional[Tensor],
    h0: Tensor,
    softplus_delta: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Kernel wrapper with the contract of :func:`selective_scan_plain`."""
    if dispatch.runs_plain(u):
        return selective_scan_plain(
            u, delta, A, B, C, D, z, delta_bias, h0, softplus_delta
        )
    bsz, seqlen, d = u.shape
    n = A.shape[1]
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan kernel: d_state {n} not in {STATE_SIZES}")
    rows, states = (bsz, seqlen, d), (bsz, seqlen, n)
    _build.check_operands(
        "selective_scan", u.device,
        {"u": (u, rows), "delta": (delta, rows), "z": (z, rows),
         "B": (B, states), "C": (C, states), "A": (A, (d, n)), "D": (D, (d,)),
         "delta_bias": (delta_bias, (d,)), "h0": (h0, (bsz, d, n))},
        contiguous=("A", "D", "delta_bias", "h0"),
    )

    y = torch.empty((bsz, seqlen, d), dtype=torch.float32, device=u.device)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=u.device)
    if bsz == 0 or d == 0:
        return y, h_last
    err = _build.library().vmt_selective_scan(
        _build.ptr(u), _build.row_stride(u, "u"),
        _build.ptr(delta), _build.row_stride(delta, "delta"),
        _build.ptr(z), _build.row_stride(z, "z") if z is not None else 0,
        _build.ptr(B), _build.row_stride(B, "B"),
        _build.ptr(C), _build.row_stride(C, "C"),
        _build.ptr(A), _build.ptr(D), _build.ptr(delta_bias), _build.ptr(h0),
        _build.ptr(y), d, _build.ptr(h_last),
        bsz, seqlen, d, n, int(softplus_delta), u.device.index,
        _build.stream_of(u),
    )
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
