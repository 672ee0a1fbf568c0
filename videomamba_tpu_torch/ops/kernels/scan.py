"""K1: selective scan (Mamba-1 S6) and K5: its backward, hand-written CUDA.

K1 replaces videomamba_tpu/ops/pallas/scan.py (scan_chunked_pallas,
``_scan_kernel``). The kernel is csrc/selective_scan.cu over the walk in
csrc/scan_walk.cuh: one thread per (batch, channel) keeps its N fp32 states
in registers and walks L in order; a block of 128 channels stages each tile
of B_t/C_t, shared by all its channels, in shared memory. delta bias and
softplus, the D skip and the silu(z) gate run inside the walk. The walk is a
serial chain, so at batch 1 the kernel is latency-bound with only
ceil(D/128) blocks in flight; it keeps the state out of device memory and
the loads of a tile in flight together. u, delta, z, B and C are fp32 or
bf16 (widened on load); y comes back in u's dtype. ``checkpoints=True``
also returns the state at the start of every 16-step segment, fp32, laid out
(B, ceil(L / 16), D, N): the port's own layout (the TPU kernel's 8-step
``hckpt`` is internal to it), written at the walk's tile boundary.

K5 replaces scan.py (scan_bwd_pallas, ``_scan_bwd_kernel``): every gradient
of K1 from those checkpoints, in csrc/selective_scan_bwd.cu over the reverse
walk in csrc/scan_walk_bwd.cuh (design and bound in its header note). It is
latency-bound like the forward: two serial chains per step.

State sizes: the walks are compiled for N in :data:`STATE_SIZES`; every
Mamba-1 wrapper (K1, K3-K7) pads a smaller N with zero lanes (zero B and C
columns, A and h0, whose states stay zero and add nothing to y) up to the
next of them and slices the states and their gradients back. K1 and K5 run
an N above 128 (the JAX package's K1 takes N up to 512) as slices of 128
states whose y (and du, ddelta) partials are summed, with the D skip and
the gate in torch: one thread cannot hold more states.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

STATE_SIZES = (8, 16, 32, 64, 128)  # N the walks are built for
WALK_STATE = STATE_SIZES[-1]  # K1 and K5 run a wider state as slices of this many
SEGMENT = 16  # steps per checkpoint (csrc/scan_walk.cuh kScanTile)


def walk_state(n: int, kernel: str) -> int:
    """The built state size a state of n runs at: the smallest of
    STATE_SIZES that holds it. Raises above WALK_STATE."""
    if not 0 < n <= WALK_STATE:
        raise ValueError(f"{kernel} kernel takes d_state 1..{WALK_STATE}, got {n}")
    return next(size for size in STATE_SIZES if size >= n)


def pad_state(t: Optional[Tensor], npad: int) -> Optional[Tensor]:
    """t with its last axis (the state) zero-padded to npad lanes."""
    if t is None or t.shape[-1] == npad:
        return t
    return F.pad(t, (0, npad - t.shape[-1])).contiguous()


def pad_x_proj(w: Tensor, r: int, n: int, npad: int) -> Tensor:
    """x_proj's weight (R + 2 N, Di) with its B and C rows each followed by
    npad - n zero rows: the projection then gives zero padded B and C."""
    if npad == n:
        return w
    zeros = w.new_zeros((npad - n, w.shape[1]))
    return torch.cat([w[:r + n], zeros, w[r + n:], zeros]).contiguous()


def check_x_proj(kernel: str, x_proj_w: Tensor, r: int, n: int) -> None:
    """Raise unless x_proj's weight has dt_rank + 2 d_state rows (before any
    padding, which would hide a mismatch)."""
    if x_proj_w.shape[0] != r + 2 * n:
        raise ValueError(f"{kernel} kernel: x_proj_w has {x_proj_w.shape[0]} rows, expected "
                         f"dt_rank {r} + 2 x d_state {n}")


def unpad_x_proj(dw: Tensor, r: int, n: int, npad: int) -> Tensor:
    """The gradient of a padded x_proj weight back at (R + 2 N, Di)."""
    if npad == n:
        return dw
    return torch.cat([dw[:r + n], dw[r + npad:r + npad + n]])


def unpad(t: Optional[Tensor], n: int) -> Optional[Tensor]:
    """The first n states of t's last axis."""
    return None if t is None or t.shape[-1] == n else t[..., :n].contiguous()


def num_segments(seqlen: int) -> int:
    return -(-seqlen // SEGMENT)


def softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)) as jax.nn.softplus computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _delta(delta: Tensor, delta_bias: Optional[Tensor], softplus_delta: bool) -> Tensor:
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    return softplus(dt) if softplus_delta else dt


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
    checkpoints: bool = False,
):
    """Plain PyTorch version: a sequential walk over time, fp32 internals.

    u, delta, z: (Bt, L, D); B, C: (Bt, L, N); A: (D, N); D, delta_bias:
    (D,); h0: (Bt, D, N). Returns (y (Bt, L, D) in u.dtype, h_last
    (Bt, D, N) fp32) — the contract of scan_chunked_pallas — and with
    ``checkpoints`` also the segment-start states (Bt, ceil(L/16), D, N).
    """
    u32 = u.float()
    dt = _delta(delta, delta_bias, softplus_delta)
    A32 = A.float()
    B32 = B.float()
    C32 = C.float()
    du = dt * u32
    h = h0.float()
    ys, ckpts = [], []
    for t in range(u.shape[1]):
        if checkpoints and t % SEGMENT == 0:
            ckpts.append(h)
        dA = torch.exp(dt[:, t, :, None] * A32)                 # (Bt, D, N)
        h = dA * h + du[:, t, :, None] * B32[:, t, None, :]
        ys.append((h * C32[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(u32)
    if D is not None:
        y = y + u32 * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    if not checkpoints:
        return y.to(u.dtype), h
    ckpt = (torch.stack(ckpts, dim=1) if ckpts
            else h.new_zeros((h.shape[0], 0) + tuple(h.shape[1:])))
    return y.to(u.dtype), h, ckpt


def _common_dtype(*ts) -> torch.dtype:
    dtypes = {t.dtype for t in ts if t is not None}
    return dtypes.pop() if len(dtypes) == 1 else torch.float32


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
    checkpoints: bool = False,
):
    """Kernel wrapper with the contract of :func:`selective_scan_plain`.

    On CUDA, u, delta, z, B and C share one dtype, fp32 or bf16."""
    if dispatch.runs_plain(u):
        return selective_scan_plain(
            u, delta, A, B, C, D, z, delta_bias, h0, softplus_delta, checkpoints
        )
    bsz, seqlen, d = u.shape
    n = A.shape[1]
    if n > WALK_STATE:
        return _scan_sliced(u, delta, A, B, C, D, z, delta_bias, h0, softplus_delta,
                            checkpoints)
    npad = walk_state(n, "selective_scan")
    if npad != n:
        out = selective_scan(u, delta, pad_state(A, npad), pad_state(B, npad),
                             pad_state(C, npad), D, z, delta_bias, pad_state(h0, npad),
                             softplus_delta, checkpoints)
        return (out[0], *(unpad(t, n) for t in out[1:]))
    act = _build.one_dtype(u)
    rows, states = (bsz, seqlen, d), (bsz, seqlen, n)
    _build.check_operands(
        "selective_scan", u.device,
        {"u": (u, rows), "delta": (delta, rows), "z": (z, rows),
         "B": (B, states), "C": (C, states), "A": (A, (d, n)), "D": (D, (d,)),
         "delta_bias": (delta_bias, (d,)), "h0": (h0, (bsz, d, n))},
        contiguous=("A", "D", "delta_bias", "h0"),
        dtypes={k: act for k in ("u", "delta", "z", "B", "C")},
    )

    dev = u.device
    y = torch.empty((bsz, seqlen, d), dtype=u.dtype, device=dev)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((bsz, num_segments(seqlen), d, n), dtype=torch.float32,
                        device=dev) if checkpoints else None)
    if bsz == 0 or d == 0 or seqlen == 0:
        h_last.copy_(h0)
        return (y, h_last, ckpt) if checkpoints else (y, h_last)
    err = _build.library().vmt_selective_scan(
        _build.ptr(u), _build.row_stride(u, "u"),
        _build.ptr(delta), _build.row_stride(delta, "delta"),
        _build.ptr(z), _build.row_stride(z, "z") if z is not None else 0,
        _build.ptr(B), _build.row_stride(B, "B"),
        _build.ptr(C), _build.row_stride(C, "C"),
        _build.ptr(A), _build.ptr(D), _build.ptr(delta_bias), _build.ptr(h0),
        _build.ptr(y), d, _build.ptr(h_last), _build.ptr(ckpt),
        bsz, seqlen, d, n, int(softplus_delta), _build.is_bf16(u), dev.index,
        _build.stream_of(u),
    )
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return (y, h_last, ckpt) if checkpoints else (y, h_last)


selective_scan.launches = 0


def _slices(n: int):
    return [slice(lo, min(n, lo + WALK_STATE)) for lo in range(0, n, WALK_STATE)]


def _scan_sliced(u, delta, A, B, C, D, z, delta_bias, h0, softplus_delta, checkpoints):
    """K1 for a state wider than the walk's: a launch per slice of
    WALK_STATE states without the D skip and the gate, on fp32 copies of the
    activations (a widening, so the walk's arithmetic is unchanged); the
    slices' y summed, then D u and silu(z) in fp32."""
    u32, d32 = u.float(), delta.float()
    y, outs = 0.0, []
    for sl in _slices(A.shape[1]):
        out = selective_scan(u32, d32, A[:, sl].contiguous(), B[..., sl].float(),
                             C[..., sl].float(), None, None, delta_bias,
                             h0[..., sl].contiguous(), softplus_delta, checkpoints)
        y = y + out[0]
        outs.append(out[1:])
    if D is not None:
        y = y + u32 * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return (y.to(u.dtype), *(torch.cat(ts, dim=-1) for ts in zip(*outs)))


def scan_bwd_core(u32, dt, A32, B32, C32, D32, z32, g32, ckpt, g_hlast, softplus_delta):
    """The reverse walk of scan.py:401-505 in fp32, written out over time.

    u32, dt (post bias and softplus), z32, g32: (Bt, L, D) fp32; B32, C32:
    (Bt, L, N); ckpt: (Bt, ceil(L/16), D, N) segment-start states. Returns
    fp32 (du, ddelta_raw, dz or None, dB, dC, dA (D, N), dD (D,), dbias (D,),
    dh0 (Bt, D, N)).
    """
    bsz, seqlen, d = u32.shape
    n = A32.shape[1]
    g2 = g32 * F.silu(z32) if z32 is not None else g32
    du_t = dt * u32
    s = (g_hlast.float() if g_hlast is not None
         else u32.new_zeros((bsz, d, n)))
    dA = u32.new_zeros((bsz, d, n))
    du = torch.empty_like(u32)
    ddelta = torch.empty_like(u32)
    pre = torch.empty_like(u32)
    dB = u32.new_empty((bsz, seqlen, n))
    dC = u32.new_empty((bsz, seqlen, n))
    for seg in reversed(range(num_segments(seqlen))):
        t0 = seg * SEGMENT
        t1 = min(seqlen, t0 + SEGMENT)
        h = ckpt[:, seg].float()
        hprev = []
        for t in range(t0, t1):  # chain 1: pre-update states from the checkpoint
            hprev.append(h)
            h = torch.exp(dt[:, t, :, None] * A32) * h + du_t[:, t, :, None] * B32[:, t, None, :]
        for t in reversed(range(t0, t1)):  # chain 2: the cotangent carry
            hp = hprev[t - t0]
            a = torch.exp(dt[:, t, :, None] * A32)
            h_t = a * hp + du_t[:, t, :, None] * B32[:, t, None, :]
            dh = C32[:, t, None, :] * g2[:, t, :, None] + s
            s = a * dh
            daa = dh * hp * a
            dA = dA + daa * dt[:, t, :, None]
            sB = (dh * B32[:, t, None, :]).sum(-1)
            ddelta[:, t] = (daa * A32).sum(-1) + u32[:, t] * sB
            du[:, t] = dt[:, t] * sB
            dB[:, t] = (dh * du_t[:, t, :, None]).sum(1)
            dC[:, t] = (h_t * g2[:, t, :, None]).sum(1)
            pre[:, t] = (h_t * C32[:, t, None, :]).sum(-1)
    if D32 is not None:
        du = du + g2 * D32
        pre = pre + u32 * D32
    if softplus_delta:
        ddelta = ddelta * (1.0 - torch.exp(-dt))
    dz = None
    if z32 is not None:
        sig = torch.sigmoid(z32)
        dz = g32 * pre * (sig * (1.0 + z32 * (1.0 - sig)))
    dD = (g2 * u32).sum((0, 1))
    dbias = ddelta.sum((0, 1))
    return du, ddelta, dz, dB, dC, dA.sum(0), dD, dbias, s


def _cast(t: Optional[Tensor], like: Optional[Tensor]) -> Optional[Tensor]:
    return None if t is None or like is None else t.to(like.dtype)


def selective_scan_bwd_plain(
    u: Tensor,
    delta: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor],
    z: Optional[Tensor],
    delta_bias: Optional[Tensor],
    ckpt: Tensor,
    g_out: Tensor,
    g_hlast: Optional[Tensor],
    softplus_delta: bool = True,
) -> Tuple:
    """Plain PyTorch version of K5: the reverse walk written out over time
    from the same checkpoints, every incoming value widened to fp32.

    Returns (du, ddelta, dA, dB, dC, dD, dz, dbias, dh0), each in its
    primal's dtype (None where the primal was None), dh0 fp32 — the contract
    of scan_bwd_pallas.
    """
    dt = _delta(delta, delta_bias, softplus_delta)
    du, ddelta, dz, dB, dC, dA, dD, dbias, dh0 = scan_bwd_core(
        u.float(), dt, A.float(), B.float(), C.float(),
        None if D is None else D.float(), None if z is None else z.float(),
        g_out.float(), ckpt, g_hlast, softplus_delta,
    )
    return (du.to(u.dtype), ddelta.to(delta.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype), _cast(dD, D), _cast(dz, z),
            _cast(dbias, delta_bias), dh0)


def selective_scan_bwd(
    u: Tensor,
    delta: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor],
    z: Optional[Tensor],
    delta_bias: Optional[Tensor],
    ckpt: Tensor,
    g_out: Tensor,
    g_hlast: Optional[Tensor],
    softplus_delta: bool = True,
) -> Tuple:
    """Kernel wrapper with the contract of :func:`selective_scan_bwd_plain`.

    On CUDA the kernel reads u, delta, z, B, C and g_out in one dtype: their
    own where they share one (fp32 or bf16), else fp32 (a widening, exact);
    each gradient is then cast to its primal's dtype."""
    if dispatch.runs_plain(u):
        return selective_scan_bwd_plain(
            u, delta, A, B, C, D, z, delta_bias, ckpt, g_out, g_hlast, softplus_delta
        )
    bsz, seqlen, d = u.shape
    n = A.shape[1]
    if n > WALK_STATE:
        return _scan_bwd_sliced(u, delta, A, B, C, D, z, delta_bias, ckpt, g_out, g_hlast,
                                softplus_delta)
    npad = walk_state(n, "selective_scan_bwd")
    if npad != n:
        du, ddelta, dA, dB, dC, dD, dz, dbias, dh0 = selective_scan_bwd(
            u, delta, pad_state(A, npad), pad_state(B, npad), pad_state(C, npad), D, z,
            delta_bias, pad_state(ckpt, npad), g_out, pad_state(g_hlast, npad),
            softplus_delta)
        return (du, ddelta, unpad(dA, n), unpad(dB, n), unpad(dC, n), dD, dz, dbias,
                unpad(dh0, n))
    dtype = _common_dtype(u, delta, z, B, C, g_out)
    if dtype not in _build.FP32_OR_BF16:
        dtype = torch.float32
    cu, cdelta, cz, cB, cC = (None if t is None else t.to(dtype)
                              for t in (u, delta, z, B, C))
    g = g_out.to(dtype).contiguous()
    rows, states = (bsz, seqlen, d), (bsz, seqlen, n)
    _build.check_operands(
        "selective_scan_bwd", u.device,
        {"u": (cu, rows), "delta": (cdelta, rows), "z": (cz, rows), "B": (cB, states),
         "C": (cC, states), "g_out": (g, rows), "A": (A, (d, n)), "D": (D, (d,)),
         "delta_bias": (delta_bias, (d,)),
         "ckpt": (ckpt, (bsz, num_segments(seqlen), d, n)),
         "g_hlast": (g_hlast, (bsz, d, n))},
        contiguous=("g_out", "A", "D", "delta_bias", "ckpt", "g_hlast"),
        dtypes={k: (dtype,) for k in ("u", "delta", "z", "B", "C", "g_out")},
    )
    dev = u.device
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty(rows, dtype=dtype, device=dev)
    ddelta = torch.empty_like(du)
    dz = torch.empty_like(du) if z is not None else None
    dB = torch.empty(states, dtype=dtype, device=dev)
    dC = torch.empty_like(dB)
    dA = torch.empty((d, n), **f32)
    dD = torch.empty((d,), **f32)
    dbias = torch.empty((d,), **f32)
    dh0 = torch.empty((bsz, d, n), **f32)
    if bsz == 0 or d == 0 or seqlen == 0:
        for t in (du, ddelta, dz, dB, dC, dA, dD, dbias):
            if t is not None:
                t.zero_()
        dh0.copy_(g_hlast if g_hlast is not None else torch.zeros_like(dh0))
    else:
        ncb = -(-d // 64)
        bc_part = torch.empty((bsz, ncb, seqlen, 2 * n), **f32)
        dA_part = torch.empty((bsz, d, n), **f32)
        dD_part = torch.empty((bsz, d), **f32)
        dbias_part = torch.empty((bsz, d), **f32)
        err = _build.library().vmt_selective_scan_bwd(
            _build.ptr(cu), _build.row_stride(cu, "u"),
            _build.ptr(cdelta), _build.row_stride(cdelta, "delta"),
            _build.ptr(cz), _build.row_stride(cz, "z") if cz is not None else 0,
            _build.ptr(cB), _build.row_stride(cB, "B"),
            _build.ptr(cC), _build.row_stride(cC, "C"),
            _build.ptr(g), d,
            _build.ptr(A), _build.ptr(D), _build.ptr(delta_bias), _build.ptr(ckpt),
            _build.ptr(g_hlast),
            _build.ptr(du), _build.ptr(ddelta), _build.ptr(dz), _build.ptr(dB),
            _build.ptr(dC), _build.ptr(dA), _build.ptr(dD), _build.ptr(dbias),
            _build.ptr(dh0), _build.ptr(bc_part),
            _build.ptr(dA_part), _build.ptr(dD_part), _build.ptr(dbias_part),
            bsz, seqlen, d, n, int(softplus_delta), int(dtype == torch.bfloat16),
            dev.index, _build.stream_of(u),
        )
        _build.check(err, "selective_scan_bwd")
        selective_scan_bwd.launches += 1
    return (du.to(u.dtype), ddelta.to(delta.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype), _cast(dD, D), _cast(dz, z), _cast(dbias, delta_bias), dh0)


selective_scan_bwd.launches = 0


def _scan_bwd_sliced(u, delta, A, B, C, D, z, delta_bias, ckpt, g_out, g_hlast,
                     softplus_delta):
    """K5 for a state wider than the walk's: the gate's and the D skip's
    gradients in fp32 torch, and a launch per slice of WALK_STATE states
    without them (at the cotangent of the pre-gate y), whose du, ddelta and
    dbias sum; y before the gate, which dz needs, from K1 per slice."""
    u32, d32 = u.float(), delta.float()
    g2 = g_out.float() * F.silu(z.float()) if z is not None else g_out.float()
    du, ddelta, dbias, pre = 0.0, 0.0, 0.0, 0.0
    per_state = []
    for sl in _slices(A.shape[1]):
        As, Bs, Cs = A[:, sl].contiguous(), B[..., sl].float(), C[..., sl].float()
        gh = g_hlast[..., sl].contiguous() if g_hlast is not None else None
        out = selective_scan_bwd(u32, d32, As, Bs, Cs, None, None, delta_bias,
                                 ckpt[..., sl].contiguous(), g2, gh, softplus_delta)
        du, ddelta = du + out[0].float(), ddelta + out[1].float()
        dbias = dbias + out[7] if delta_bias is not None else None
        per_state.append((out[2], out[3], out[4], out[8]))
        if z is not None:
            pre = pre + selective_scan(u32, d32, As, Bs, Cs, None, None, delta_bias,
                                       ckpt[:, 0, :, sl].contiguous(), softplus_delta)[0]
    dD = None
    if D is not None:
        du = du + g2 * D.float()
        dD = (g2 * u32).sum((0, 1))
        pre = pre + u32 * D.float()
    dz = None
    if z is not None:
        sig = torch.sigmoid(z.float())
        dz = g_out.float() * pre * (sig * (1.0 + z.float() * (1.0 - sig)))
    dA, dB, dC, dh0 = (torch.cat(ts, dim=-1) for ts in zip(*per_state))
    return (du.to(u.dtype), ddelta.to(delta.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype), _cast(dD, D), _cast(dz, z), _cast(dbias, delta_bias), dh0)
