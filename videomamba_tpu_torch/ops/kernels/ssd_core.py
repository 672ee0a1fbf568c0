"""K11: the bare Mamba-2 (SSD) chunk scan and its backward, CUDA for Hopper.

Replaces videomamba_tpu/ops/pallas/ssd_scan.py (ssd_core_pallas: the forward
``_ssd_pallas_padded`` -> ``_ssd_kernel`` and the backward
``_ssd_bwd_padded`` -> ``_ssd_bwd_kernel``, joined by the custom VJP
``_ssd_pallas_core``). For x (B, L, H, P), post-softplus dt (B, L, H) fp32,
A (H,), B and C (B, L, G, N) and h0 (B, H, P, N) fp32 it returns (y (B, L,
H, P) fp32, h_last (B, H, P, N) fp32), with no D skip and no gate: the core
that ``ssd_chunked(method="pallas")`` wraps (ops/ssd.py) and that the
composite mixer backward runs (``VIDEOMAMBA_SSD_BWD=composite``).

The forward is K12's chunk walk without the conv and the gate: launches 2-5
of csrc/ssd_mixer.cu (``vmt_ssd_scan``) over x, B and C given as fp32 rows,
which leaves each chunk's entry state (``hins``) behind for the backward.
The backward is csrc/ssd_core_bwd.cu (``vmt_ssd_scan_bwd``): the reverse
chunk walk split by state passing (design and rounding in its header note),
whose per-step outputs (ds, ddt and the last-row ds of each chunk) meet the
short decay chains here, in torch, as they meet XLA in the JAX package
(``_decay_chain_grads``): d(dt A) is the reversed in-chunk cumsum of ds,
then ddt += d(dt A) A and dA = sum d(dt A) dt.

Rounding: x, B and C enter in the compute dtype (x's, fp32 or bf16); the
forward rounds as K12 does (the merged arm), the backward as the per-head
arm does; every sum and the state are fp32. The cotangents come back in
the primal dtypes (ssd_scan.py:436-437). What bounds it on the H100:
operations (the tile products: fp32 FMA at fp32, bf16 ``mma.sync`` at
bf16).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.mixer_bwd import _rnd
from videomamba_tpu_torch.ops.kernels.ssd_mixer import (
    SLAB,
    cb_scratch_elems,
    decay_cumsum,
    ssd_kernel_supported,
    to_chunks,
    walk_plain,
)
from videomamba_tpu_torch.ops.ssd import _expand_groups

Tensor = torch.Tensor


def num_slabs(chunk: int) -> int:
    """64-row slabs of a chunk: the last-row ds partials' axis."""
    return -(-chunk // SLAB)


def decay_chain(ds: Tensor, ddt: Tensor, A: Tensor, dtf: Tensor, chunk: int,
                seqlen: int) -> Tuple[Tensor, Tensor]:
    """The cotangents of dt (B, L, H) and A (H,), fp32, from the walk's ds
    and ddt (B, Lp, H): s is the in-chunk cumsum of dt A, so d(dt A) is the
    reversed in-chunk cumsum of ds (JAX ``_decay_chain_grads``)."""
    bsz, lp, nheads = ds.shape
    ds_c = ds.reshape(bsz, lp // chunk, chunk, nheads)
    ddtA = torch.flip(torch.cumsum(torch.flip(ds_c, (2,)), dim=2), (2,)).reshape(bsz, lp, nheads)
    ddt = ddt + ddtA * A.float()
    dA = (ddtA * dtf).sum((0, 1))
    return ddt[:, :seqlen], dA


def scan_bwd_plain(x_f: Tensor, Bm: Tensor, Cm: Tensor, dtf: Tensor, s: Tensor,
                   hins: Tensor, dy: Tensor, dhlast: Optional[Tensor], D: Optional[Tensor],
                   cdt: torch.dtype, chunk: int) -> Tuple:
    """The reverse chunk walk (csrc/ssd_core_bwd.cu) in plain PyTorch, with
    its rounding points. x_f (B, L, H, P), Bm and Cm (B, L, G, N), dy (B, L,
    H, P): fp32; dtf and s (B, Lp, H); hins (B, nc, H, P, N); dhlast (B, H,
    P, N) or None; D (H,) or None (then no D skip). Returns (dx (B, L, H,
    P), dB, dC (B, L, G, N), ds and ddt (B, Lp, H) with the last-row terms
    in ds, dh0 (B, H, P, N)), fp32."""
    bsz, seqlen, nheads, hdim = x_f.shape
    ngroups, d_state = Bm.shape[2], Bm.shape[3]
    q = int(chunk)
    lp = dtf.shape[1]
    nc = lp // q
    xr = _rnd(to_chunks(x_f.float(), lp, q), cdt)  # (B, C, Q, H, P)
    Br = _expand_groups(_rnd(to_chunks(Bm.float(), lp, q), cdt), nheads)  # (B, C, Q, H, N)
    Cr = _expand_groups(_rnd(to_chunks(Cm.float(), lp, q), cdt), nheads)
    dyf = to_chunks(dy.float(), lp, q)
    dyc = _rnd(dyf, cdt)
    sc = s.reshape(bsz, nc, q, nheads)
    dtc = dtf.reshape(bsz, nc, q, nheads)

    # Intra-chunk, over the causal (q, k) tiles of each head.
    cb = torch.einsum("bcqhn,bckhn->bchqk", Cr, Br)
    seg = (sc[:, :, :, None, :] - sc[:, :, None, :, :]).movedim(-1, 2)  # (B, C, H, Q, Q)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x_f.device))
    E = torch.exp(seg.masked_fill(~causal, float("-inf")))
    dtk = dtc.permute(0, 1, 3, 2)[:, :, :, None, :]  # dt_k, (B, C, H, 1, Q)
    M = _rnd(cb * E * dtk, cdt)
    dx = torch.einsum("bchqk,bcqhp->bckhp", M, dyc)
    dM = torch.einsum("bcqhp,bckhp->bchqk", dyc, xr)
    T = dM * cb * E
    colT = T.sum(-2)  # (B, C, H, Q_k)
    ddt = colT.permute(0, 1, 3, 2)
    ds = (T * dtk).sum(-1).permute(0, 1, 3, 2) - (dtk[..., 0, :] * colT).permute(0, 1, 3, 2)
    dcb = _rnd(dM * E * dtk, cdt)
    dCh = torch.einsum("bchqk,bckhn->bcqhn", dcb, Br)
    dBh = torch.einsum("bchqk,bcqhn->bckhn", dcb, Cr)

    # Inter-chunk readout y += (C h_in^T) e^s.
    es = torch.exp(sc)[..., None]  # (B, C, Q, H, 1)
    dCw = torch.einsum("bcqhp,bchpn->bcqhn", dyc, _rnd(hins, cdt))
    dCh = dCh + dCw * es
    ds = ds + (dCw * (Cr * es)).sum(-1)
    dhin = torch.einsum("bcqhp,bcqhn->bchpn", dyc, _rnd(Cr * es, cdt))

    # The reverse pass: g_c, the cotangent of the state leaving chunk c.
    eslast = torch.exp(sc[:, :, -1])  # (B, C, H)
    gr = (dhlast.float() if dhlast is not None
          else x_f.new_zeros((bsz, nheads, hdim, d_state), dtype=torch.float32))
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = gr
        gr = dhin[:, c] + eslast[:, c, :, None, None] * gr
    G = torch.stack(gs, dim=1)  # (B, C, H, P, N)

    # The state update h_out = e^s_last h_in + sum_k rnd(x w)_k^T B_k.
    g16 = _rnd(G, cdt)
    w = dtc * torch.exp(sc[:, :, -1:, :] - sc)  # (B, C, Q, H)
    R = torch.einsum("bckhn,bchpn->bckhp", Br, g16)
    dx = dx + w[..., None] * R
    dw = (xr * R).sum(-1)
    ddt = ddt + dw * torch.exp(sc[:, :, -1:, :] - sc)
    ds = ds - dw * w
    dBh = dBh + torch.einsum("bckhp,bchpn->bckhn", _rnd(xr * w[..., None], cdt), g16)
    dslast = (dw * w).sum(2) + eslast * (G * hins).sum((-2, -1))  # (B, C, H)
    ds = torch.cat([ds[:, :, :-1], ds[:, :, -1:] + dslast[:, :, None]], dim=2)
    if D is not None:
        dx = dx + D.float()[:, None] * dyf

    def rows(t):
        return t.reshape(bsz, lp, *t.shape[3:])[:, :seqlen]

    hpg = nheads // ngroups
    dB = rows(dBh).reshape(bsz, seqlen, ngroups, hpg, d_state).sum(3)
    dC = rows(dCh).reshape(bsz, seqlen, ngroups, hpg, d_state).sum(3)
    return (rows(dx), dB, dC, ds.reshape(bsz, lp, nheads), ddt.reshape(bsz, lp, nheads), gr)


def bwd_buffers(bsz: int, seqlen: int, lp: int, chunk: int, nheads: int, hdim: int,
                ngroups: int, d_state: int, device) -> dict:
    """The reverse walk's outputs and scratch, as the C entries take them."""
    nc = lp // chunk
    cd = nheads * hdim + 2 * ngroups * d_state
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        cb=torch.empty((cb_scratch_elems(bsz, lp, chunk, ngroups),), **f32),
        g=torch.empty((bsz, nc, nheads, hdim, d_state), **f32),
        dxbc=torch.empty((bsz * seqlen, cd), **f32),
        dbh=torch.empty((bsz * seqlen, nheads, d_state), **f32),
        dch=torch.empty((bsz * seqlen, nheads, d_state), **f32),
        dsq=torch.empty((bsz, lp, nheads), **f32),
        dsk=torch.empty((bsz, lp, nheads), **f32),
        ddt=torch.empty((bsz, lp, nheads), **f32),
        dslast=torch.empty((bsz, nc, num_slabs(chunk), nheads), **f32),
        dh0=torch.empty((bsz, nheads, hdim, d_state), **f32),
    )


def walk_bwd_args(buf: dict) -> tuple:
    """The reverse walk's buffers in the C entries' order."""
    p = _build.ptr
    return tuple(p(buf[k]) for k in ("g", "dxbc", "dbh", "dch", "dsq", "dsk", "ddt",
                                     "dslast", "dh0", "cb"))


def walk_ds(buf: dict, chunk: int) -> Tensor:
    """ds (B, Lp, H) from the reverse walk's buffers: the output-row and
    input-row terms, and each chunk's last-row term summed over its slabs."""
    ds = buf["dsq"] + buf["dsk"]
    ds[:, chunk - 1::chunk] += buf["dslast"].sum(2)
    return ds


def _check_shapes(kernel: str, x4: Tensor, B4: Tensor, chunk_size: int) -> None:
    nheads, hdim = x4.shape[2], x4.shape[3]
    ngroups, d_state = B4.shape[2], B4.shape[3]
    if not ssd_kernel_supported(nheads, hdim, ngroups, d_state, chunk_size):
        raise ValueError(
            f"{kernel} kernel: head dim {hdim} and d_state {d_state} must be multiples of 4, "
            f"chunk {chunk_size} positive and {ngroups} groups must divide {nheads} heads")


def ssd_scan_plain(x4: Tensor, dt_p: Tensor, A: Tensor, B4: Tensor, C4: Tensor,
                   h0: Optional[Tensor], chunk_size: int = 128,
                   checkpoints: bool = False) -> Tuple:
    """Plain PyTorch version of K11's forward with its rounding points.
    Returns (y (B, L, H, P) fp32, h_last (B, H, P, N) fp32), and with
    ``checkpoints`` also hins (B, nc, H, P, N) fp32."""
    dtf, s = decay_cumsum(dt_p, A, int(chunk_size))
    y, h_last, hins = walk_plain(x4.float(), B4.float(), C4.float(), dtf, s, h0, None,
                                 x4.dtype, chunk_size)
    return (y, h_last, hins) if checkpoints else (y, h_last)


def ssd_scan(x4: Tensor, dt_p: Tensor, A: Tensor, B4: Tensor, C4: Tensor,
             h0: Optional[Tensor], chunk_size: int = 128, checkpoints: bool = False) -> Tuple:
    """Kernel wrapper with the contract of :func:`ssd_scan_plain`. On CUDA:
    x, B and C share one dtype, fp32 or bf16; dt, A and h0 of any float
    dtype, read as fp32."""
    if dispatch.runs_plain(x4):
        return ssd_scan_plain(x4, dt_p, A, B4, C4, h0, chunk_size, checkpoints)
    bsz, seqlen, nheads, hdim = x4.shape
    ngroups, d_state = B4.shape[2], B4.shape[3]
    _check_shapes("ssd_scan", x4, B4, chunk_size)
    act = _build.one_dtype(x4)
    gs = (bsz, seqlen, ngroups, d_state)
    _build.check_operands("ssd_scan", x4.device,
                          {"x": (x4, (bsz, seqlen, nheads, hdim)), "B": (B4, gs), "C": (C4, gs),
                           "dt": (dt_p, (bsz, seqlen, nheads)), "A": (A, (nheads,)),
                           "h0": (h0, (bsz, nheads, hdim, d_state))},
                          dtypes={"x": act, "B": act, "C": act, "dt": _build.FP32_OR_BF16,
                                  "A": _build.FP32_OR_BF16, "h0": _build.FP32_OR_BF16})
    dev = x4.device
    f32 = dict(dtype=torch.float32, device=dev)
    dtf, s = decay_cumsum(dt_p, A, int(chunk_size))
    nc = dtf.shape[1] // chunk_size
    xbc = torch.cat([x4.reshape(bsz, seqlen, -1), B4.reshape(bsz, seqlen, -1),
                     C4.reshape(bsz, seqlen, -1)], dim=-1).float().contiguous()
    h0f = (h0.float().contiguous() if h0 is not None
           else torch.zeros((bsz, nheads, hdim, d_state), **f32))
    y = torch.empty((bsz, seqlen, nheads, hdim), **f32)
    h_last = torch.empty((bsz, nheads, hdim, d_state), **f32)
    hins = torch.empty((bsz, nc, nheads, hdim, d_state), **f32)
    cb = torch.empty((cb_scratch_elems(bsz, dtf.shape[1], int(chunk_size), ngroups),), **f32)
    if bsz == 0 or seqlen == 0:
        h_last.copy_(h0f)
    else:
        err = _build.library().vmt_ssd_scan(
            xbc.data_ptr(), y.data_ptr(), s.data_ptr(), dtf.data_ptr(), h0f.data_ptr(),
            h_last.data_ptr(), hins.data_ptr(), cb.data_ptr(), bsz, seqlen, int(chunk_size),
            nheads, hdim, ngroups, d_state, _build.is_bf16(x4), dev.index,
            _build.stream_of(x4))
        _build.check(err, "ssd_scan")
        ssd_scan.launches += 1
    return (y, h_last, hins) if checkpoints else (y, h_last)


ssd_scan.launches = 0


def ssd_scan_bwd_plain(x4: Tensor, dt_p: Tensor, A: Tensor, B4: Tensor, C4: Tensor,
                       hins: Tensor, dy: Tensor, dhlast: Optional[Tensor],
                       chunk_size: int = 128) -> Tuple:
    """Plain PyTorch version of K11's backward. Returns (dx (B, L, H, P),
    ddt (B, L, H), dA (H,), dB, dC (B, L, G, N), dh0 (B, H, P, N)), fp32."""
    q = int(chunk_size)
    dtf, s = decay_cumsum(dt_p, A, q)
    dx, dB, dC, ds, ddt, dh0 = scan_bwd_plain(x4.float(), B4.float(), C4.float(), dtf, s,
                                              hins, dy, dhlast, None, x4.dtype, q)
    ddt, dA = decay_chain(ds, ddt, A, dtf, q, x4.shape[1])
    return dx, ddt, dA, dB, dC, dh0


def ssd_scan_bwd(x4: Tensor, dt_p: Tensor, A: Tensor, B4: Tensor, C4: Tensor,
                 hins: Tensor, dy: Tensor, dhlast: Optional[Tensor],
                 chunk_size: int = 128) -> Tuple:
    """Kernel wrapper with the contract of :func:`ssd_scan_bwd_plain`. On
    CUDA: x, B and C share one dtype, fp32 or bf16; hins fp32 from the
    forward; dy and dhlast of any float dtype, read as fp32."""
    if dispatch.runs_plain(x4):
        return ssd_scan_bwd_plain(x4, dt_p, A, B4, C4, hins, dy, dhlast, chunk_size)
    bsz, seqlen, nheads, hdim = x4.shape
    ngroups, d_state = B4.shape[2], B4.shape[3]
    q = int(chunk_size)
    _check_shapes("ssd_scan_bwd", x4, B4, q)
    if bsz == 0 or seqlen == 0:
        raise ValueError("ssd_scan_bwd kernel: an empty batch or sequence")
    act = _build.one_dtype(x4)
    gs = (bsz, seqlen, ngroups, d_state)
    dtf, s = decay_cumsum(dt_p, A, q)
    lp = dtf.shape[1]
    _build.check_operands(
        "ssd_scan_bwd", x4.device,
        {"x": (x4, (bsz, seqlen, nheads, hdim)), "B": (B4, gs), "C": (C4, gs),
         "hins": (hins, (bsz, lp // q, nheads, hdim, d_state)),
         "dy": (dy, (bsz, seqlen, nheads, hdim)),
         "dhlast": (dhlast, (bsz, nheads, hdim, d_state))},
        contiguous=("hins",),
        dtypes={"x": act, "B": act, "C": act, "dy": _build.FP32_OR_BF16,
                "dhlast": _build.FP32_OR_BF16})
    xbc = torch.cat([x4.reshape(bsz, seqlen, -1), B4.reshape(bsz, seqlen, -1),
                     C4.reshape(bsz, seqlen, -1)], dim=-1).float().contiguous()
    dyf = dy.float().contiguous()
    dhl = dhlast.float().contiguous() if dhlast is not None else None
    buf = bwd_buffers(bsz, seqlen, lp, q, nheads, hdim, ngroups, d_state, x4.device)
    err = _build.library().vmt_ssd_scan_bwd(
        xbc.data_ptr(), dyf.data_ptr(), s.data_ptr(), dtf.data_ptr(), hins.data_ptr(),
        _build.ptr(dhl), *walk_bwd_args(buf), bsz, seqlen, q, nheads, hdim, ngroups, d_state,
        _build.is_bf16(x4), x4.device.index, _build.stream_of(x4))
    _build.check(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    ddt, dA = decay_chain(walk_ds(buf, q), buf["ddt"], A, dtf, q, seqlen)
    di, gn = nheads * hdim, ngroups * d_state
    dxbc = buf["dxbc"].view(bsz, seqlen, -1)
    return (dxbc[..., :di].reshape(bsz, seqlen, nheads, hdim), ddt, dA,
            dxbc[..., di:di + gn].reshape(gs), dxbc[..., di + gn:].reshape(gs), buf["dh0"])


ssd_scan_bwd.launches = 0


class SsdCoreFn(torch.autograd.Function):
    """K11 under autograd: the forward keeps each chunk's entry state, the
    backward is K11's (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x4, dt_p, A, B4, C4, h0, chunk_size):
        y, h_last, hins = ssd_scan(x4, dt_p, A, B4, C4, h0, chunk_size, checkpoints=True)
        ctx.save_for_backward(x4, dt_p, A, B4, C4, hins)
        ctx.chunk_size = chunk_size
        ctx.h0_dtype = None if h0 is None else h0.dtype
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dhlast):
        x4, dt_p, A, B4, C4, hins = ctx.saved_tensors
        dx, ddt, dA, dB, dC, dh0 = ssd_scan_bwd(x4, dt_p, A, B4, C4, hins, dy, dhlast,
                                                ctx.chunk_size)
        dh0 = dh0.to(ctx.h0_dtype) if ctx.h0_dtype is not None else None
        return (dx.to(x4.dtype), ddt.to(dt_p.dtype), dA.to(A.dtype), dB.to(B4.dtype),
                dC.to(C4.dtype), dh0, None)


def ssd_core_pallas(x4: Tensor, dt_p: Tensor, A: Tensor, B4: Tensor, C4: Tensor,
                    initial_state: Optional[Tensor], chunk_size: int = 128) -> Tuple:
    """The JAX ``ssd_core_pallas`` contract (a twin of ``ssd_core_chunked``):
    (y fp32 (B, L, H, P), h_last fp32 (B, H, P, N)); differentiable through
    :class:`SsdCoreFn` when autograd records any input."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x4, dt_p, A, B4, C4, initial_state)):
        return SsdCoreFn.apply(x4, dt_p, A, B4, C4, initial_state, int(chunk_size))
    return ssd_scan(x4, dt_p, A, B4, C4, initial_state, int(chunk_size))
