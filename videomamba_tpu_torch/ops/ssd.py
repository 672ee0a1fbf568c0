"""SSD (state-space duality, Mamba-2) scan in plain PyTorch.

Port of videomamba_tpu/ops/ssd.py. Mamba-2 restricts the decay to a scalar
per head, ``exp(dt[t, h] * A[h])``, so the sequence mix is computable chunk
by chunk with matrix products:

    within a chunk of Q steps:
        S[q, k] = C[q] . B[k] * exp(s[q] - s[k]) * dt[k]   (q >= k)
        Y_intra = S @ X
    across chunks (a short sequential pass over L / Q states):
        state' = exp(sum dtA) * state + sum_k exp(s_last - s[k]) dt[k] B[k] X[k]
        Y_inter[q] = exp(s[q]) * C[q] . state_prev

Shapes, as in the JAX package (heads H, head dim P, groups G dividing H,
state N):

    x  (B, L, H, P)    dt (B, L, H)     A (H,) negative
    B  (B, L, G, N)    C  (B, L, G, N)  D (H,) or None
    z  (B, L, H, P) or None              state (B, H, P, N) float32

The decay logits, their cumsums and the state are fp32; the big contractions
take ``x.dtype`` operands (bf16 in, fp32 sums), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from videomamba_tpu_torch.ops.kernels.scan import softplus

Tensor = torch.Tensor

DEFAULT_CHUNK_SIZE = 64


def _prepare_dt(dt: Tensor, dt_bias: Optional[Tensor], dt_softplus: bool) -> Tensor:
    """Bias + softplus in float32 (the selective scan's convention)."""
    dt = dt.float()
    if dt_bias is not None:
        dt = dt + dt_bias.float()
    if dt_softplus:
        dt = softplus(dt)
    return dt


def _expand_groups(t: Tensor, nheads: int) -> Tensor:
    """(B, ..., G, N) -> (B, ..., H, N); heads are contiguous within a group."""
    g = t.shape[-2]
    if g == nheads:
        return t
    return t.repeat_interleave(nheads // g, dim=-2)


def _finish(y: Tensor, x: Tensor, D: Optional[Tensor], z: Optional[Tensor],
            out_dtype: torch.dtype) -> Tensor:
    if D is not None:
        d = D.float()
        if d.ndim == 1:  # (H,) -> broadcast over P
            d = d[:, None]
        y = y + d * x.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(out_dtype)


def _contract(eq: str, a: Tensor, b: Tensor, cdt: torch.dtype) -> Tensor:
    """einsum of ``a`` and ``b`` rounded to ``cdt``, summed in fp32, the
    result in ``cdt``: a bf16 contraction with fp32 accumulation."""
    return torch.einsum(eq, a.to(cdt).float(), b.to(cdt).float()).to(cdt)


def ssd_ref(
    x: Tensor,
    dt: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor] = None,
    z: Optional[Tensor] = None,
    dt_bias: Optional[Tensor] = None,
    dt_softplus: bool = True,
    initial_state: Optional[Tensor] = None,
    return_last_state: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Sequential oracle: the single-step recurrence over time, fp32."""
    bsz, seqlen, nheads, hdim = x.shape
    n = B.shape[-1]
    dt_p = _prepare_dt(dt, dt_bias, dt_softplus)  # (B, L, H)
    A32 = A.float()
    Bh = _expand_groups(B.float(), nheads)  # (B, L, H, N)
    Ch = _expand_groups(C.float(), nheads)
    x32 = x.float()
    h = (initial_state.float() if initial_state is not None
         else x32.new_zeros((bsz, nheads, hdim, n)))
    ys = []
    for t in range(seqlen):
        dA = torch.exp(dt_p[:, t] * A32)  # (B, H)
        h = dA[:, :, None, None] * h + (
            (dt_p[:, t, :, None] * x32[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else x32.new_zeros(x32.shape)
    y = _finish(y, x32, D, z, x.dtype)
    if return_last_state:
        return y, h
    return y


def ssd_chunked(
    x: Tensor,
    dt: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    D: Optional[Tensor] = None,
    z: Optional[Tensor] = None,
    dt_bias: Optional[Tensor] = None,
    dt_softplus: bool = True,
    initial_state: Optional[Tensor] = None,
    return_last_state: bool = False,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    method: str = "chunked",
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Chunked SSD: matrix products within chunks and a short state pass
    across them (:func:`ssd_core_chunked`), then the D skip and the gate.

    ``method="ref"`` runs the core as the sequential oracle instead;
    ``method="pallas"`` runs the bare-scan kernel K11
    (ops/kernels/ssd_core.py, its plain version on CPU tensors; under
    autograd its backward), as the JAX package's ``ssd_core_pallas``.
    """
    if method not in ("chunked", "ref", "pallas"):
        raise ValueError(f"ssd_chunked method {method!r}: use 'chunked', 'ref' or 'pallas'")
    dt_p = _prepare_dt(dt, dt_bias, dt_softplus)
    if method == "pallas":
        # Imported here: the kernel module builds on this one.
        from videomamba_tpu_torch.ops.kernels.ssd_core import ssd_core_pallas

        y, h_last = ssd_core_pallas(x, dt_p, A, B, C, initial_state, chunk_size)
    elif method == "ref":
        y, h_last = ssd_ref(x, dt_p, A, B, C, dt_softplus=False,
                            initial_state=initial_state, return_last_state=True)
        y = y.float()
    else:
        y, h_last = ssd_core_chunked(x, dt_p, A, B, C, initial_state,
                                     chunk_size=chunk_size)
    y = _finish(y, x.float(), D, z, x.dtype)
    if return_last_state:
        return y, h_last
    return y


def ssd_core_chunked(
    x: Tensor,
    dt_p: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    initial_state: Optional[Tensor],
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> Tuple[Tensor, Tensor]:
    """The bare chunked recurrence: post-softplus ``dt_p`` in, no D/z
    epilogue. Returns (y fp32 (B, L, H, P), h_last fp32 (B, H, P, N))."""
    bsz, seqlen, nheads, hdim = x.shape
    n = B.shape[-1]
    q = int(chunk_size)
    pad = (-seqlen) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt_p, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    lp = seqlen + pad
    nc = lp // q

    cdt = x.dtype  # compute dtype of the big contractions
    xc = x.reshape(bsz, nc, q, nheads, hdim)
    dtc = dt_p.float().reshape(bsz, nc, q, nheads)
    Bc = B.reshape(bsz, nc, q, -1, n)
    Cc = C.reshape(bsz, nc, q, -1, n)

    # Decay cumsums (fp32; differences are <= 0 so every exp is <= 1).
    s = torch.cumsum(dtc * A.float(), dim=2)  # (B, C, Q, H) inclusive

    # Intra-chunk: Y[q'] = sum_{k<=q'} (C[q'].B[k]) exp(s[q']-s[k]) dt[k] X[k].
    cb = _contract("bcqgn,bckgn->bcgqk", Cc, Bc, cdt)  # (B, C, G, Q, Q)
    ngroups = cb.shape[2]
    if ngroups != nheads:
        cb = cb.repeat_interleave(nheads // ngroups, dim=2)  # (B, C, H, Q, Q)
    seg = s[:, :, :, None, :] - s[:, :, None, :, :]  # (B, C, Q, Q, H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # Mask before the exp: the acausal half has seg > 0.
    seg = seg.masked_fill(~causal[None, None, :, :, None], float("-inf"))
    m = cb * torch.exp(seg).movedim(-1, 2).to(cdt)  # (B, C, H, Q, Q)
    m = m * dtc.to(cdt).permute(0, 1, 3, 2)[:, :, :, None, :]  # dt[k]
    y_intra = _contract("bchqk,bckhp->bcqhp", m, xc, cdt)

    # Per-chunk final states: S_c = sum_k exp(s_last - s[k]) dt[k] B[k] X[k].
    decay_last = torch.exp(s[:, :, -1:, :] - s)  # (B, C, Q, H)
    Bh = _expand_groups(Bc, nheads)  # (B, C, Q, H, N)
    xw = xc.to(cdt) * (dtc * decay_last).to(cdt)[..., None]
    S = _contract("bcqhp,bcqhn->bchpn", xw, Bh, cdt).float()

    # Cross-chunk state recurrence (the only sequential part).
    chunk_decay = torch.exp(s[:, :, -1, :])  # (B, C, H)
    h = (initial_state.float() if initial_state is not None
         else x.new_zeros((bsz, nheads, hdim, n), dtype=torch.float32))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)  # the state entering chunk c
        h = chunk_decay[:, c, :, None, None] * h + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B, C, H, P, N)

    # Inter-chunk contribution: Y[q'] += exp(s[q']) C[q'] . h_prev.
    Ch = _expand_groups(Cc, nheads)  # (B, C, Q, H, N)
    cw = Ch.float() * torch.exp(s)[..., None]
    y_inter = _contract("bcqhn,bchpn->bcqhp", cw, h_prev, cdt)

    y = (y_intra + y_inter).float().reshape(bsz, lp, nheads, hdim)
    return y[:, :seqlen], h


def ssd_state_update(
    state: Tensor,
    x_t: Tensor,
    dt_t: Tensor,
    A: Tensor,
    B_t: Tensor,
    C_t: Tensor,
    D: Optional[Tensor] = None,
    z_t: Optional[Tensor] = None,
    dt_bias: Optional[Tensor] = None,
    dt_softplus: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Single-token SSD step. state (B, H, P, N) fp32; x_t (B, H, P); dt_t
    (B, H); B_t, C_t (B, G, N); z_t (B, H, P) or None. Returns (y_t (B, H,
    P) in x_t.dtype, new_state (B, H, P, N) fp32)."""
    nheads = x_t.shape[1]
    dt32 = dt_t.float()
    if dt_bias is not None:
        dt32 = dt32 + dt_bias.float()
    if dt_softplus:
        dt32 = softplus(dt32)
    dA = torch.exp(dt32 * A.float())  # (B, H)
    Bh = _expand_groups(B_t.float(), nheads)  # (B, H, N)
    Ch = _expand_groups(C_t.float(), nheads)
    x32 = x_t.float()
    new_state = dA[:, :, None, None] * state.float() + (
        (dt32[:, :, None] * x32)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    if D is not None:
        d = D.float()
        if d.ndim == 1:
            d = d[:, None]
        y = y + d * x32
    if z_t is not None:
        y = y * F.silu(z_t.float())
    return y.to(x_t.dtype), new_state
