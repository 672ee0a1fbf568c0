"""Sequence parallelism: the selective scan and the SSD scan over time shards.

Port of videomamba_tpu/parallel/sequence.py. The recurrence is first-order
linear, so it shards over time across ranks:

1. each rank scans its slice from a zero state: (y_local, h_local) (K1 for
   Mamba-1, ``selective_scan_bld(method="kernel")``; the chunked SSD, or K11
   with ``method="pallas"``, for Mamba-2);
2. a segment's total decay has a closed form, exp(A * sum_t delta_t);
3. an all-gather of the K (segment decay, h_local) pairs and their
   exclusive combine give each rank its entry state h0_k (and every rank
   the state after the last segment);
4. the local outputs are corrected in closed form, y_t += C_t . (exp(A *
   cumsum(delta)_t) h0_k), then the D skip and the silu(z) gate.

One all-gather of 2 (B, D, N) tensors a layer (Mamba-2: (B, H) and (B, H,
P, N)), whatever the length. The mixers add the conv halo: each rank's
last d_conv conv inputs go to the next rank (rank 0 takes the streaming
conv_state or zeros).

Each rank's arithmetic lives in plain tensor functions (:func:`local_scan`,
:func:`combine_segments`, :func:`scan_correction`, :func:`scan_epilogue`
and their SSD twins) that the distributed functions call around their
collectives. The ``*_shards`` functions run the same code for every shard
of a full-length input in one process, the collectives replaced by a stack
and a shift of the list: a card runs a K-way split through the kernels
that K ranks would launch.

Differentiation: the all-gather's backward is a reduce-scatter of the
cotangents, the halo's sends each cotangent back to the rank it came from
(utils/distributed.py). The gradients of parameters and of
``initial_state`` that a rank's backward gives are its share: the caller's
reduction sums them over the group (a data-parallel reduction over the sp
ranks does; the tests all-reduce them). Every rank must run the backward:
the combine keeps the JAX ``where`` form, so each rank's graph reaches both
collectives.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from videomamba_tpu_torch.ops.kernels.scan import softplus
from videomamba_tpu_torch.ops.selective_scan import selective_scan_bld
from videomamba_tpu_torch.ops.ssd import _expand_groups, _finish, _prepare_dt, ssd_chunked
from videomamba_tpu_torch.utils.distributed import (
    gather_stacked,
    get_rank,
    get_world_size,
    shift_to_next,
)

Tensor = torch.Tensor
LayerState = Tuple[Tensor, Tensor]


# ------------------------------------------------------ per-rank arithmetic

def prepare_delta(delta: Tensor, delta_bias: Optional[Tensor], delta_softplus: bool) -> Tensor:
    """delta + bias, then softplus, in fp32 (the local scan, the segment
    decay and the correction all read this one tensor)."""
    d = delta.float()
    if delta_bias is not None:
        d = d + delta_bias.float()
    return softplus(d) if delta_softplus else d


def local_scan(u: Tensor, delta32: Tensor, A: Tensor, B: Tensor, C: Tensor,
               method: str = "kernel") -> Tuple[Tensor, Tensor, Tensor]:
    """Steps 1-2 on one shard: the scan from a zero state with no D skip and
    no gate (K1 with ``method="kernel"``, its plain version on a CPU tensor)
    on fp32 operands, and the segment's decay. delta32 is post-softplus.
    Returns (y_local fp32 (B, L, D), h_local (B, D, N), decay (B, D, N))."""
    A32 = A.float()
    y, h = selective_scan_bld(u.float(), delta32, A32, B.float(), C.float(),
                              return_last_state=True, method=method)
    decay = torch.exp(A32[None] * delta32.sum(1)[:, :, None])
    return y, h, decay


def combine_segments(decays: Tensor, h_locals: Tensor, h_init: Tensor,
                     k: int) -> Tuple[Tensor, Tensor]:
    """Step 3 for rank ``k`` over the stacked K segments (decays broadcast
    against the states): the exclusive combine gives h0_k, the state
    entering segment k, and the full one the state after segment K - 1.
    The JAX ``where`` form: segments at or after k pass through, so the
    gradient reaches every gathered pair (zero where unused)."""
    before = torch.arange(decays.shape[0], device=h_init.device) < k  # no host copy
    h0 = h_init
    for i in range(decays.shape[0]):
        h0 = torch.where(before[i], decays[i] * h0 + h_locals[i], h0)
    h_last = h_init
    for i in range(decays.shape[0]):
        h_last = decays[i] * h_last + h_locals[i]
    return h0, h_last


def scan_correction(delta32: Tensor, C: Tensor, A: Tensor, h0: Tensor,
                    chunk: int = 256) -> Tensor:
    """Step 4's closed form, y_t += C_t . (exp(A * cumsum(delta)_t) h0), in
    chunks of ``chunk`` steps to bound the (B, chunk, N, D) transient.
    Returns (B, L, D) fp32."""
    cumdelta = torch.cumsum(delta32, dim=1)
    At = A.float().t()[None, None]  # (1, 1, N, D)
    h0t = h0.transpose(1, 2)[:, None]  # (B, 1, N, D)
    parts = []
    for lo in range(0, delta32.shape[1], chunk):
        decay = torch.exp(cumdelta[:, lo:lo + chunk, None, :] * At)  # (B, c, N, D)
        parts.append(torch.einsum("bcnd,bcn->bcd", decay * h0t, C[:, lo:lo + chunk].float()))
    return torch.cat(parts, dim=1)


def scan_epilogue(y: Tensor, u: Tensor, D: Optional[Tensor], z: Optional[Tensor]) -> Tensor:
    """The D skip and the silu(z) gate in fp32; the output in u.dtype."""
    if D is not None:
        y = y + u.float() * D.float()
    if z is not None:
        zf = z.float()
        y = y * (zf * torch.sigmoid(zf))
    return y.to(u.dtype)


def local_ssd(x: Tensor, dt_p: Tensor, A: Tensor, B: Tensor, C: Tensor, chunk_size: int,
              method: str = "chunked") -> Tuple[Tensor, Tensor, Tensor]:
    """The SSD twin of :func:`local_scan`: ``ssd_chunked`` from a zero state
    with no D skip and no gate on fp32 operands (K11 with
    ``method="pallas"``), dt_p post-softplus. Returns (y_local fp32 (B, L,
    H, P), h_local (B, H, P, N), decay (B, H): a scalar a head)."""
    A32 = A.float()
    y, h = ssd_chunked(x.float(), dt_p, A32, B.float(), C.float(), dt_softplus=False,
                       return_last_state=True, chunk_size=chunk_size, method=method)
    return y, h, torch.exp(A32[None] * dt_p.sum(1))


def ssd_correction(dt_p: Tensor, C: Tensor, A: Tensor, h0: Tensor) -> Tensor:
    """y[b, l, h] += exp(A_h cumsum(dt)[b, l, h]) (C[b, l, g(h)] . h0[b, h]):
    one product, no transient to bound. Returns (B, L, H, P) fp32."""
    decay_t = torch.exp(torch.cumsum(dt_p, dim=1) * A.float()[None, None])
    Ch = _expand_groups(C.float(), h0.shape[1])
    return decay_t[..., None] * torch.einsum("blhn,bhpn->blhp", Ch, h0)


# -------------------------------------------------- the collectives' seams

class _Group:
    """One shard a process: this rank's, collectives over ``group``."""

    def __init__(self, group):
        self.group = group
        self.first = get_rank(group)
        self.num = get_world_size(group)

    def shift(self, ts: List[Tensor]) -> List[Tensor]:
        return [shift_to_next(ts[0], self.group)]

    def stack(self, ts: List[Tensor]) -> Tensor:
        return gather_stacked(ts[0], self.group)


class _Local:
    """Every shard in this process: the gather is a stack, the halo a
    shift of the list."""

    def __init__(self, num: int):
        self.first, self.num = 0, num

    def shift(self, ts: List[Tensor]) -> List[Tensor]:
        return [torch.zeros_like(ts[0])] + list(ts[:-1])

    def stack(self, ts: List[Tensor]) -> Tensor:
        return torch.stack(ts)


def _scan(comm, us, deltas, A, Bs, Cs, D, zs, delta_bias, delta_softplus, initial_state,
          method, correction_chunk):
    d32 = [prepare_delta(d, delta_bias, delta_softplus) for d in deltas]
    loc = [local_scan(u, d, A, b, c, method) for u, d, b, c in zip(us, d32, Bs, Cs)]
    decays = comm.stack([t[2] for t in loc])
    h_locs = comm.stack([t[1] for t in loc])
    u0 = us[0]
    h_init = (initial_state.float() if initial_state is not None
              else u0.new_zeros((u0.shape[0], u0.shape[2], A.shape[1]), dtype=torch.float32))
    outs = []
    for j, (u, d, c, z, (y, _, _)) in enumerate(zip(us, d32, Cs, zs, loc)):
        h0, h_last = combine_segments(decays, h_locs, h_init, comm.first + j)
        y = y + scan_correction(d, c, A, h0, correction_chunk)
        outs.append(scan_epilogue(y, u, D, z))
    return outs, h_last


def _ssd(comm, xs, dts, A, Bs, Cs, D, zs, dt_bias, dt_softplus, initial_state, chunk_size,
         method):
    dtp = [_prepare_dt(dt, dt_bias, dt_softplus) for dt in dts]
    loc = [local_ssd(x, d, A, b, c, chunk_size, method) for x, d, b, c in zip(xs, dtp, Bs, Cs)]
    decays = comm.stack([t[2] for t in loc])[..., None, None]
    h_locs = comm.stack([t[1] for t in loc])
    x0 = xs[0]
    h_init = (initial_state.float() if initial_state is not None
              else x0.new_zeros((x0.shape[0], x0.shape[2], x0.shape[3], Bs[0].shape[-1]),
                                dtype=torch.float32))
    outs = []
    for j, (x, d, c, z, (y, _, _)) in enumerate(zip(xs, dtp, Cs, zs, loc)):
        h0, h_last = combine_segments(decays, h_locs, h_init, comm.first + j)
        outs.append(_finish(y + ssd_correction(d, c, A, h0), x, D, z, x.dtype))
    return outs, h_last


# ------------------------------------------------------------------- scans

def sequence_parallel_scan(
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
    group=None,
    method: str = "kernel",
    correction_chunk: int = 256,
) -> Tuple[Tensor, Tensor]:
    """Selective scan over a time-sharded sequence; every rank of ``group``
    (default: the world) calls it with its slice.

    Args are this rank's shards in ``selective_scan_bld``'s layouts (u,
    delta, z: (B, L_loc, D); B, C: (B, L_loc, N); A: (D, N);
    initial_state: (B, D, N), read on rank 0, the same everywhere
    recommended). ``method`` is the local scan's: "kernel" (K1, K5 in the
    backward) or "ref".

    Returns (out_local (B, L_loc, D) in u.dtype, h_last (B, D, N) fp32: the
    state after the whole sequence, on every rank).
    """
    outs, h_last = _scan(_Group(group), [u], [delta], A, [B], [C], D, [z], delta_bias,
                         delta_softplus, initial_state, method, correction_chunk)
    return outs[0], h_last


def _split(t: Optional[Tensor], num: int) -> List[Optional[Tensor]]:
    if t is None:
        return [None] * num
    if t.shape[1] % num:
        raise ValueError(f"length {t.shape[1]} does not split into {num} shards")
    return list(t.chunk(num, dim=1))


def sequence_parallel_scan_shards(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                                  delta_softplus=False, initial_state=None, num_shards=2,
                                  method="kernel", correction_chunk=256):
    """:func:`sequence_parallel_scan`'s arithmetic for ``num_shards`` time
    shards of full-length inputs in one process. Returns (out (B, L, D),
    h_last)."""
    outs, h_last = _scan(_Local(num_shards), _split(u, num_shards), _split(delta, num_shards),
                         A, _split(B, num_shards), _split(C, num_shards), D,
                         _split(z, num_shards), delta_bias, delta_softplus, initial_state,
                         method, correction_chunk)
    return torch.cat(outs, dim=1), h_last


def sequence_parallel_ssd(
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
    group=None,
    chunk_size: int = 64,
    method: str = "chunked",
) -> Tuple[Tensor, Tensor]:
    """SSD scan over a time-sharded sequence; every rank of ``group`` calls
    it with its slice, in ``ssd_chunked``'s layouts (x: (B, L_loc, H, P);
    dt: (B, L_loc, H); A: (H,); B, C: (B, L_loc, G, N); initial_state: (B,
    H, P, N), read on rank 0). ``method``: "chunked" (the JAX default),
    "ref", or "pallas" (K11 forward and backward).

    Returns (out_local (B, L_loc, H, P) in x.dtype, h_last (B, H, P, N)
    fp32 on every rank).
    """
    outs, h_last = _ssd(_Group(group), [x], [dt], A, [B], [C], D, [z], dt_bias, dt_softplus,
                        initial_state, chunk_size, method)
    return outs[0], h_last


def sequence_parallel_ssd_shards(x, dt, A, B, C, D=None, z=None, dt_bias=None,
                                 dt_softplus=True, initial_state=None, num_shards=2,
                                 chunk_size=64, method="chunked"):
    """:func:`sequence_parallel_ssd`'s arithmetic for ``num_shards`` time
    shards in one process. Returns (out (B, L, H, P), h_last)."""
    outs, h_last = _ssd(_Local(num_shards), _split(x, num_shards), _split(dt, num_shards), A,
                        _split(B, num_shards), _split(C, num_shards), D, _split(z, num_shards),
                        dt_bias, dt_softplus, initial_state, chunk_size, method)
    return torch.cat(outs, dim=1), h_last


# ------------------------------------------------------------------ mixers

def _check_shards(hiddens: Sequence[Tensor], w: int) -> None:
    for h in hiddens:
        if h.shape[1] < w:
            raise ValueError(f"sequence-parallel shard length {h.shape[1]} must be >= d_conv {w}")


def _halo(comm, windows: List[Tensor], conv_state: Optional[Tensor]) -> List[Tensor]:
    """Each shard's carried conv window: its predecessor's last inputs; rank
    0's is ``conv_state`` when given (a ``where``, so rank 0's graph keeps
    the shift)."""
    prev = comm.shift(windows)
    if conv_state is not None and comm.first == 0:
        first = torch.ones((), dtype=torch.bool, device=prev[0].device)
        prev[0] = torch.where(first, conv_state.to(prev[0].dtype), prev[0])
    return prev


def _states(comm, windows, h_last, conv_state, ssm_state, return_state, return_ssm_state):
    """The mixers' returned states: the last shard's conv window and h_last,
    in the incoming states' dtypes; None when neither is asked for."""
    new_ssm = h_last.to(ssm_state.dtype) if ssm_state is not None else h_last
    if return_ssm_state:
        return new_ssm
    if not return_state:
        return None
    new_conv = comm.stack(windows)[comm.num - 1]
    if conv_state is not None:
        new_conv = new_conv.to(conv_state.dtype)
    return new_conv, new_ssm


def _mixer(comm, mixer, hiddens, state, return_state, ssm_state, return_ssm_state, method):
    conv_state = None
    if state is not None:
        conv_state, ssm_state = state
    w = mixer.d_conv
    _check_shards(hiddens, w)
    xs, zs = [], []
    for h in hiddens:
        xz = h @ mixer.in_proj.weight.t()
        if mixer.in_proj.bias is not None:
            xz = xz + mixer.in_proj.bias
        x, z = xz.chunk(2, dim=-1)
        xs.append(x)
        zs.append(z)
    windows = [x[:, -w:].transpose(1, 2) for x in xs]
    prevs = _halo(comm, windows, conv_state)
    r, n = mixer.dt_rank, mixer.d_state
    convs, dts, Bs, Cs = [], [], [], []
    for x, prev in zip(xs, prevs):
        conv_out = causal_conv1d(x, mixer.conv1d.weight.squeeze(1).t(), mixer.conv1d.bias,
                                 activation="silu", initial_state=prev)
        x_dbl = conv_out @ mixer.x_proj.weight.t()
        convs.append(conv_out)
        dts.append(x_dbl[..., :r] @ mixer.dt_proj.weight.t())
        Bs.append(x_dbl[..., r:r + n])
        Cs.append(x_dbl[..., r + n:])
    if method is None:
        method = "kernel" if mixer.use_fast_path else "ref"
    ys, h_last = _scan(comm, convs, dts, -torch.exp(mixer.A_log.float()), Bs, Cs,
                       mixer.D.float(), zs, mixer.dt_proj.bias.float(), True, ssm_state, method,
                       256)
    outs = []
    for y in ys:
        out = y @ mixer.out_proj.weight.t()
        if mixer.out_proj.bias is not None:
            out = out + mixer.out_proj.bias
        outs.append(out)
    return outs, _states(comm, windows, h_last, conv_state, ssm_state, return_state,
                         return_ssm_state)


def _mixer_m2(comm, mixer, hiddens, state, return_state, ssm_state, return_ssm_state, method):
    conv_state = None
    if state is not None:
        conv_state, ssm_state = state
    w = mixer.d_conv
    _check_shards(hiddens, w)
    zs, xbcs, dts = [], [], []
    for h in hiddens:
        zxbcdt = h @ mixer.in_proj.weight.t()
        if mixer.in_proj.bias is not None:
            zxbcdt = zxbcdt + mixer.in_proj.bias
        z, xbc, dt = mixer._split_zxbcdt(zxbcdt)
        zs.append(z)
        xbcs.append(xbc)
        dts.append(dt)
    windows = [xbc[:, -w:].transpose(1, 2) for xbc in xbcs]
    prevs = _halo(comm, windows, conv_state)
    hh, p, g, n = mixer.nheads, mixer.headdim, mixer.ngroups, mixer.d_state
    xs, Bs, Cs = [], [], []
    for xbc, prev in zip(xbcs, prevs):
        conv = causal_conv1d(xbc, mixer.conv1d.weight.squeeze(1).t(), mixer.conv1d.bias,
                             activation="silu", initial_state=prev)
        x, B, C = mixer._split_xbc(conv)
        bsz, length = x.shape[:2]
        xs.append(x.reshape(bsz, length, hh, p))
        Bs.append(B.reshape(bsz, length, g, n))
        Cs.append(C.reshape(bsz, length, g, n))
    ys, h_last = _ssd(comm, xs, dts, -torch.exp(mixer.A_log.float()), Bs, Cs, mixer.D,
                      [None] * len(xs), mixer.dt_bias, True, ssm_state, mixer.chunk_size,
                      method)
    outs = [mixer._gate_and_project(y.reshape(y.shape[0], y.shape[1], mixer.d_inner), z)
            for y, z in zip(ys, zs)]
    return outs, _states(comm, windows, h_last, conv_state, ssm_state, return_state,
                         return_ssm_state)


def _returns(out, states):
    return out if states is None else (out, states)


def sequence_parallel_mixer(mixer, hidden_states: Tensor, group=None,
                            state: Optional[LayerState] = None, return_state: bool = False,
                            ssm_state: Optional[Tensor] = None, return_ssm_state: bool = False,
                            method: Optional[str] = None):
    """A Mamba-1 mixer (models/mamba.py ``Mamba``) over a time-sharded
    sequence: every rank of ``group`` calls it with its (B, L/K, d_model)
    slice. in_proj, the plain causal conv, x_proj, dt_proj and out_proj run
    on the shard; the conv halo rides one hop to the next rank and the
    recurrence is :func:`sequence_parallel_scan` (K1; ``method`` defaults to
    "kernel" on the mixer's fast path, else "ref").

    ``Mamba.__call__``'s contract on the shard: ``out``, or ``(out,
    (conv_state, ssm_state))`` with ``return_state`` (the whole sequence's
    states on every rank: the last shard's conv window), or ``(out,
    ssm_state)`` with ``return_ssm_state``. A shard shorter than d_conv
    raises. Parameter gradients are this rank's share (the caller sums
    them over the group)."""
    outs, states = _mixer(_Group(group), mixer, [hidden_states], state, return_state,
                          ssm_state, return_ssm_state, method)
    return _returns(outs[0], states)


def sequence_parallel_mixer_m2(mixer, hidden_states: Tensor, group=None,
                               state: Optional[LayerState] = None, return_state: bool = False,
                               ssm_state: Optional[Tensor] = None,
                               return_ssm_state: bool = False):
    """The Mamba-2 twin of :func:`sequence_parallel_mixer` (models/mamba2.py
    ``Mamba2``): the conv halo over the raw [x B C] slab, the recurrence
    :func:`sequence_parallel_ssd` with its default method, "chunked", as in
    the JAX package (K11 only on request:
    :func:`sequence_parallel_mixer_m2_shards` or
    ``sequence_parallel_ssd(method="pallas")``)."""
    outs, states = _mixer_m2(_Group(group), mixer, [hidden_states], state, return_state,
                             ssm_state, return_ssm_state, "chunked")
    return _returns(outs[0], states)


def sequence_parallel_mixer_shards(mixer, hidden_states: Tensor, num_shards: int,
                                   state: Optional[LayerState] = None,
                                   return_state: bool = False, method: Optional[str] = None):
    """:func:`sequence_parallel_mixer`'s arithmetic for ``num_shards`` time
    shards of a full-length (B, L, d_model) input in one process, through
    the kernels K ranks would launch. Returns out (B, L, d_model), or (out,
    states) with ``return_state``."""
    outs, states = _mixer(_Local(num_shards), mixer, _split(hidden_states, num_shards), state,
                          return_state, None, False, method)
    return _returns(torch.cat(outs, dim=1), states)


def sequence_parallel_mixer_m2_shards(mixer, hidden_states: Tensor, num_shards: int,
                                      state: Optional[LayerState] = None,
                                      return_state: bool = False, method: str = "chunked"):
    """:func:`sequence_parallel_mixer_m2`'s arithmetic for ``num_shards``
    shards in one process; ``method`` is the SSD's ("pallas": K11)."""
    outs, states = _mixer_m2(_Local(num_shards), mixer, _split(hidden_states, num_shards),
                             state, return_state, None, False, method)
    return _returns(torch.cat(outs, dim=1), states)
