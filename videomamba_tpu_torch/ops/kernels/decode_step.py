"""K9 and K15: one decode token through the whole layer stack, CUDA for Hopper.

K9 (:func:`decode_stack`) is the Mamba-1 stack, K15 (:func:`decode_stack_m2`,
further down) the Mamba-2 one.

Replaces videomamba_tpu/ops/pallas/decode_step.py (decode_stack_pallas,
``_decode_kernel``): for a token (B, E) and each of the K layers, residual
add, RMS / LayerNorm, in_proj, the rolling conv and SiLU, x_proj, dt_proj
and softplus, the single-step state update ``y = C h + D x``, the silu(z)
gate and out_proj; the stacked conv and SSM states advance by one token.
It returns (hidden, residual) in fp32 for the model's final norm.

The TPU kernel's grid is the layer axis with each layer's weights
double-buffered into VMEM. csrc/decode_step.cu is one persistent launch a
token (a block on every SM, :data:`PHASES_PER_LAYER` phases a layer between
grid barriers): each block copies its slice of a phase's weights into
shared memory two phases ahead, under the grid barriers, never waiting for
the activations the phase reads, and uses each weight for every row of a
batch tile, so every weight crosses device memory once a token at any
batch. :func:`decode_plan` is the schedule the
kernel runs (batch tile, row slices, x_proj's K pieces, the warps' split,
the shared memory layout); the C entry takes it as ints. The conv and SSM
states are updated in place on the kernel route (the session owns them); the
plain version returns new ones. :class:`DecodeLaunch` holds a validated
launch's buffers, so ``DecodeSession`` validates and plans once.

Rounding (decode_step.py:134-184, with the TPU's ``precision=DEFAULT`` as
interpret mode computes it): fp32 weights take fp32 products; bf16 weights
round ``normed``, the conv output, ``x_dbl`` and ``y`` to bf16 before their
products, with fp32 sums. The states are stored in their own dtype.

Widths: the kernel's rows are 16-byte aligned, so a d_model or d_inner
that is not a multiple of 8 runs at :func:`decode_width` (the next multiple
of 8): the launch pads the weight stacks once with zero rows and columns,
the token and the states with zero lanes, and the norm divides by the true
d_model. A zero channel stays zero through the conv, the scan and the gate,
so the padding is exact.

Layouts (the contract's, stacked on depth; the TPU's lane-major state swap
is not ported): norm_w, norm_b (K, E) fp32; in_proj_w (K, 2Di, E),
out_proj_w (K, E, Di), conv_w (K, Di, W), x_proj_w (K, R + 2N, Di),
dt_proj_w (K, Di, R) in the weight dtype; conv_b, dt_bias, D (K, Di) and A
(K, Di, N) fp32; conv_states (K, B, Di, W), ssm_states (K, B, Di, N).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels.mixer_bwd import _rnd
from videomamba_tpu_torch.ops.kernels.scan import softplus
from videomamba_tpu_torch.ops.norm import layer_norm, rms_norm

Tensor = torch.Tensor

PHASES_PER_LAYER = 4     # K9: in, x_proj, state, out; grid barriers between them
PHASES_PER_LAYER_M2 = 3  # K15: in, state, out
LAUNCHES_PER_TOKEN = 1   # CUDA launches a token (each stack, whatever its depth)
SMEM_BYTES = 232448      # shared memory one block may take on Hopper (227 KB)
REF_SMS = 132            # the gates' reference card: an H100 SXM
ROW_PAD = 16             # bytes after each weight row in shared memory
ACT_PAD = 8              # floats after each staged activation row
BATCH_TILES = (16, 8, 1)  # rows staged a pass (the kernel's template values)
MMA_MIN_BATCH = 4        # bf16 weights take mma.sync from this batch on (measured)
PLAN_FIELDS = ("bt", "wtot", "off_act", "off_red", "off_res", "off_misc", "off_bar", "smem", "lda",
               "in_rb", "in_rw", "in_mma", "xp_kp", "xp_kw", "xp_rb", "xp_rw",
               "out_rb", "out_rw", "out_mma", "in_cap", "out_cap", "xp_rg")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up(a: int, m: int) -> int:
    return _cdiv(a, m) * m


def block_span(n: int, grid: int, j: int) -> Tuple[int, int]:
    """Units [lo, hi) of n that block j of ``grid`` owns (the kernel's
    ``block_span``): a balanced split, every unit once."""
    return n * j // grid, n * (j + 1) // grid


def warp_split(nrows: int, k: int, bt: int) -> Tuple[int, int]:
    """(row blocks RB, rows a warp RW) of a block's FMA product over nrows
    weight rows of K columns and a batch tile of bt rows: the 8 warps are RB
    row blocks x 8 / RB splits of K. The least shared-memory and FMA issue
    time: a pass over 4 columns loads RW weight and bt activation vectors
    (4 cycles each for a warp) for 4 RW bt multiply-adds (a quarter cycle
    each), over the padded rows; ties go to fewer passes over the rows (each
    ends in a block-wide sum), then to more rows a warp."""
    best = None
    for rb in (1, 2, 4, 8):
        for rw in (1, 2, 3, 4):
            padded = _cdiv(nrows, rb * rw) * rb * rw
            lanes = _cdiv(_cdiv(k // 4, 8 // rb), 32) * 32 * (8 // rb)
            key = (padded * lanes * max(4 * (rw + bt), rw * bt) / rw, padded // (rb * rw), -rw)
            if best is None or key < best[0]:
                best = (key, (rb, rw))
    return best[1]


def decode_plan(batch: int, d_model: int, d_inner: int, w_bytes: int, grid: int, *,
                dt_rank: Optional[int] = None, d_state: Optional[int] = None,
                d_proj: Optional[int] = None, nheads: Optional[int] = None,
                s_bytes: int = 4) -> Optional[dict]:
    """The schedule of one decode stack: K9 with ``dt_rank`` and ``d_state``,
    K15 with ``d_proj`` (in_proj's rows, 2Di + 2GN + H), ``nheads`` and
    ``d_state``. ``grid`` blocks (one an SM), weights of ``w_bytes`` and
    states of ``s_bytes`` (4 fp32, 2 bf16). Returns the
    kernel's ints (:data:`PLAN_FIELDS`) and ``grid``, ``units`` (each phase's
    units, split over the blocks by :func:`block_span`), ``slice_bytes``
    (each phase's largest weight slice) and ``scratch`` (fp32 floats of
    activations between phases); None when no batch tile fits shared memory.

    Phases: in (rows of in_proj; rows a block at once ``in_cap``), x_proj
    (K9: units of ``xp_rg`` rows by ``xp_kw`` columns, ``xp_kp`` pieces of
    K whose partial sums the state phase adds in piece order), state (K9:
    groups of 8 channels; K15: groups of 4 (head, p) rows), out (rows of
    out_proj). A phase's weight slice goes
    to one end of the weight area (``wtot`` bytes), the next phase's to the
    other, so ``wtot`` is the largest sum of two consecutive slices."""
    m1 = d_proj is None
    e, di, wb = d_model, d_inner, w_bytes
    m_in = 2 * di if m1 else d_proj
    in_rows, out_rows = _cdiv(m_in, grid), _cdiv(e, grid)
    units = {"in": m_in, "out": e}
    lda = max(e, di) + ACT_PAD
    if m1:
        p = dt_rank + 2 * d_state
        pp = _up(p, 4)  # x_proj's partial-sum rows, 16-byte aligned
        # Units of xp_rg rows by a piece of K, enough for every block; the
        # state phase reads every piece's partial sums, so at large batches
        # the rows split finer and K into fewer pieces.
        xp_rg = 8 if batch <= 16 else 2
        groups = _cdiv(p, xp_rg)
        xp_kp = max(1, min(di // 8, _cdiv(grid, groups)))
        xp_kw = _up(_cdiv(di, xp_kp), 8)
        xp_kp = _cdiv(di, xp_kw)
        xp_units = _cdiv(groups * xp_kp, grid)  # a block's most
        units.update(x_proj=groups * xp_kp, state=_cdiv(di, 8))
        xp_bytes = xp_units * xp_rg * (xp_kw * wb + ROW_PAD)
        nch = 8 * _cdiv(_cdiv(di, 8), grid)  # the state phase's channels a block
        # dt_proj's rows, A, D and dt_bias, then a tile of states
        st_fixed, st_row = _up(nch * dt_rank * wb, 16) + nch * (d_state + 2) * 4, \
            nch * d_state * s_bytes
        # the state phase stages the partial sums in act, x_proj its units' slots
        lda = max(lda, xp_kp * pp, xp_units * (xp_kw + ACT_PAD))
        scratch = batch * (3 * di + xp_kp * pp)  # cy, z, y, partial sums
        misc_row = pp + 2 * nch
        nhp = p_dim = 1
    else:
        two_gn = d_proj - 2 * di - nheads
        xp_kp, xp_kw, xp_bytes, xp_rg = 0, 0, 0, 1
        units.update(state=di // 4)
        nhp = 4 * _cdiv(di // 4, grid)  # the state phase's (head, p) rows a block
        st_fixed, st_row = 0, nhp * d_state * 4  # a tile of fp32 SSD states
        p_dim = di // nheads
        lda = max(lda, 2 * nhp + _up(nhp // p_dim + 2, 4) + 8 + _up(two_gn, 4))
        scratch = batch * (_up(d_proj, 4) + _up(di + two_gn, 4) + di)  # raw, cy, gated
        misc_row = 0
    first = next(bt for bt in reversed(BATCH_TILES) if bt >= min(batch, BATCH_TILES[0]))

    def layout(bt, in_cap, out_cap):
        in_mma = int(wb == 2 and bt >= 8 and batch >= MMA_MIN_BATCH and e % 16 == 0)
        out_mma = int(wb == 2 and bt >= 8 and batch >= MMA_MIN_BATCH and di % 16 == 0)
        in_rb, in_rw = warp_split(in_cap, e, bt)
        out_rb, out_rw = warp_split(out_cap, di, bt)
        xp_rb, xp_rw = warp_split(xp_rg, xp_kw, bt) if m1 else (1, 1)
        bt0 = min(batch, bt)
        in_b = in_cap * (e * wb + ROW_PAD)
        # + R_k's first tile: the block's columns from and to 16-byte boundaries
        out_b = out_cap * (di * wb + ROW_PAD) + bt0 * _up(out_rows + 6, 4) * 4
        st_bytes = st_fixed + bt0 * st_row
        slices = [in_b, xp_bytes, st_bytes, out_b] if m1 else [in_b, st_bytes, out_b]
        wtot = _up(max(a + b for a, b in zip(slices, slices[1:] + slices[:1])), 16)
        red = 8 * bt * (32 if in_mma or out_mma else 4)
        # the sums of a pass; K15's state phase keeps dt, exp(dt A), D a head there
        res = max(in_cap, out_cap, 8 if m1 else 3 * (nhp // p_dim + 2)) * bt
        misc = max(2 * bt, bt * misc_row)
        off_act = wtot
        off_red = _up(off_act + bt * lda * 4, 16)
        off_res = _up(off_red + red * 4, 16)
        off_misc = _up(off_res + res * 4, 16)
        off_bar = _up(off_misc + misc * 4, 16)
        smem = off_bar + 16  # the activation copies' transaction barrier
        if smem > SMEM_BYTES:
            return None
        return dict(bt=bt, wtot=wtot, off_act=off_act, off_red=off_red, off_res=off_res,
                    off_misc=off_misc, off_bar=off_bar, smem=smem, lda=lda, in_rb=in_rb,
                    in_rw=in_rw, in_mma=in_mma, xp_kp=xp_kp, xp_kw=xp_kw, xp_rb=xp_rb,
                    xp_rw=xp_rw, out_rb=out_rb, out_rw=out_rw, out_mma=out_mma,
                    in_cap=in_cap, out_cap=out_cap, xp_rg=xp_rg,
                    slice_bytes=dict(zip(("in", "x_proj", "state", "out") if m1
                                         else ("in", "state", "out"), slices)))

    plan = None
    for bt in (t for t in BATCH_TILES if t <= first):
        plan = layout(bt, in_rows, out_rows)
        if plan is not None:
            break
    in_cap, out_cap = in_rows, out_rows
    while plan is None and (in_cap > 1 or out_cap > 1):  # slices too large to hold whole
        if in_cap * (e * wb + ROW_PAD) >= out_cap * (di * wb + ROW_PAD) and in_cap > 1:
            in_cap -= 1
        elif out_cap > 1:
            out_cap -= 1
        else:
            in_cap -= 1
        plan = layout(1, in_cap, out_cap)
    if plan is None:
        return None
    plan.update(grid=grid, units=units, scratch=scratch,
                phases=PHASES_PER_LAYER if m1 else PHASES_PER_LAYER_M2)
    return plan


def decode_width(n: int) -> int:
    """The width K9 and K15 run a d_model or d_inner of ``n`` at: the next
    multiple of 8 (16-byte weight rows); the lanes past ``n`` are zeros."""
    return _up(n, 8)


def _pad(t: Optional[Tensor], *sizes: int) -> Optional[Tensor]:
    """t with its trailing ``len(sizes)`` axes zero-padded to ``sizes``."""
    if t is None or tuple(t.shape[-len(sizes):]) == sizes:
        return t
    pad = []
    for have, want in zip(reversed(t.shape[-len(sizes):]), reversed(sizes)):
        pad += [0, want - have]
    return F.pad(t, pad).contiguous()


def pad_decode_states(conv_states: Tensor, ssm_states: Tensor,
                      d_inner: int) -> Tuple[Tensor, Tensor]:
    """K9's state stacks (K, B, d_inner, .) at :func:`decode_width`
    (d_inner) channels, zero past d_inner (the tensors themselves when that
    is d_inner)."""
    dip = decode_width(d_inner)
    return tuple(_pad(t, dip, t.shape[-1]) for t in (conv_states, ssm_states))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA card ``index``: the persistent grid (one block each)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_stack_supported(d_model: int, d_inner: int, dt_rank: Optional[int] = None,
                           d_state: int = 16) -> bool:
    """The port's own gate for K9: a schedule at the padded widths
    (:func:`decode_width`) that fits one block's shared memory on the
    reference card with fp32 weights (the larger; a slice too large to hold
    whole is taken in pieces, so only a single weight row or activation row
    of about 100 KB fails). Any batch size. ``dt_rank`` defaults to the
    model's ``ceil(d_model / 16)``."""
    r = _cdiv(d_model, 16) if dt_rank is None else dt_rank
    return decode_plan(1, decode_width(d_model), decode_width(d_inner), 4, REF_SMS, dt_rank=r,
                       d_state=d_state) is not None


class DecodeLaunch:
    """One validated K9 or K15 launch: the buffers the kernel writes
    (hidden, the two residual rows, scratch, the grid barrier and, for
    :func:`phase_ms`, a phase timer), the plan and the C entry's pointer,
    dim and plan arrays. :meth:`run` submits a token with no further checks.
    ``states`` are the (conv, ssm) stacks the kernel advances in place, at
    the model's widths: the caller's own, or trimmed views of the launch's
    zero-padded storage where d_inner is not a multiple of 8, which a caller
    that keeps the states adopts. ``e`` is the true d_model, the last of
    ``dims``; at a padded width ``dims[4]`` the token goes through a
    zero-padded buffer and the outputs come back trimmed."""

    def __init__(self, m2: bool, bsz: int, e: int, dev: torch.device, ops: list, dims: list,
                 plan: dict, floats: tuple, states: Tuple[Tensor, Tensor],
                 timer: bool = False):
        f32 = dict(dtype=torch.float32, device=dev)
        self.m2, self.plan, self.depth, self.dev, self.e = m2, plan, dims[2], dev, e
        self.states = states
        ep = dims[4]
        self.tok = torch.zeros((bsz, ep), **f32) if ep != e else None
        self.hidden = torch.empty((bsz, ep), **f32)
        self.res = (torch.empty((bsz, ep), **f32), torch.empty((bsz, ep), **f32))
        self.scratch = torch.empty((plan["scratch"],), **f32)
        # The grid barrier's counter and its value at a launch's start, both
        # kept on the card by the kernel (a replayed CUDA graph stays right).
        self.bar = torch.zeros((4,), dtype=torch.int32, device=dev)
        phases = plan["phases"] * self.depth
        self.timer = torch.zeros((phases + 1,), dtype=torch.int64, device=dev) if timer else None
        self._ops = ops  # the operands stay alive while the launch may run
        ptrs = [None, self.hidden, *self.res, *ops, self.scratch, self.bar, self.timer]
        self._ptrs = (ctypes.c_void_p * len(ptrs))(*(_build.ptr(t) for t in ptrs))
        self._dims = (ctypes.c_int * len(dims))(*dims)
        self._plan = (ctypes.c_int * len(PLAN_FIELDS))(*(plan[k] for k in PLAN_FIELDS))
        lib = _build.library()
        self._entry = lib.vmt_decode_stack_m2 if m2 else lib.vmt_decode_stack
        self._args = (ctypes.addressof(self._ptrs), ctypes.addressof(self._dims),
                      ctypes.addressof(self._plan), *floats, dev.index)

    def run(self, token: Tensor) -> Tuple[Tensor, Tensor]:
        """Submit one token (B, E) of any float dtype (read as fp32); returns
        (hidden, residual), this launch's buffers."""
        if self.tok is None:
            tok = token.to(torch.float32).contiguous()
        else:
            tok = self.tok
            tok[:, :self.e].copy_(token)
        self._ptrs[0] = tok.data_ptr()
        err = self._entry(*self._args, _build.stream_of(tok))
        _build.check(err, "decode_stack_m2" if self.m2 else "decode_stack")
        (decode_stack_m2 if self.m2 else decode_stack).launches += 1
        hidden, residual = self.hidden, self.res[self.depth % 2]
        if self.tok is None:
            return hidden, residual
        return hidden[:, :self.e].contiguous(), residual[:, :self.e].contiguous()


def _card(device) -> torch.device:
    """The CUDA device with its index (``cuda`` names the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _plan_or_raise(name: str, dev: torch.device, **kw) -> dict:
    plan = decode_plan(grid=sm_count(dev.index), **kw)
    if plan is None:
        raise ValueError(f"{name} kernel: no schedule fits one block's shared memory "
                         f"({SMEM_BYTES} bytes) at these widths")
    return plan


def _check_aligned(name: str, tensors: dict) -> None:
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {key} must start on a 16-byte boundary")


def prepare_decode_stack(
    bsz: int,
    device: torch.device,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    x_proj_w: Tensor,
    dt_proj_w: Tensor,
    dt_bias: Tensor,
    A: Tensor,
    D: Tensor,
    conv_states: Tensor,
    ssm_states: Tensor,
    norm_type: str = "rms",
    eps: float = 1e-5,
    timer: bool = False,
) -> DecodeLaunch:
    """Validate K9's operands for a batch of ``bsz`` on ``device`` (a CUDA
    card), plan it and allocate its buffers: the launch
    :func:`decode_stack` makes for each call and ``DecodeSession`` once.

    The five weight stacks in one dtype, fp32 or bf16; the two state stacks
    in one dtype, fp32 or bf16; everything else fp32. All contiguous (the
    states need not be where d_inner is padded). At a width that is not a
    multiple of 8 the weights are padded here, once, and at such a d_inner
    the states are copied into zero-padded storage
    (:func:`pad_decode_states`) that the launch's ``states`` view."""
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    device = _card(device)
    depth, two_di, e = in_proj_w.shape
    di = two_di // 2
    width = conv_w.shape[2]
    r = dt_proj_w.shape[2]
    n = A.shape[2]
    ep, dip = decode_width(e), decode_width(di)
    norm_b = norm_b if norm_type == "layer" else None  # RMSNorm has no shift
    wdt, sdt = _build.one_dtype(in_proj_w), _build.one_dtype(conv_states)
    weights = {"in_proj_w": (in_proj_w, (depth, 2 * di, e)),
               "out_proj_w": (out_proj_w, (depth, e, di)),
               "conv_w": (conv_w, (depth, di, width)),
               "x_proj_w": (x_proj_w, (depth, r + 2 * n, di)),
               "dt_proj_w": (dt_proj_w, (depth, di, r))}
    _build.check_operands(
        "decode_stack", device,
        {"norm_w": (norm_w, (depth, e)), "norm_b": (norm_b, (depth, e)), **weights,
         "conv_b": (conv_b, (depth, di)), "dt_bias": (dt_bias, (depth, di)),
         "A": (A, (depth, di, n)), "D": (D, (depth, di)),
         "conv_states": (conv_states, (depth, bsz, di, width)),
         "ssm_states": (ssm_states, (depth, bsz, di, n))},
        contiguous=("norm_w", "norm_b", *weights, "conv_b", "dt_bias", "A", "D",
                    *(("conv_states", "ssm_states") if dip == di else ())),
        dtypes={**{k: wdt for k in weights}, "conv_states": sdt, "ssm_states": sdt},
    )
    if (ep, dip) != (e, di):  # zero rows and columns: a zero channel stays zero
        in_proj_w = torch.cat([_pad(in_proj_w[:, :di], dip, ep),
                               _pad(in_proj_w[:, di:], dip, ep)], dim=1)
        out_proj_w = _pad(out_proj_w, ep, dip)
        norm_w, norm_b = _pad(norm_w, ep), _pad(norm_b, ep)
        conv_w, x_proj_w = _pad(conv_w, dip, width), _pad(x_proj_w, r + 2 * n, dip)
        dt_proj_w, A = _pad(dt_proj_w, dip, r), _pad(A, dip, n)
        conv_b, dt_bias, D = _pad(conv_b, dip), _pad(dt_bias, dip), _pad(D, dip)
    conv_states, ssm_states = pad_decode_states(conv_states, ssm_states, di)
    states = (conv_states[:, :, :di], ssm_states[:, :, :di]) if dip != di else (
        conv_states, ssm_states)
    _check_aligned("decode_stack", {"in_proj_w": in_proj_w, "out_proj_w": out_proj_w,
                                    "conv_w": conv_w, "x_proj_w": x_proj_w,
                                    "dt_proj_w": dt_proj_w})
    plan = _plan_or_raise("decode_stack", device, batch=bsz, d_model=ep, d_inner=dip,
                          w_bytes=in_proj_w.element_size(), dt_rank=r, d_state=n,
                          s_bytes=conv_states.element_size())
    ops = [norm_w, norm_b, in_proj_w, out_proj_w, conv_w, conv_b, x_proj_w, dt_proj_w,
           dt_bias, A, D, conv_states, ssm_states]
    dims = [_build.is_bf16(in_proj_w), _build.is_bf16(conv_states), depth, bsz, ep, dip, width,
            r, n, int(norm_type == "rms"), plan["grid"], e]
    return DecodeLaunch(False, bsz, e, device, ops, dims, plan, (eps,), states, timer)


def decode_stack_plain(
    token: Tensor,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    x_proj_w: Tensor,
    dt_proj_w: Tensor,
    dt_bias: Tensor,
    A: Tensor,
    D: Tensor,
    conv_states: Tensor,
    ssm_states: Tensor,
    norm_type: str = "rms",
    eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K9 (decode_step.py:80-190) with the kernel's
    rounding points and sums in its order. token (B, E). Returns (hidden
    (B, E) fp32, residual (B, E) fp32, new conv_states, new ssm_states)."""
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    wdt = in_proj_w.dtype
    di = in_proj_w.shape[1] // 2
    width = conv_w.shape[2]
    r = dt_proj_w.shape[2]
    n = A.shape[2]
    hidden = token.float()
    residual = torch.zeros_like(hidden)
    new_conv, new_ssm = [], []
    for k in range(in_proj_w.shape[0]):
        residual = hidden + residual
        normed = (rms_norm(residual, norm_w[k], eps=eps) if norm_type == "rms"
                  else layer_norm(residual, norm_w[k],
                                  None if norm_b is None else norm_b[k], eps=eps))
        xz = _rnd(normed, wdt) @ in_proj_w[k].float().t()
        x_raw, z = xz[:, :di], xz[:, di:]
        cst = conv_states[k].float()
        cw = conv_w[k].float()
        # The kernel's order: window taps 1 .. W-1 oldest first, x_raw last.
        acc = cst[..., 1] * cw[:, 0] if width > 1 else x_raw * cw[:, 0]
        for w in range(1, width):
            acc = acc + (x_raw if w == width - 1 else cst[..., w + 1]) * cw[:, w]
        x = F.silu(acc + conv_b[k])
        new_conv.append(torch.cat(
            [conv_states[k][..., 1:], x_raw.to(conv_states.dtype)[..., None]], dim=-1))
        x_dbl = _rnd(x, wdt) @ x_proj_w[k].float().t()
        dt = softplus(_rnd(x_dbl[:, :r], wdt) @ dt_proj_w[k].float().t() + dt_bias[k])
        h = (torch.exp(dt[..., None] * A[k]) * ssm_states[k].float()
             + (dt * x)[..., None] * x_dbl[:, None, r:r + n])
        new_ssm.append(h.to(ssm_states.dtype))
        y = (h * x_dbl[:, None, r + n:]).sum(-1) + D[k] * x
        y = y * F.silu(z)
        hidden = _rnd(y, wdt) @ out_proj_w[k].float().t()
    return hidden, residual, torch.stack(new_conv), torch.stack(new_ssm)



def decode_stack(
    token: Tensor,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    x_proj_w: Tensor,
    dt_proj_w: Tensor,
    dt_bias: Tensor,
    A: Tensor,
    D: Tensor,
    conv_states: Tensor,
    ssm_states: Tensor,
    norm_type: str = "rms",
    eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Kernel wrapper with the contract of :func:`decode_stack_plain`; on
    CUDA the states are advanced in place and returned.

    On CUDA the operands are those :func:`prepare_decode_stack` takes, the
    token (B, E) any float dtype (read as fp32); every call validates, plans
    and allocates anew (``DecodeSession`` does so once)."""
    if dispatch.runs_plain(token):
        return decode_stack_plain(token, norm_w, norm_b, in_proj_w, out_proj_w, conv_w,
                                  conv_b, x_proj_w, dt_proj_w, dt_bias, A, D, conv_states,
                                  ssm_states, norm_type=norm_type, eps=eps)
    if token.dim() != 2 or token.shape[1] != in_proj_w.shape[2]:
        raise ValueError(f"decode_stack kernel: token has shape {tuple(token.shape)}, expected "
                         f"(batch, {in_proj_w.shape[2]})")
    launch = prepare_decode_stack(token.shape[0], token.device, norm_w, norm_b, in_proj_w,
                                  out_proj_w, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A,
                                  D, conv_states, ssm_states, norm_type=norm_type, eps=eps)
    hidden, residual = launch.run(token)
    if launch.states[0] is not conv_states:  # advanced in the launch's padded storage
        conv_states.copy_(launch.states[0])
        ssm_states.copy_(launch.states[1])
    return hidden, residual, conv_states, ssm_states


decode_stack.launches = 0


def phase_ms(kernel, token: Tensor, kw: dict, iters: int = 20) -> dict:
    """Each phase's device ms a token of ``kernel`` (:func:`decode_stack`:
    in, x_proj, state, out; :func:`decode_stack_m2`: in, state, out) on
    ``token`` and the wrapper's keyword operands ``kw``, summed over the
    layers and averaged over ``iters`` tokens: block 0 stamps the global
    timer as each phase starts, so a phase's time holds the grid barrier
    that closes it. Advances the launch's states (those in ``kw`` unless
    d_inner is padded)."""
    prep = prepare_decode_stack_m2 if kernel is decode_stack_m2 else prepare_decode_stack
    launch = prep(token.shape[0], token.device, **kw, timer=True)
    names = tuple(launch.plan["slice_bytes"])
    sums = dict.fromkeys(names, 0.0)
    for i in range(iters + 2):
        launch.run(token)
        if i < 2:
            continue
        stamps = launch.timer.cpu().double()
        spans = (stamps[1:] - stamps[:-1]) / 1e6
        for j, name in enumerate(names):
            sums[name] += float(spans[j::len(names)].sum())
    return {name: v / iters for name, v in sums.items()}


# ---------------------------------------------------------------------------
# K15: the Mamba-2 (SSD) stack.
#
# Replaces videomamba_tpu/ops/pallas/decode_step.py (decode_stack_pallas_m2,
# ``_decode_kernel_m2``): for each layer, residual add and norm, in_proj
# (z | [x B C] | dt), the rolling conv over [x B C] and SiLU, the per-head
# scalar-decay state update h = exp(dt A_h) h + dt x B with y = C . h + D_h
# x, the silu(z) gate, the gated RMSNorm and out_proj. csrc/decode_step.cu
# runs it as K9 does, one persistent launch a token, three phases a layer:
# K9's in phase (the slab's rows as its channels), a warp per (b, head, p)
# state row (eight rows at a time), and the gated norm + out_proj. Rounding
# as the TPU kernel's: normed and the normed gated rows are rounded to the
# weight dtype before their products, the rest is fp32; the conv windows
# keep their dtype, the SSD states are fp32 (the Mamba-2 streaming
# contract's).
#
# Layouts (the streaming contract's, stacked on depth; the TPU's lane-major
# (K, B, N, H*P) state is not ported): norm_w, norm_b (K, E) fp32;
# in_proj_w (K, 2Di + 2GN + H, E), out_proj_w (K, E, Di), conv_w (K, CD, W)
# in the weight dtype; conv_b (K, CD), A, D, dt_bias (K, H), gate_w (K, Di)
# fp32; conv_states (K, B, CD, W), ssm_states (K, B, H, P, N).


def decode_stack_m2_supported(d_model: int, d_inner: int, nheads: int, ngroups: int,
                              d_state: int) -> bool:
    """K15's gate: the JAX package's shape rule (decode_step.py:64-77: one
    B/C group, d_inner a multiple of 128) and the card's (a schedule at the
    padded d_model, :func:`decode_width`, that fits shared memory on the
    reference card at fp32). Any batch size."""
    if ngroups != 1 or d_inner % 128:
        return False
    d_proj = 2 * d_inner + 2 * ngroups * d_state + nheads
    return decode_plan(1, decode_width(d_model), d_inner, 4, REF_SMS, d_proj=d_proj,
                       nheads=nheads, d_state=d_state) is not None


def decode_stack_m2_plain(
    token: Tensor,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    A: Tensor,
    D: Tensor,
    dt_bias: Tensor,
    gate_w: Optional[Tensor],
    conv_states: Tensor,
    ssm_states: Tensor,
    ngroups: int = 1,
    norm_type: str = "rms",
    eps: float = 1e-5,
    gate_eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K15 (decode_step.py:306-417) with the
    kernel's rounding points. token (B, E). Returns (hidden (B, E) fp32,
    residual (B, E) fp32, new conv_states, new ssm_states)."""
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    wdt = in_proj_w.dtype
    di = out_proj_w.shape[2]
    _, bsz, nheads, hdim, n = ssm_states.shape
    gn = ngroups * n
    cd = di + 2 * gn
    width = conv_w.shape[2]
    hidden = token.float()
    residual = torch.zeros_like(hidden)
    new_conv, new_ssm = [], []
    for k in range(in_proj_w.shape[0]):
        residual = hidden + residual
        normed = (rms_norm(residual, norm_w[k], eps=eps) if norm_type == "rms"
                  else layer_norm(residual, norm_w[k],
                                  None if norm_b is None else norm_b[k], eps=eps))
        zxbcdt = _rnd(normed, wdt) @ in_proj_w[k].float().t()
        z, raw, dt_raw = zxbcdt[:, :di], zxbcdt[:, di:di + cd], zxbcdt[:, di + cd:]
        cst = conv_states[k].float()
        cw = conv_w[k].float()
        # The kernel's order: window taps 1 .. W-1 oldest first, the raw input last.
        acc = cst[..., 1] * cw[:, 0] if width > 1 else raw * cw[:, 0]
        for w in range(1, width):
            acc = acc + (raw if w == width - 1 else cst[..., w + 1]) * cw[:, w]
        xbc = F.silu(acc + conv_b[k])
        new_conv.append(torch.cat(
            [conv_states[k][..., 1:], raw.to(conv_states.dtype)[..., None]], dim=-1))
        x = xbc[:, :di].reshape(bsz, nheads, hdim)
        Bh = xbc[:, di:di + gn].reshape(bsz, ngroups, n).repeat_interleave(
            nheads // ngroups, dim=1)
        Ch = xbc[:, di + gn:].reshape(bsz, ngroups, n).repeat_interleave(
            nheads // ngroups, dim=1)
        dt = softplus(dt_raw + dt_bias[k])  # (B, H)
        dA = torch.exp(dt * A[k])
        h = (dA[:, :, None, None] * ssm_states[k].float()
             + (dt[:, :, None] * x)[..., None] * Bh[:, :, None, :])
        new_ssm.append(h.to(ssm_states.dtype))
        y = (h * Ch[:, :, None, :]).sum(-1) + D[k][:, None] * x
        gated = y.reshape(bsz, di) * F.silu(z)
        if gate_w is not None:
            gated = gated * torch.rsqrt(gated.square().mean(-1, keepdim=True) + gate_eps)
            gated = gated * gate_w[k]
        hidden = _rnd(gated, wdt) @ out_proj_w[k].float().t()
    return hidden, residual, torch.stack(new_conv), torch.stack(new_ssm)



def prepare_decode_stack_m2(
    bsz: int,
    device: torch.device,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    A: Tensor,
    D: Tensor,
    dt_bias: Tensor,
    gate_w: Optional[Tensor],
    conv_states: Tensor,
    ssm_states: Tensor,
    ngroups: int = 1,
    norm_type: str = "rms",
    eps: float = 1e-5,
    gate_eps: float = 1e-5,
    timer: bool = False,
) -> DecodeLaunch:
    """Validate K15's operands for a batch of ``bsz`` on ``device``, plan
    it and allocate its buffers (:func:`prepare_decode_stack`'s role for
    K15). The three weight stacks in one dtype, fp32 or bf16; the conv
    windows fp32 or bf16 and the SSD states fp32 (the streaming contract's);
    everything else fp32. All contiguous. A d_model that is not a multiple
    of 8 is padded here, once (the weights; the token by the launch)."""
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    device = _card(device)
    depth, e, di = out_proj_w.shape
    nheads, hdim, n = ssm_states.shape[2:]
    cd = di + 2 * ngroups * n
    width = conv_w.shape[2]
    if not decode_stack_m2_supported(e, di, nheads, ngroups, n):
        raise ValueError(
            f"decode_stack_m2 kernel takes one group and d_inner a multiple of 128, got "
            f"d_model {e}, d_inner {di}, {ngroups} groups")
    norm_b = norm_b if norm_type == "layer" else None  # RMSNorm has no shift
    wdt = _build.one_dtype(in_proj_w)
    weights = {"in_proj_w": (in_proj_w, (depth, di + cd + nheads, e)),
               "out_proj_w": (out_proj_w, (depth, e, di)),
               "conv_w": (conv_w, (depth, cd, width))}
    _build.check_operands(
        "decode_stack_m2", device,
        {"norm_w": (norm_w, (depth, e)), "norm_b": (norm_b, (depth, e)), **weights,
         "conv_b": (conv_b, (depth, cd)), "A": (A, (depth, nheads)),
         "D": (D, (depth, nheads)), "dt_bias": (dt_bias, (depth, nheads)),
         "gate_w": (gate_w, (depth, di)),
         "conv_states": (conv_states, (depth, bsz, cd, width)),
         "ssm_states": (ssm_states, (depth, bsz, nheads, hdim, n))},
        contiguous=("norm_w", "norm_b", *weights, "conv_b", "A", "D", "dt_bias", "gate_w",
                    "conv_states", "ssm_states"),
        dtypes={**{k: wdt for k in weights}, "conv_states": _build.FP32_OR_BF16},
    )
    ep = decode_width(e)
    if ep != e:  # zero columns of in_proj, zero rows of out_proj and zero norm lanes
        in_proj_w, out_proj_w = _pad(in_proj_w, di + cd + nheads, ep), _pad(out_proj_w, ep, di)
        norm_w, norm_b = _pad(norm_w, ep), _pad(norm_b, ep)
    _check_aligned("decode_stack_m2", {"in_proj_w": in_proj_w, "out_proj_w": out_proj_w,
                                       "conv_w": conv_w})
    plan = _plan_or_raise("decode_stack_m2", device, batch=bsz, d_model=ep, d_inner=di,
                          w_bytes=in_proj_w.element_size(), d_proj=di + cd + nheads,
                          nheads=nheads, d_state=n)
    ops = [norm_w, norm_b, in_proj_w, out_proj_w, conv_w, conv_b, A, D, dt_bias, gate_w,
           conv_states, ssm_states]
    dims = [_build.is_bf16(in_proj_w), _build.is_bf16(conv_states), depth, bsz, ep, nheads,
            hdim, ngroups, n, width, int(norm_type == "rms"), plan["grid"], e]
    return DecodeLaunch(True, bsz, e, device, ops, dims, plan, (eps, gate_eps),
                        (conv_states, ssm_states), timer)


def decode_stack_m2(
    token: Tensor,
    norm_w: Tensor,
    norm_b: Optional[Tensor],
    in_proj_w: Tensor,
    out_proj_w: Tensor,
    conv_w: Tensor,
    conv_b: Tensor,
    A: Tensor,
    D: Tensor,
    dt_bias: Tensor,
    gate_w: Optional[Tensor],
    conv_states: Tensor,
    ssm_states: Tensor,
    ngroups: int = 1,
    norm_type: str = "rms",
    eps: float = 1e-5,
    gate_eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Kernel wrapper with the contract of :func:`decode_stack_m2_plain`; on
    CUDA the states are advanced in place and returned.

    On CUDA the operands are those :func:`prepare_decode_stack_m2` takes,
    the token (B, E) any float dtype (read as fp32); every call validates,
    plans and allocates anew."""
    if dispatch.runs_plain(token):
        return decode_stack_m2_plain(token, norm_w, norm_b, in_proj_w, out_proj_w, conv_w,
                                     conv_b, A, D, dt_bias, gate_w, conv_states, ssm_states,
                                     ngroups=ngroups, norm_type=norm_type, eps=eps,
                                     gate_eps=gate_eps)
    if token.dim() != 2 or token.shape[1] != out_proj_w.shape[1]:
        raise ValueError(f"decode_stack_m2 kernel: token has shape {tuple(token.shape)}, "
                         f"expected (batch, {out_proj_w.shape[1]})")
    launch = prepare_decode_stack_m2(token.shape[0], token.device, norm_w, norm_b, in_proj_w,
                                     out_proj_w, conv_w, conv_b, A, D, dt_bias, gate_w,
                                     conv_states, ssm_states, ngroups=ngroups,
                                     norm_type=norm_type, eps=eps, gate_eps=gate_eps)
    hidden, residual = launch.run(token)
    return hidden, residual, conv_states, ssm_states


decode_stack_m2.launches = 0
