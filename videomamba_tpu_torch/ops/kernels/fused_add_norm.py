"""K2: fused residual add + RMS/LayerNorm and K8: its backward, CUDA for Hopper.

Replaces videomamba_tpu/ops/pallas/fused_add_norm.py (fused_add_norm_pallas,
``_kernel``). The kernel is csrc/fused_add_norm.cu: one warp per row, the row
kept in shared memory between its single read and its writes, statistics in
fp32 with warp shuffles (the row kernel is csrc/add_norm.cuh, which K4's
first launch shares). It is bound by device memory (two rows read, two
written, a few flops per element), which is why it reads and writes each
element once. Any row width D: a block holds four rows in shared memory,
fewer where they do not fit, and a row too wide for shared memory is read
again for each pass. x (and so normed) is fp32 or bf16, and so is the
residual, on its own: at bf16 the final norm gets a bf16 x and an fp32
residual. The returned residual is fp32 under ``residual_in_fp32``, else
x's dtype, as in the JAX package. Any other dtype on CUDA raises.

K8 replaces fused_add_norm.py (fused_add_norm_bwd_pallas, ``_bwd_kernel``):
dx, dresidual, dweight and dbias, csrc/fused_add_norm_bwd.cu over the row
pass of csrc/add_norm_bwd.cuh (which K7's last launch shares). A group of
threads holds a row in registers (one warp up to D = 768, 2-8 warps a
wider row, a streamed row above D = 6128) and moves it in 16-byte vectors
where D and the pointers allow, all of a row's loads issued before its
first reduction; each thread adds its columns' dweight and dbias terms into
its row group's row of shared memory, a block's groups add theirs in order
into one partial row, and a second launch sums the partial rows in a fixed
tree (no atomics: repeats are bit-identical). :func:`norm_bwd_plan` lays
the launch out on the host, for K8 and for K7's last launch; the kernel
checks it.
"""

from __future__ import annotations

import functools
import operator
from typing import NamedTuple, Optional

import torch

from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.norm import layer_norm, rms_norm

Tensor = torch.Tensor

def fused_add_norm_plain(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    residual: Optional[Tensor] = None,
    prenorm: bool = False,
    residual_in_fp32: bool = False,
    eps: float = 1e-5,
    norm_type: str = "rms",
):
    """Plain PyTorch version of the kernel (videomamba_tpu/ops/norm.py:170-187)."""
    if residual is not None:
        residual_out = x.float() + residual.float()
    else:
        residual_out = x.float()
    if norm_type == "rms":
        normed = rms_norm(residual_out, weight, eps=eps)
    elif norm_type == "layer":
        normed = layer_norm(residual_out, weight, bias, eps=eps)
    else:
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    normed = normed.to(x.dtype)
    if not prenorm:
        return normed
    if not residual_in_fp32:
        residual_out = residual_out.to(x.dtype)
    return normed, residual_out


def fused_add_norm(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    residual: Optional[Tensor] = None,
    prenorm: bool = False,
    residual_in_fp32: bool = False,
    eps: float = 1e-5,
    norm_type: str = "rms",
):
    """Kernel wrapper: same contract as :func:`fused_add_norm_plain`.

    x, residual: (..., D) fp32 or bf16, contiguous, on one CUDA device;
    weight and bias (D,) fp32. Returns fresh tensors; never synchronises.
    """
    if dispatch.runs_plain(x):
        return fused_add_norm_plain(
            x, weight, bias, residual=residual, prenorm=prenorm,
            residual_in_fp32=residual_in_fp32, eps=eps, norm_type=norm_type,
        )
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    d = x.shape[-1]
    bias = bias if norm_type == "layer" else None  # RMSNorm has no shift
    _build.check_operands(
        "fused_add_norm", x.device,
        {"x": (x, x.shape), "residual": (residual, x.shape),
         "weight": (weight, (d,)), "bias": (bias, (d,))},
        contiguous=("x", "residual", "weight", "bias"),
        dtypes={"x": _build.FP32_OR_BF16, "residual": _build.FP32_OR_BF16},
    )

    out = torch.empty_like(x)
    res_dtype = torch.float32 if residual_in_fp32 else x.dtype
    res_out = torch.empty_like(x, dtype=res_dtype) if prenorm else None
    m = x.numel() // d if d else 0
    if m:
        err = _build.library().vmt_fused_add_norm(
            _build.ptr(x), _build.is_bf16(x), _build.ptr(residual),
            _build.is_bf16(residual), _build.ptr(weight), _build.ptr(bias),
            _build.ptr(out), _build.ptr(res_out), _build.is_bf16(res_out), m, d,
            eps, int(norm_type == "rms"), x.device.index, _build.stream_of(x),
        )
        _build.check(err, "fused_add_norm")
        fused_add_norm.launches += 1
    return (out, res_out) if prenorm else out


fused_add_norm.launches = 0


def fused_add_norm_bwd_plain(
    x: Tensor,
    weight: Tensor,
    residual: Optional[Tensor],
    g_out: Tensor,
    g_resout: Optional[Tensor],
    prenorm: bool = False,
    eps: float = 1e-5,
    norm_type: str = "rms",
):
    """Plain PyTorch version of K8 (fused_add_norm.py:134-177), fp32.

    Returns (dx in x's dtype, dweight (D,) fp32, dbias (D,) fp32 — the raw
    row sum of g_out, dropped by the caller without a bias — and dresidual
    in the residual's dtype, None without a residual)."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    r = x32 + residual.float().reshape(-1, d) if residual is not None else x32
    g = g_out.float().reshape(-1, d)
    if norm_type == "rms":
        inv = torch.rsqrt(r.square().mean(-1, keepdim=True) + eps)
        cen = r
    elif norm_type == "layer":
        cen = r - r.mean(-1, keepdim=True)
        inv = torch.rsqrt(cen.square().mean(-1, keepdim=True) + eps)
    else:
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    dweight = (g * (cen * inv)).sum(0)
    dbias = g.sum(0)
    dn = g * weight.float()
    dot = (dn * cen).sum(-1, keepdim=True)
    dr = dn * inv - cen * inv ** 3 * (dot / d)
    if norm_type == "layer":
        dr = dr - dr.mean(-1, keepdim=True)
    if prenorm and g_resout is not None:
        dr = dr + g_resout.float().reshape(-1, d)
    dr = dr.reshape(x.shape)
    dres = dr.to(residual.dtype) if residual is not None else None
    return dr.to(x.dtype), dweight, dbias, dres


# The row pass's layout. csrc/add_norm_bwd.cuh checks every plan against
# the same constants (its kNormBwd*), which must agree with these.
NORM_BWD_SMS = 132            # the grid is sized for one wave of these
NORM_BWD_SM_THREADS = 512     # resident threads an SM the grid assumes
NORM_BWD_ROW_ELEMS = 24       # row elements a thread holds in registers
NORM_BWD_ROW_ELEMS_SCALAR = 16  # the same at one element a vector
NORM_BWD_MAX_THREADS = 256    # threads a block (and a row, at most); wider rows stream
NORM_BWD_SMEM_FLOATS = 12288  # a block's dynamic shared memory (48 KB, no opt-in)
NORM_BWD_RED_FLOATS = 32      # a group wider than a warp: its reduction words
NORM_BWD_SUM_COLS = 8         # columns a block of the column sum
NORM_BWD_SUM_SLICES = 32      # slices of partial rows a column sum adds


class NormBwdPlan(NamedTuple):
    """One row pass's launch: ``vec`` elements a vector (1, 4 or 8),
    ``threads`` a row (a multiple of 32), ``rows`` a block, ``blocks`` in
    the grid (the partial rows), ``stream`` for rows re-read from device
    memory in each pass (too wide for registers)."""
    vec: int
    threads: int
    rows: int
    blocks: int
    stream: bool

    def part_shape(self, d: int) -> tuple:
        """The fp32 partial sums' shape: a (dweight, dbias) row a block."""
        return (self.blocks, 2, d)


def norm_bwd_vec(dtypes, d: int, aligned: bool = True) -> int:
    """Elements a vector: 8 when every row array (x, residual, g_out,
    g_resout; a missing one counts as x's dtype) is bf16, else 4 (a 16-byte
    fp32 load; bf16 beside fp32 moves 8 bytes); 1 when D is no multiple of
    it or a pointer cannot start a vector (``aligned`` False)."""
    vec = 8 if all(t == torch.bfloat16 for t in dtypes) else 4
    return vec if aligned and d % vec == 0 else 1


def norm_bwd_row_elems(vec: int) -> int:
    """Row elements a thread holds at this vector width (fewer at one
    element a vector, whose addressing costs registers)."""
    return NORM_BWD_ROW_ELEMS_SCALAR if vec == 1 else NORM_BWD_ROW_ELEMS


def norm_bwd_smem_floats(rows: int, threads: int, d: int) -> int:
    """A row-pass block's dynamic shared memory in floats: its dweight /
    dbias rows, then the reduction words of a group wider than a warp."""
    return 2 * rows * d + (NORM_BWD_RED_FLOATS if threads > 32 else 0)


def norm_bwd_plan(m: int, d: int, dtypes, aligned: bool = True) -> NormBwdPlan:
    """The row pass's launch at M rows of width D for these row dtypes (see
    :func:`norm_bwd_vec`): the fewest warps a row (rounded up to whole
    warps) at :func:`norm_bwd_row_elems` elements a thread; as many rows a
    block as fill NORM_BWD_MAX_THREADS threads while
    :func:`norm_bwd_smem_floats` stays within NORM_BWD_SMEM_FLOATS; streamed
    (one row a block) where a row needs more than NORM_BWD_MAX_THREADS
    threads or one row's shared memory does not fit; about one wave of
    blocks (NORM_BWD_SM_THREADS threads an SM), fewer for fewer rows. K8's
    and K7's wrappers both pass it to the kernel, which checks it."""
    return _norm_bwd_plan(m, d, tuple(dtypes), aligned)


@functools.lru_cache(maxsize=256)
def _norm_bwd_plan(m: int, d: int, dtypes: tuple, aligned: bool) -> NormBwdPlan:
    vec = norm_bwd_vec(dtypes, d, aligned)
    nvec = -(-d // vec)
    need = -(-nvec // (norm_bwd_row_elems(vec) // vec))
    threads = -(-max(need, 1) // 32) * 32
    fit = (NORM_BWD_SMEM_FLOATS - norm_bwd_smem_floats(0, threads, d)) // (2 * max(d, 1))
    stream = threads > NORM_BWD_MAX_THREADS or fit < 1
    if stream:
        threads, rows = NORM_BWD_MAX_THREADS, 1
    else:
        rows = min(NORM_BWD_MAX_THREADS // threads, fit)
    cap = NORM_BWD_SMS * max(1, NORM_BWD_SM_THREADS // (rows * threads))
    blocks = max(1, min(-(-m // rows), cap))
    return NormBwdPlan(vec, threads, rows, blocks, stream)


def fused_add_norm_bwd(
    x: Tensor,
    weight: Tensor,
    residual: Optional[Tensor],
    g_out: Tensor,
    g_resout: Optional[Tensor],
    prenorm: bool = False,
    eps: float = 1e-5,
    norm_type: str = "rms",
):
    """Kernel wrapper with the contract of :func:`fused_add_norm_bwd_plain`.

    On CUDA: x, the residual, g_out and g_resout each fp32 or bf16 (g_out is
    read at its own dtype, as the JAX kernel reads it), weight (D,) fp32."""
    if dispatch.runs_plain(x):
        return fused_add_norm_bwd_plain(x, weight, residual, g_out, g_resout,
                                        prenorm=prenorm, eps=eps, norm_type=norm_type)
    if norm_type not in ("rms", "layer"):
        raise ValueError(f"Unknown norm_type: {norm_type!r}")
    d = x.shape[-1]
    g = g_out.contiguous()
    g_r = g_resout.contiguous() if (prenorm and g_resout is not None) else None
    _build.check_operands(
        "fused_add_norm_bwd", x.device,
        {"x": (x, x.shape), "residual": (residual, x.shape), "g_out": (g, x.shape),
         "g_resout": (g_r, x.shape), "weight": (weight, (d,))},
        contiguous=("x", "residual", "g_out", "g_resout", "weight"),
        dtypes={"x": _build.FP32_OR_BF16, "residual": _build.FP32_OR_BF16,
                "g_out": _build.FP32_OR_BF16, "g_resout": _build.FP32_OR_BF16},
    )
    dev = x.device
    dx = torch.empty_like(x)
    dres = torch.empty_like(residual) if residual is not None else None
    m = x.numel() // d if d else 0
    sums = torch.empty((2, d), dtype=torch.float32, device=dev)
    dweight, dbias = sums.unbind(0)
    if m == 0:
        sums.zero_()
        return dx, dweight, dbias, dres
    arrays = (x, residual, g, g_r, weight, dx, dres)
    ptrs = [0 if t is None else t.data_ptr() for t in arrays]
    dtypes = tuple(x.dtype if t is None else t.dtype for t in arrays[:4])
    # One test for every pointer: 16-byte boundaries (a bf16 array with
    # 4-element vectors would do with 8).
    aligned = functools.reduce(operator.or_, ptrs) % 16 == 0
    plan = norm_bwd_plan(m, d, dtypes, aligned=aligned)
    part = torch.empty(plan.part_shape(d), dtype=torch.float32, device=dev)
    p_x, p_res, p_g, p_gr, p_w, p_dx, p_dres = ptrs
    err = _build.library().vmt_fused_add_norm_bwd(
        p_x, _build.is_bf16(x), p_res or None, _build.is_bf16(residual), p_w, p_g,
        _build.is_bf16(g), p_gr or None, _build.is_bf16(g_r), p_dx, p_dres or None,
        dweight.data_ptr(), dbias.data_ptr(), part.data_ptr(), m, d, eps,
        int(norm_type == "rms"), *plan, dev.index, _build.stream_of(x),
    )
    _build.check(err, "fused_add_norm_bwd")
    fused_add_norm_bwd.launches += 1
    return dx, dweight, dbias, dres


fused_add_norm_bwd.launches = 0
