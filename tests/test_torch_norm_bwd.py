"""K8 (fused add-norm backward) vs videomamba_tpu, and the norm's two routes.

K8's plain version (the kernel's reference on the card) against the JAX
package's ``fused_add_norm_bwd_pallas`` in interpret mode, for RMS and
LayerNorm, prenorm on and off, ``residual_in_fp32`` on (fp32 residual) and
off (residual in x's dtype), and with a bf16 x beside an fp32 cotangent.
The default backward of ``FusedAddNormFn`` (autograd of the plain
composition, JAX ``_fan_bwd``) against its K8 route under
VIDEOMAMBA_NORM_BWD=pallas. rel_err = max|a - b| / max|b|. Bars: 1e-5 at
fp32 (the JAX kernels' own), 1e-2 with bf16 x (one bf16 ulp is 2^-8).

The kernel's launch plan (``norm_bwd_plan``) is checked here too, against
a model of the kernel's index arithmetic (csrc/add_norm_bwd.cuh): every
(row, column) is taken by exactly one thread, and the column sum of the
partial rows adds in an order that depends on nothing but their count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videomamba_tpu.ops.pallas.fused_add_norm import fused_add_norm_bwd_pallas
from videomamba_tpu_torch.ops.kernels import fused_add_norm as k8
from videomamba_tpu_torch.ops.kernels.fused_add_norm import fused_add_norm_bwd_plain
from videomamba_tpu_torch.ops.norm import fused_add_norm

TOL = {"fp32": 1e-5, "bf16": 1e-2}
JDTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def norm_inputs(seed, m=37, d=128):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((m, d)).astype(f), rng.standard_normal((m, d)).astype(f),
            (1 + 0.1 * rng.standard_normal(d)).astype(f),
            rng.standard_normal((m, d)).astype(f), rng.standard_normal((m, d)).astype(f))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("residual_in_fp32", [True, False])
@pytest.mark.parametrize("prenorm", [True, False])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
def test_norm_bwd_plain_matches_pallas(norm_type, prenorm, residual_in_fp32, dtype):
    x, res, w, gn, gr = norm_inputs(seed=len(norm_type) + 2 * prenorm)
    res_dtype = "fp32" if residual_in_fp32 else dtype
    jx, jres = jnp.asarray(x, JDTYPE[dtype]), jnp.asarray(res, JDTYPE[res_dtype])
    jgn = jnp.asarray(gn, JDTYPE[dtype])
    jgr = jnp.asarray(gr, JDTYPE[res_dtype]) if prenorm else None
    jdx, jdw, jdb, jdres = fused_add_norm_bwd_pallas(
        jx, jnp.asarray(w), jres, jgn, jgr, prenorm=prenorm, has_residual=True,
        eps=1e-5, norm_type=norm_type, interpret=True,
    )
    tx = torch.from_numpy(x).to(TDTYPE[dtype])
    tres = torch.from_numpy(res).to(TDTYPE[res_dtype])
    tgr = torch.from_numpy(gr).to(TDTYPE[res_dtype]) if prenorm else None
    dx, dw, db, dres = fused_add_norm_bwd_plain(
        tx, torch.from_numpy(w), tres, torch.from_numpy(gn).to(TDTYPE[dtype]), tgr,
        prenorm=prenorm, eps=1e-5, norm_type=norm_type,
    )
    assert dx.dtype == TDTYPE[dtype] and dres.dtype == TDTYPE[res_dtype]
    assert dw.dtype == db.dtype == torch.float32
    tol = TOL[dtype]
    for a, b in ((dx, jdx), (dres, jdres), (dw, jdw), (db, jdb)):
        assert rel_err(a, b) <= tol


@pytest.mark.parametrize("prenorm", [True, False])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
def test_default_backward_matches_k8_route(norm_type, prenorm, monkeypatch):
    """FusedAddNormFn: autograd of the plain composition (default) against
    K8's route (VIDEOMAMBA_NORM_BWD=pallas), every input's gradient."""
    x, res, w, gn, gr = norm_inputs(seed=11)
    bias = np.linspace(-0.1, 0.1, w.shape[0]).astype(np.float32)
    grads = {}
    for route in ("", "pallas"):
        monkeypatch.setenv("VIDEOMAMBA_NORM_BWD", route)
        t = [torch.from_numpy(v).requires_grad_() for v in (x, w, bias, res)]
        out = fused_add_norm(t[0], t[1], t[2] if norm_type == "layer" else None,
                             residual=t[3], prenorm=prenorm, residual_in_fp32=True,
                             norm_type=norm_type, use_kernel=True)
        outs = out if prenorm else (out,)
        assert outs[0].grad_fn.name().startswith("FusedAddNormFn")
        loss = (outs[0] * torch.from_numpy(gn)).sum()
        if prenorm:
            loss = loss + (outs[1] * torch.from_numpy(gr)).sum()
        loss.backward()
        grads[route] = [v.grad for v in t]
    for a, b in zip(grads["pallas"], grads[""]):
        assert (a is None) == (b is None)
        if a is not None:
            assert rel_err(a, b) <= 1e-5


@pytest.mark.parametrize("norm_type", ["rms", "layer"])
def test_plain_reads_an_fp32_cotangent_beside_bf16_x(norm_type):
    """x bf16 with g_out fp32: the JAX kernel reads g_out at its own dtype
    (``gn_ref[0].astype(jnp.float32)``); so does the plain version, and the
    fp32 dweight and dbias hold the fp32 bar."""
    x, res, w, gn, gr = norm_inputs(seed=21)
    jdx, jdw, jdb, jdres = fused_add_norm_bwd_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(res), jnp.asarray(gn),
        jnp.asarray(gr), prenorm=True, has_residual=True, eps=1e-5, norm_type=norm_type,
        interpret=True,
    )
    dx, dw, db, dres = fused_add_norm_bwd_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w), torch.from_numpy(res),
        torch.from_numpy(gn), torch.from_numpy(gr), prenorm=True, eps=1e-5,
        norm_type=norm_type,
    )
    assert dx.dtype == torch.bfloat16 and dres.dtype == torch.float32
    assert rel_err(dx, jdx) <= TOL["bf16"]
    for a, b in ((dw, jdw), (db, jdb), (dres, jdres)):
        assert rel_err(a, b) <= TOL["fp32"]


# ---------------------------------------------------------------- the plan

def _row_cover(plan, m):
    """How often the row loop of the kernel visits each row: block b's row
    group g takes rows b * rows + g, then every blocks * rows further."""
    seen = np.zeros(m, np.int64)
    for b in range(plan.blocks):
        for grp in range(plan.rows):
            seen[b * plan.rows + grp::plan.blocks * plan.rows] += 1
    return seen


def _column_cover(plan, d):
    """How often the threads of a row group touch each column: thread t
    holds vectors t + s * threads (s < row elements / vec) in registers, or
    walks t, t + threads, ... when the row is streamed; vector j is columns
    j * vec .. j * vec + vec - 1."""
    nvec = d // plan.vec
    t = np.arange(plan.threads)[:, None]
    if plan.stream:
        js = [np.arange(i, nvec, plan.threads) for i in range(plan.threads)]
        j = np.concatenate(js)
    else:
        slots = k8.norm_bwd_row_elems(plan.vec) // plan.vec
        j = (t + np.arange(slots)[None, :] * plan.threads).ravel()
        j = j[j < nvec]
    cols = (j[:, None] * plan.vec + np.arange(plan.vec)[None, :]).ravel()
    return np.bincount(cols, minlength=d)


def _sum_cover(plan, d):
    """How often the column sum reads each (partial row, column): block c
    takes columns 8c .. 8c + 7 of 2D, slice k the rows k, k + 32, ..."""
    blocks = -(-2 * d // k8.NORM_BWD_SUM_COLS)
    cols = np.arange(blocks * k8.NORM_BWD_SUM_COLS)
    cols = cols[cols < 2 * d]
    rows = np.concatenate([np.arange(k, plan.blocks, k8.NORM_BWD_SUM_SLICES)
                           for k in range(k8.NORM_BWD_SUM_SLICES)])
    return np.bincount(rows, minlength=plan.blocks), np.bincount(cols, minlength=2 * d)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 5, 1569, 6276])
@pytest.mark.parametrize("d", [1, 3, 7, 8, 768, 1000, 1536, 3072, 3200, 6128, 6144, 14529,
                               65536])
def test_norm_bwd_plan_covers_every_element_once(d, m, dtype):
    dt = TDTYPE[dtype]
    plan = k8.norm_bwd_plan(m, d, [dt] * 4)
    assert plan.vec == (1 if d % (8 if dtype == "bf16" else 4) else
                        (8 if dtype == "bf16" else 4))
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= k8.NORM_BWD_MAX_THREADS
    assert plan.rows * plan.threads <= k8.NORM_BWD_MAX_THREADS
    assert plan.stream or k8.norm_bwd_smem_floats(plan.rows, plan.threads, d) <= \
        k8.NORM_BWD_SMEM_FLOATS
    assert 1 <= plan.blocks <= k8.NORM_BWD_SMS * max(
        1, k8.NORM_BWD_SM_THREADS // (plan.rows * plan.threads))
    # Streamed: too wide for the registers of 256 threads, or one row's
    # sums with its group's reduction words past 48 KB (6128 < D <= 6144).
    assert plan.stream == (d > k8.NORM_BWD_MAX_THREADS * k8.norm_bwd_row_elems(plan.vec) or
                           2 * d + k8.NORM_BWD_RED_FLOATS > k8.NORM_BWD_SMEM_FLOATS)
    assert plan.part_shape(d) == (plan.blocks, 2, d)
    assert np.all(_row_cover(plan, m) == 1)
    assert np.all(_column_cover(plan, d) == 1)
    rows, cols = _sum_cover(plan, d)
    assert np.all(rows == 1) and np.all(cols == 1)
    # A pointer off the vector boundary: the same coverage, a column a vector.
    scalar = k8.norm_bwd_plan(m, d, [dt] * 4, aligned=False)
    assert scalar.vec == 1 and np.all(_column_cover(scalar, d) == 1)


@pytest.mark.parametrize("dtypes,aligned", [
    ([torch.float32] * 4, True), ([torch.bfloat16] * 4, True),
    ([torch.bfloat16, torch.float32] * 2, True), ([torch.float32] * 4, False)])
def test_norm_bwd_plan_fits_the_shared_memory_a_launch_gets(dtypes, aligned):
    """At every D up to 8192 the row pass's block asks for no more than the
    48 KB of dynamic shared memory a launch gets without opting in: its
    dweight / dbias rows plus, for a group wider than a warp, the group's
    reduction words (the kernel keeps no other shared memory)."""
    for d in range(1, 8193):
        plan = k8.norm_bwd_plan(1569, d, dtypes, aligned=aligned)
        if plan.stream:
            continue
        red = k8.NORM_BWD_RED_FLOATS if plan.threads > 32 else 0
        assert 4 * (2 * plan.rows * d + red) <= 48 * 1024, (d, plan)
        assert k8.norm_bwd_smem_floats(plan.rows, plan.threads, d) == 2 * plan.rows * d + red


def _source_constant(path, name):
    """The value of ``constexpr int <name> = <value>;`` in a kernel source."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1] / "videomamba_tpu_torch" / "csrc"
    found = re.search(rf"constexpr int {name} = ([^;]+);", (root / path).read_text())
    assert found, (path, name)
    return found.group(1).strip()


@pytest.mark.parametrize("py_name,c_name", [
    ("NORM_BWD_ROW_ELEMS", "kNormBwdRowElems"),
    ("NORM_BWD_ROW_ELEMS_SCALAR", "kNormBwdRowElemsScalar"),
    ("NORM_BWD_SMEM_FLOATS", "kNormBwdSmemFloats"),
    ("NORM_BWD_MAX_THREADS", "kNormBwdMaxThreads"),
    ("NORM_BWD_SUM_COLS", "kNormBwdSumCols"),
    ("NORM_BWD_SUM_SLICES", "kNormBwdSumSlices")])
def test_norm_bwd_plan_constants_are_the_kernels(py_name, c_name):
    """The plan's constants are those csrc/add_norm_bwd.cuh checks every
    plan against (and the reduction words 4 a warp of a widest group)."""
    assert int(_source_constant("add_norm_bwd.cuh", c_name)) == getattr(k8, py_name)
    assert _source_constant("add_norm_bwd.cuh", "kNormBwdRedFloats") == "4 * kNormBwdMaxWarps"
    assert k8.NORM_BWD_RED_FLOATS == 4 * k8.NORM_BWD_MAX_THREADS // 32


def test_norm_bwd_vector_width_follows_every_row_array():
    """16-byte vectors: 8 elements only when every row array is bf16; a bf16
    x beside an fp32 residual or cotangent takes 4."""
    bf, f = torch.bfloat16, torch.float32
    assert k8.norm_bwd_vec([bf] * 4, 768) == 8
    assert k8.norm_bwd_vec([bf, f, bf, f], 768) == 4
    assert k8.norm_bwd_vec([bf, bf, f, bf], 768) == 4
    assert k8.norm_bwd_vec([f] * 4, 770) == 1
    assert k8.norm_bwd_vec([bf] * 4, 772) == 1
    assert k8.norm_bwd_vec([f] * 4, 768, aligned=False) == 1


def _partial_rows(terms, plan, order):
    """The row pass's partial rows as the kernel forms them (fp32): each
    thread adds its rows' terms in grid-stride order, then the block's row
    groups add in group order. Blocks write their own row of ``part`` in
    the given finishing order."""
    m, width = terms.shape
    part = np.full((plan.blocks, width), np.nan, np.float32)
    for b in order:
        groups = []
        for grp in range(plan.rows):
            acc = np.zeros(width, np.float32)
            for r in range(b * plan.rows + grp, m, plan.blocks * plan.rows):
                acc = acc + terms[r]
            groups.append(acc)
        total = groups[0]
        for acc in groups[1:]:
            total = total + acc
        part[b] = total
    return part


def _column_sum(part):
    """add_norm_bwd_sum_kernel's order: slice k adds rows k, k + 32, ... in
    order, then slices add in a tree, 16, 8, 4, 2, 1 apart."""
    p, width = part.shape
    s = np.zeros((k8.NORM_BWD_SUM_SLICES, width), np.float32)
    for k in range(k8.NORM_BWD_SUM_SLICES):
        for r in range(k, p, k8.NORM_BWD_SUM_SLICES):
            s[k] = s[k] + part[r]
    h = k8.NORM_BWD_SUM_SLICES // 2
    while h:
        s[:h] = s[:h] + s[h:2 * h]
        h //= 2
    return s[0]


@pytest.mark.parametrize("m,d", [(5, 7), (1569, 768), (6276, 768), (1569, 3200)])
def test_column_sum_bits_do_not_depend_on_which_block_finishes_last(m, d):
    """The fixed-order sum of the partial rows gives the same bits whichever
    block wrote its row last (three finishing orders), and the sum is
    dweight / dbias within fp32 rounding of the float64 sum."""
    rng = np.random.default_rng(d)
    terms = rng.standard_normal((m, 2 * d)).astype(np.float32)
    plan = k8.norm_bwd_plan(m, d, [torch.float32] * 4)
    orders = [np.arange(plan.blocks), np.arange(plan.blocks)[::-1],
              rng.permutation(plan.blocks)]
    sums = [_column_sum(_partial_rows(terms, plan, order)) for order in orders]
    for got in sums[1:]:
        assert got.tobytes() == sums[0].tobytes()
    exact = terms.astype(np.float64).sum(0)
    assert np.abs(sums[0] - exact).max() <= 1e-5 * np.abs(terms).sum(0).max()
