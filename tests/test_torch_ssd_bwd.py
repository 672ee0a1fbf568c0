"""The Mamba-2 (SSD) training kernels' plain versions vs videomamba_tpu on the CPU.

K11 (the bare chunk scan, forward and backward), K13 (the mixer backward,
behind ``SsdMixerFn``) and K14's backward (behind ``SsdPmixerFn``), each run
through its autograd Function on CPU tensors, where the wrappers take their
plain versions, against ``jax.grad`` of the JAX package's Pallas kernels in
interpret mode (VIDEOMAMBA_PALLAS_INTERPRET=1, as tests/test_pallas_ssd.py
runs them): ``ssd_core_pallas``, ``ssd_mixer_pallas`` under both arms of
VIDEOMAMBA_SSD_FWD_MERGED and VIDEOMAMBA_SSD_BWD_MERGED, and
``ssd_projected_mixer`` under both VIDEOMAMBA_SSD_TRAIN_ROUTE values. Tiny
widths (H 4, P 8, N 8, chunk 16, L 35-37, not a multiple of the chunk),
numpy-seeded inputs. rel_err = max|a - b| / max|b|. Bars: fp32 2e-5 (the
JAX package's bar between its merged and per-head arms,
tests/test_pallas_ssd.py), bf16 2e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.ops.pallas.ssd_block import ssd_projected_mixer as j_pmixer
from videomamba_tpu.ops.pallas.ssd_scan import ssd_core_pallas as j_core
from videomamba_tpu.ops.pallas.ssd_scan import ssd_mixer_pallas as j_mixer
from videomamba_tpu_torch.ops.kernels import ssd_core as k11
from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13
from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14
from videomamba_tpu_torch.ops.ssd import _prepare_dt

TOL = {"fp32": 2e-5, "bf16": 2e-2}
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
H, P, N, Q, W = 4, 8, 8, 16, 4


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a.astype(jnp.float32)).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def assert_close(got, want, tol, names):
    for name, g_, w_ in zip(names, got, want):
        if w_ is None:
            assert g_ is None, name
            continue
        assert tuple(g_.shape) == tuple(w_.shape), name
        assert rel_err(g_, w_) <= tol, f"{name}: {rel_err(g_, w_):.3e}"


def pair(arrays: dict, dtype: str, cast: tuple):
    """The same numpy arrays as leaf torch tensors (requiring grad) and jax
    arrays; names in ``cast`` take the compute dtype, the rest fp32."""
    tdt, jdt = DTYPES[dtype]
    t, j = {}, {}
    for k, v in arrays.items():
        if v is None:
            t[k] = j[k] = None
            continue
        t[k] = torch.from_numpy(v).to(tdt if k in cast else torch.float32).requires_grad_()
        j[k] = jnp.asarray(v).astype(jdt if k in cast else jnp.float32)
    return t, j


def rounded(a, dtype):
    """a rounded to the compute dtype (as fp32): both packages see one value."""
    return torch.from_numpy(a.astype(np.float32)).to(DTYPES[dtype][0]).float().numpy()


# --------------------------------------------------------------- K11


def core_inputs(seed, g, dtype, with_h0, seqlen=37, b=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rounded(rng.standard_normal((b, seqlen, H, P)), dtype),
        dt=np.log1p(np.exp(0.5 * rng.standard_normal((b, seqlen, H)))).astype(f),
        A=-np.exp(0.5 * rng.standard_normal(H)).astype(f),
        B=rounded(rng.standard_normal((b, seqlen, g, N)), dtype),
        C=rounded(rng.standard_normal((b, seqlen, g, N)), dtype),
        h0=(0.3 * rng.standard_normal((b, H, P, N))).astype(f) if with_h0 else None,
    )


@pytest.mark.parametrize("ngroups,dtype,with_h0", [
    (1, "fp32", True), (2, "fp32", False), (1, "bf16", True), (2, "bf16", False)])
def test_k11_forward_and_backward_match_jax(monkeypatch, ngroups, dtype, with_h0):
    """K11's plain version (SsdCoreFn on CPU tensors) against JAX
    ssd_core_pallas: y, h_last and the gradients of x, dt, A, B, C and h0,
    in the primals' dtypes."""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    a = core_inputs(20 + ngroups, ngroups, dtype, with_h0)
    t, j = pair(a, dtype, cast=("x", "B", "C"))
    rng = np.random.default_rng(7)
    gy = rng.standard_normal(a["x"].shape).astype(np.float32)
    gh = rng.standard_normal((2, H, P, N)).astype(np.float32)
    names = ("x", "dt", "A", "B", "C", "h0")

    def j_loss(*args):
        y, hl = j_core(*args, chunk_size=Q)
        return jnp.sum(y * gy) + jnp.sum(hl * gh), (y, hl)

    argnums = tuple(i for i, k in enumerate(names) if j[k] is not None)
    (_, (jy, jh)), jgrads = jax.value_and_grad(j_loss, argnums=argnums, has_aux=True)(
        *[j[k] for k in names])
    before = k11.ssd_scan.launches, k11.ssd_scan_bwd.launches
    ty, th = k11.ssd_core_pallas(*[t[k] for k in names], Q)
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    assert rel_err(ty, jy) <= TOL[dtype] and rel_err(th, jh) <= TOL[dtype]
    (ty * torch.from_numpy(gy)).sum().add((th * torch.from_numpy(gh)).sum()).backward()
    got = [t[names[i]].grad for i in argnums]
    for i, g_ in zip(argnums, got):
        assert g_.dtype == t[names[i]].dtype, names[i]
    assert_close(got, jgrads, TOL[dtype], [names[i] for i in argnums])
    assert (k11.ssd_scan.launches, k11.ssd_scan_bwd.launches) == before  # plain on the CPU


# ---------------------------------------------------------- K13 / K14


def mixer_inputs(seed, g, dtype, with_state, seqlen=35, b=2, e=32, w=W):
    rng = np.random.default_rng(seed)
    f = np.float32
    di = H * P
    cd = di + 2 * g * N
    dpj = di + cd + H
    return dict(
        zx=rounded(rng.standard_normal((b, seqlen, dpj)), dtype),
        hidden=rounded(rng.standard_normal((b, seqlen, e)), dtype),
        in_w=rounded(rng.standard_normal((dpj, e)) * e ** -0.5, dtype),
        out_w=rounded(rng.standard_normal((e, di)) * di ** -0.5, dtype),
        cw=rounded(0.3 * rng.standard_normal((cd, w)), dtype),
        cb=rounded(0.1 * rng.standard_normal(cd), dtype),
        D=(0.5 * rng.standard_normal(H)).astype(f),
        dtb=(0.1 * rng.standard_normal(H)).astype(f),
        nw=(1 + 0.1 * rng.standard_normal(di)).astype(f),
        h0=(0.2 * rng.standard_normal((b, H, P, N))).astype(f) if with_state else None,
        cst=rounded(0.2 * rng.standard_normal((b, cd, w)), dtype) if with_state else None,
        A=-np.exp(0.2 * rng.standard_normal(H)).astype(f),
    )


MIXER_NAMES = ("zx", "cw", "cb", "D", "dtb", "nw", "h0", "cst", "A")
CAST = ("zx", "hidden", "in_w", "out_w", "cw", "cb", "cst")


def cfg(g):
    return dict(chunk_size=Q, nheads=H, hdim=P, ngroups=g, d_state=N)


def j_mixer_grads(j, g, use_norm):
    """(y, h_last) and jax.grad of the test loss through JAX ssd_mixer_pallas."""
    names = [k for k in MIXER_NAMES if j[k] is not None and (k != "nw" or use_norm)]

    def loss(*args):
        kw = dict(zip(names, args))
        y, hl = j_mixer(kw["zx"], kw["A"], kw["cw"].T, kw["cb"], kw["D"], kw["dtb"],
                        initial_state=kw.get("h0"), conv_state=kw.get("cst"),
                        norm_weight=kw.get("nw"), **cfg(g))
        return jnp.sum(y.astype(jnp.float32) ** 2) * 0.5 + jnp.sum(hl ** 2) * 0.25

    return names, jax.grad(loss, argnums=tuple(range(len(names))))(*[j[k] for k in names])


def t_mixer_grads(t, g, use_norm, names):
    """The port's gradients of the same loss through SsdMixerFn."""
    di = H * P
    cd = di + 2 * g * N
    dt_p = _prepare_dt(t["zx"][..., di + cd:], t["dtb"], True)
    y, hl = k13.SsdMixerFn.apply(
        t["zx"], dt_p, t["A"], t["cw"], t["cb"], t["D"], t["h0"], t["cst"],
        t["nw"] if use_norm else None, (1e-5, Q, H, P, g, N))
    loss = y.float().square().sum() * 0.5 + hl.square().sum() * 0.25
    loss.backward()
    return [t[k].grad for k in names]


@pytest.mark.parametrize("fwd,bwd,ngroups,dtype,use_norm,with_state", [
    ("1", "1", 1, "fp32", True, True),
    ("1", "0", 1, "fp32", True, True),
    ("0", "1", 1, "fp32", True, True),
    ("0", "0", 1, "fp32", False, False),
    ("0", "0", 2, "fp32", True, True),
    ("1", "1", 1, "bf16", True, True),
    ("0", "0", 2, "bf16", False, True),
])
def test_k13_matches_both_jax_arms(monkeypatch, fwd, bwd, ngroups, dtype, use_norm,
                                   with_state):
    """K13's plain version against jax.grad through JAX ssd_mixer_pallas
    (its fused backward) under each VIDEOMAMBA_SSD_FWD_MERGED /
    VIDEOMAMBA_SSD_BWD_MERGED arm: dzxbcdt (the dt lanes through softplus
    and dt_bias), the conv taps, bias and window, D, dt_bias, the norm
    weight, h0 and A."""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VIDEOMAMBA_SSD_FWD_MERGED", fwd)
    monkeypatch.setenv("VIDEOMAMBA_SSD_BWD_MERGED", bwd)
    monkeypatch.setenv("VIDEOMAMBA_SSD_BWD", "fused")
    a = mixer_inputs(30 + ngroups, ngroups, dtype, with_state)
    t, j = pair({k: a[k] for k in MIXER_NAMES}, dtype, CAST)
    names, want = j_mixer_grads(j, ngroups, use_norm)
    before = k13.ssd_mixer_bwd.launches
    got = t_mixer_grads(t, ngroups, use_norm, names)
    for name, g_ in zip(names, got):
        assert g_.dtype == t[name].dtype, name
    assert_close(got, want, TOL[dtype], names)
    assert k13.ssd_mixer_bwd.launches == before  # plain on the CPU


@pytest.mark.parametrize("width", [9, 12])
def test_k13_matches_jax_at_wide_convs(monkeypatch, width):
    """A Mamba2(d_conv=9 or 12) layer's mixer: K13's plain version (its
    conv weight gradient at any width) against jax.grad through JAX
    ssd_mixer_pallas, fp32, every gradient. Both arms of the JAX package's
    fused mixer backward keep 8 rows of conv-tap sums (``dcw_scr``,
    ssd_scan.py:951-980 loops over the taps into it), so the JAX gradients
    come from its composite backward (autodiff of the conv and gate around
    its chunk-scan backward)."""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    a = mixer_inputs(80 + width, 1, "fp32", True, w=width)
    t, j = pair({k: a[k] for k in MIXER_NAMES}, "fp32", CAST)
    monkeypatch.setenv("VIDEOMAMBA_SSD_BWD", "composite")
    names, want = j_mixer_grads(j, 1, True)
    monkeypatch.setenv("VIDEOMAMBA_SSD_BWD", "fused")
    before = k13.ssd_mixer_bwd.launches
    got = t_mixer_grads(t, 1, True, names)
    assert t["cw"].grad.shape == (H * P + 2 * N, width)
    assert_close(got, want, TOL["fp32"], names)
    assert k13.ssd_mixer_bwd.launches == before  # plain on the CPU


@pytest.mark.parametrize("ngroups,use_norm,with_state", [(2, True, True), (1, False, False)])
def test_k13_composite_matches_fused(monkeypatch, ngroups, use_norm, with_state):
    """The composite backward (VIDEOMAMBA_SSD_BWD=composite: torch conv
    recompute and epilogue autograd around K11's backward) against K13 in
    the port (2e-5), and against JAX's composite backward."""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    a = mixer_inputs(40 + ngroups, ngroups, "fp32", with_state)
    grads = {}
    for mode in ("fused", "composite"):
        monkeypatch.setenv("VIDEOMAMBA_SSD_BWD", mode)
        t, j = pair({k: a[k] for k in MIXER_NAMES}, "fp32", CAST)
        names = [k for k in MIXER_NAMES if t[k] is not None and (k != "nw" or use_norm)]
        grads[mode] = t_mixer_grads(t, ngroups, use_norm, names)
    assert_close(grads["composite"], grads["fused"], 2e-5, names)
    _, want = j_mixer_grads(j, ngroups, use_norm)  # JAX composite (the env is still set)
    assert_close(grads["composite"], want, 2e-5, names)


PMIXER_NAMES = ("hidden", "in_w", "out_w", "cw", "cb", "D", "dtb", "nw", "A")


@pytest.mark.parametrize("route,dtype", [("mixer", "fp32"), ("pmixer", "fp32"),
                                         ("pmixer", "bf16")])
def test_k14_backward_matches_jax(monkeypatch, route, dtype):
    """The port's route for a differentiated projected-mixer layer (its
    plain versions: on "mixer", Mamba2._kernel_route's torch projections
    around SsdMixerFn, K12 and K13; on "pmixer", SsdPmixerFn, K14's
    backward) against jax.grad through JAX ssd_projected_mixer on the same
    VIDEOMAMBA_SSD_TRAIN_ROUTE: the output and the gradients of the input,
    both projection weights, the conv, D, dt_bias, the norm weight and A."""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VIDEOMAMBA_SSD_TRAIN_ROUTE", route)
    a = mixer_inputs(50, 1, dtype, False, e=128)
    t, j = pair({k: a[k] for k in PMIXER_NAMES}, dtype, CAST)

    def j_loss(*args):
        kw = dict(zip(PMIXER_NAMES, args))
        y, hl = j_pmixer(kw["hidden"], kw["A"], kw["in_w"].T, kw["out_w"].T, kw["cw"].T,
                         kw["cb"], kw["D"], kw["dtb"], norm_weight=kw["nw"], **cfg(1))
        return jnp.sum(y.astype(jnp.float32) ** 2) * 0.5 + jnp.sum(hl ** 2) * 0.25, y

    (_, jy), want = jax.value_and_grad(j_loss, argnums=tuple(range(len(PMIXER_NAMES))),
                                       has_aux=True)(*[j[k] for k in PMIXER_NAMES])
    before = (k13.ssd_mixer_bwd.launches, k14.ssd_pmixer_bwd.launches)
    weights = (t["cw"], t["cb"], t["D"], None, None, t["nw"], (1e-5, Q, H, P, 1, N))
    if route == "pmixer":
        dt_p = k14.dt_projection(t["hidden"], t["in_w"], H, t["dtb"])
        y, hl = k14.SsdPmixerFn.apply(t["hidden"], dt_p, t["A"], t["in_w"], t["out_w"],
                                      *weights)
    else:
        zx = t["hidden"] @ t["in_w"].t()
        dt_p = _prepare_dt(zx[..., 2 * H * P + 2 * N:], t["dtb"], True)
        gated, hl = k13.SsdMixerFn.apply(zx, dt_p, t["A"], *weights)
        y = gated @ t["out_w"].t()
    assert rel_err(y, jy) <= TOL[dtype]
    (y.float().square().sum() * 0.5 + hl.square().sum() * 0.25).backward()
    got = [t[k].grad for k in PMIXER_NAMES]
    assert_close(got, want, TOL[dtype], PMIXER_NAMES)
    # plain on the CPU
    assert (k13.ssd_mixer_bwd.launches, k14.ssd_pmixer_bwd.launches) == before
