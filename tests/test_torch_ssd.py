"""The SSD (Mamba-2) ops and the plain versions of K12 and K14 vs videomamba_tpu on the CPU.

``ops/ssd.py`` against ``videomamba_tpu.ops.ssd``; the K12 and K14 wrappers
(their plain versions on CPU tensors) against the JAX package's Pallas
kernels ``ssd_mixer_pallas`` and ``ssd_projected_mixer`` run in interpret
mode (VIDEOMAMBA_PALLAS_INTERPRET=1, as tests/test_pallas_ssd.py runs them),
under both arms of VIDEOMAMBA_SSD_FWD_MERGED (merged and per-head). Inputs
come from numpy seeds. rel_err = max|a - b| / max|b|. Bars: the ops fp32
1e-5; the kernels fp32 2e-5 (the JAX package's merged-vs-per-head bar,
tests/test_pallas_ssd.py) and bf16 1e-2 (the arms round at different
points).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videomamba_tpu.ops import ssd as jssd
from videomamba_tpu.ops.pallas.ssd_block import ssd_projected_mixer as j_pmixer
from videomamba_tpu.ops.pallas.ssd_scan import ssd_mixer_pallas as j_mixer
from videomamba_tpu_torch.ops import ssd as tssd
from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

TOL = {"fp32": 2e-5, "bf16": 1e-2}
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def scan_inputs(seed, g, b=2, seqlen=37, h=4, p=8, n=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((b, seqlen, h, p)).astype(f),
        dt=(0.5 * rng.standard_normal((b, seqlen, h))).astype(f),
        A=-np.exp(0.5 * rng.standard_normal(h)).astype(f),
        B=rng.standard_normal((b, seqlen, g, n)).astype(f),
        C=rng.standard_normal((b, seqlen, g, n)).astype(f),
        D=rng.standard_normal(h).astype(f),
        z=rng.standard_normal((b, seqlen, h, p)).astype(f),
        dt_bias=(0.3 * rng.standard_normal(h)).astype(f),
        initial_state=(0.3 * rng.standard_normal((b, h, p, n))).astype(f),
    )


@pytest.mark.parametrize("ngroups", [1, 2])
@pytest.mark.parametrize("fn", ["ssd_ref", "ssd_chunked", "ssd_chunked_ref_core"])
def test_ssd_ops_match_jax(fn, ngroups):
    """The oracle and the chunked form (with D, z, dt_bias and h0) return
    JAX's y and final state."""
    kw = scan_inputs(1, ngroups)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    if fn == "ssd_ref":
        want = jssd.ssd_ref(**jkw, return_last_state=True)
        got = tssd.ssd_ref(**tkw, return_last_state=True)
    else:
        want = jssd.ssd_chunked(**jkw, return_last_state=True, chunk_size=16)
        got = tssd.ssd_chunked(**tkw, return_last_state=True, chunk_size=16,
                               method="ref" if fn == "ssd_chunked_ref_core" else "chunked")
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        assert rel_err(g_, w_) <= 1e-5


@pytest.mark.parametrize("ngroups", [1, 2])
def test_ssd_core_chunked_matches_jax(ngroups):
    kw = scan_inputs(2, ngroups, seqlen=24)
    dt_p = np.log1p(np.exp(kw["dt"]))
    args = (kw["x"], dt_p, kw["A"], kw["B"], kw["C"], kw["initial_state"])
    want = jssd.ssd_core_chunked(*map(jnp.asarray, args), chunk_size=8)
    got = tssd.ssd_core_chunked(*map(torch.from_numpy, args), chunk_size=8)
    for g_, w_ in zip(got, want):
        assert rel_err(g_, w_) <= 1e-5


def test_ssd_chunked_bf16_tracks_jax():
    kw = scan_inputs(3, 1)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    jkw["x"], tkw["x"] = jkw["x"].astype(jnp.bfloat16), tkw["x"].bfloat16()
    want = jssd.ssd_chunked(**jkw, chunk_size=16)
    got = tssd.ssd_chunked(**tkw, chunk_size=16)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= 1e-2


@pytest.mark.parametrize("ngroups", [1, 2])
def test_ssd_chunked_pallas_method_matches_jax(ngroups, monkeypatch):
    """method="pallas" runs K11 (its plain version on the CPU) forward and
    backward, against the JAX package's ssd_core_pallas in interpret mode:
    y, the final state and every input's gradient (fp32 2e-5)."""
    import jax

    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    kw = scan_inputs(4, ngroups)
    names = ("x", "dt", "A", "B", "C", "D", "z", "dt_bias", "initial_state")
    rng = np.random.default_rng(40)
    gy = rng.standard_normal(kw["x"].shape).astype(np.float32)
    gh = rng.standard_normal(kw["initial_state"].shape).astype(np.float32)

    def j_loss(*args):
        y, h = jssd.ssd_chunked(**dict(zip(names, args)), return_last_state=True,
                                chunk_size=16, method="pallas")
        return jnp.sum(y * gy) + jnp.sum(h * gh), (y, h)

    jargs = [jnp.asarray(kw[k]) for k in names]
    (_, (jy, jh)), jgrads = jax.value_and_grad(j_loss, argnums=tuple(range(9)),
                                                 has_aux=True)(*jargs)
    targs = [torch.from_numpy(kw[k]).requires_grad_() for k in names]
    ty, th = tssd.ssd_chunked(**dict(zip(names, targs)), return_last_state=True,
                              chunk_size=16, method="pallas")
    assert rel_err(ty, jy) <= 2e-5 and rel_err(th, jh) <= 2e-5
    (ty * torch.from_numpy(gy)).sum().add((th * torch.from_numpy(gh)).sum()).backward()
    for name, a, g_ in zip(names, targs, jgrads):
        assert a.grad.shape == g_.shape, name
        assert rel_err(a.grad, g_) <= 2e-5, name


@pytest.mark.parametrize("full", [True, False])
def test_ssd_state_update_matches_jax(full):
    rng = np.random.default_rng(5)
    b, h, p, g, n = 3, 4, 8, 2, 8
    f = np.float32
    args = dict(
        state=rng.standard_normal((b, h, p, n)).astype(f),
        x_t=rng.standard_normal((b, h, p)).astype(f),
        dt_t=(0.5 * rng.standard_normal((b, h))).astype(f),
        A=-np.exp(rng.standard_normal(h)).astype(f),
        B_t=rng.standard_normal((b, g, n)).astype(f),
        C_t=rng.standard_normal((b, g, n)).astype(f),
    )
    if full:
        args.update(D=rng.standard_normal(h).astype(f), z_t=rng.standard_normal((b, h, p)).astype(f),
                    dt_bias=rng.standard_normal(h).astype(f))
    want = jssd.ssd_state_update(**{k: jnp.asarray(v) for k, v in args.items()})
    got = tssd.ssd_state_update(**{k: torch.from_numpy(v) for k, v in args.items()})
    for g_, w_ in zip(got, want):
        assert rel_err(g_, w_) <= 1e-5


# ----------------------------------------------------------- K12 and K14

GEOM = dict(e=128, h=8, p=32, n=16, q=16, w=4)


def mixer_inputs(seed, ngroups, dtype, with_state, b=2, seqlen=40):
    """Operands at the shapes a Mamba2 layer gives K12 / K14, as numpy:
    weights and activations already rounded to ``dtype`` where the model
    stores them in it."""
    rng = np.random.default_rng(seed)
    f = np.float32
    e, h, p, n, w = GEOM["e"], GEOM["h"], GEOM["p"], GEOM["n"], GEOM["w"]
    di = h * p
    cd = di + 2 * ngroups * n
    dpj = di + cd + h

    def rounded(a):
        return f64(torch.from_numpy(a.astype(f)).to(DTYPES[dtype][0]).float()).astype(f)

    return dict(
        hidden=rounded(rng.standard_normal((b, seqlen, e))),
        zxbcdt=rounded(rng.standard_normal((b, seqlen, dpj))),
        in_proj=rounded(rng.standard_normal((dpj, e)) * e ** -0.5),
        out_proj=rounded(rng.standard_normal((e, di)) * di ** -0.5),
        conv_w=rounded(0.5 * rng.standard_normal((cd, w))),
        conv_b=rounded(0.2 * rng.standard_normal(cd)),
        A=-np.exp(0.5 * rng.standard_normal(h)).astype(f),
        D=rng.standard_normal(h).astype(f),
        dt_bias=rounded(np.log(np.expm1(np.linspace(0.01, 0.3, h)))),
        norm_w=(1 + 0.1 * rng.standard_normal(di)).astype(f),
        h0=(0.3 * rng.standard_normal((b, h, p, n))).astype(f) if with_state else None,
        conv_state=rng.standard_normal((b, cd, w)).astype(f) if with_state else None,
    )


def run_pair(kind, monkeypatch, merged, ngroups, dtype, use_norm, with_state):
    """(port, JAX) outputs of K12 or K14 on the same operands."""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VIDEOMAMBA_SSD_FWD_MERGED", merged)
    a = mixer_inputs(10 + ngroups, ngroups, dtype, with_state)
    tdt, jdt = DTYPES[dtype]

    def t(name, cast=False):
        v = a[name]
        return None if v is None else torch.from_numpy(v).to(tdt if cast else torch.float32)

    def j(name, cast=False, transpose=False):
        v = a[name]
        if v is None:
            return None
        v = v.T if transpose else v
        return jnp.asarray(v).astype(jdt if cast else jnp.float32)

    cfg = dict(norm_eps=1e-5, chunk_size=GEOM["q"], nheads=GEOM["h"], hdim=GEOM["p"],
               ngroups=ngroups, d_state=GEOM["n"])
    common_t = (t("conv_w", True), t("conv_b", True), t("D"), t("dt_bias", True))
    common_j = dict(conv_weight=j("conv_w", True, True), conv_bias=j("conv_b", True),
                    D=j("D"), dt_bias=j("dt_bias", True))
    state_t = dict(initial_state=t("h0"), conv_state=t("conv_state"),
                   norm_weight=t("norm_w") if use_norm else None)
    state_j = dict(initial_state=j("h0"), conv_state=j("conv_state"),
                   norm_weight=j("norm_w") if use_norm else None)
    if kind == "ssd_mixer":
        got = k12.ssd_mixer(t("zxbcdt", True), t("A"), *common_t, **state_t, **cfg)
        want = j_mixer(j("zxbcdt", True), j("A"), **common_j, **state_j, **cfg)
    else:
        got = k14.ssd_pmixer(t("hidden", True), t("A"), t("in_proj", True),
                             t("out_proj", True), *common_t, **state_t, **cfg)
        want = j_pmixer(j("hidden", True), j("A"), in_proj=j("in_proj", True, True),
                        out_proj=j("out_proj", True, True), **common_j, **state_j, **cfg)
    return got, want


CASES = [("1", 1, "fp32", True, True), ("0", 1, "fp32", True, True),
         ("1", 1, "fp32", False, False), ("0", 2, "fp32", True, True),
         ("1", 1, "bf16", True, True), ("0", 1, "bf16", True, True)]


@pytest.mark.parametrize("merged,ngroups,dtype,use_norm,with_state", CASES)
@pytest.mark.parametrize("kind", ["ssd_mixer", "ssd_pmixer"])
def test_plain_versions_match_both_jax_arms(kind, monkeypatch, merged, ngroups, dtype,
                                            use_norm, with_state):
    """K12's and K14's plain versions against the JAX kernels in interpret
    mode, merged (VIDEOMAMBA_SSD_FWD_MERGED=1, ngroups 1) and per-head
    (=0, or any ngroups > 1): the output and h_last."""
    before = (k12.ssd_mixer.launches, k14.ssd_pmixer.launches)
    (out, h_last), (j_out, j_hlast) = run_pair(kind, monkeypatch, merged, ngroups, dtype,
                                               use_norm, with_state)
    assert out.dtype == DTYPES[dtype][0] and h_last.dtype == torch.float32
    assert out.shape == j_out.shape and h_last.shape == j_hlast.shape
    assert rel_err(out, j_out) <= TOL[dtype]
    assert rel_err(h_last, j_hlast) <= TOL[dtype]
    assert (k12.ssd_mixer.launches, k14.ssd_pmixer.launches) == before  # plain on the CPU


def test_kernel_shape_gate():
    """The Hopper kernels' own gate: head dim and state multiples of 4 and
    the chunk-output tiles in one block's shared memory, which the 64-row
    slabs and the 64-wide head-dim and state tiles keep small at any P and
    N, so every shape the JAX package's kernels take (pallas_ssd_supported:
    head dim and state multiples of 8) passes, P = N = 256 included; the
    TPU's 128-lane chunk rule is not ported. The projected-mixer route
    keeps the JAX package's width and byte rule: Base and Small m2 pass at
    fp32 and bf16, Tiny and Middle (d_model % 128) do not."""
    from videomamba_tpu.ops.pallas.ssd_scan import pallas_ssd_supported

    assert k12.ssd_kernel_supported(24, 64, 1, 64, 128)
    assert k12.ssd_kernel_supported(8, 32, 2, 16, 16)
    assert k12.ssd_kernel_supported(24, 64, 1, 64, 256)
    assert k12.ssd_kernel_supported(24, 64, 1, 128, 256)
    assert k12.ssd_kernel_supported(24, 64, 1, 64, 100)
    for h, p, g, n, q in ((8, 256, 1, 256, 128), (6, 256, 1, 64, 128), (24, 64, 1, 256, 128),
                          (24, 64, 2, 64, 256), (8, 512, 1, 512, 128)):
        assert pallas_ssd_supported(h, p, g, n, q)
        assert k12.ssd_kernel_supported(h, p, g, n, q)
    assert not k12.ssd_kernel_supported(24, 62, 1, 64, 128)
    assert not k12.ssd_kernel_supported(24, 64, 5, 64, 128)
    for e, ok in ((768, True), (384, True), (192, False), (576, False)):
        h = 2 * e // 64
        assert k14.pmixer_route_ok(e, h, 64, 1, 64, 4) == ok
        assert k14.pmixer_route_ok(e, h, 64, 1, 64, 2) == ok


@pytest.mark.parametrize("bsz,ngroups,chunk,seqlen", [
    (1, 1, 128, 1569), (4, 1, 128, 1569), (1, 4, 128, 1569), (2, 2, 100, 250), (1, 1, 256, 300)])
def test_cb_scratch_and_chunk_smem(bsz, ngroups, chunk, seqlen):
    """The C B^T scratch (B, nc, G, Q, Q) fp32 that K12's and K13's tile
    launches share, allocated by the wrappers (3.4 MB at Base m2, B = 4),
    and the chunk kernels' shared-memory gate: K13's tile block at fp32,
    83,968 + 8 Q bytes, which takes every chunk below 18,560."""
    lp = -(-seqlen // chunk) * chunk
    elems = k12.cb_scratch_elems(bsz, lp, chunk, ngroups)
    assert elems == bsz * (lp // chunk) * ngroups * chunk * chunk
    if (bsz, ngroups, chunk) == (4, 1, 128):
        assert elems * 4 == 3_407_872
    zx = torch.zeros((bsz, seqlen, 2 * 64 + 2 * ngroups * 16 + 4))
    ops = k12.core_operands("ssd_mixer", zx, torch.full((bsz, seqlen, 4), 0.1),
                            -torch.ones(4), torch.zeros((64 + 2 * ngroups * 16, 4)), None,
                            torch.ones(4), None, None, None, chunk, 4, 16, ngroups, 16, seqlen)
    assert ops["cb"].numel() == elems and ops["cb"].dtype == torch.float32
    assert k12.chunk_smem_bytes(chunk) == 83_968 + 8 * chunk
    assert k12.ssd_kernel_supported(24, 64, 1, 64, 18_560)
    assert not k12.ssd_kernel_supported(24, 64, 1, 64, 18_561)


@pytest.mark.parametrize("chunk", [16, 64, 128, 256, 512])
def test_kernel_gates_take_every_jax_shape(chunk, monkeypatch):
    """Every shape the JAX package's kernels take (pallas_ssd_supported in
    interpret mode, the CPU tests' mode, which takes more chunks than the
    TPU) passes the Hopper chunk kernels' gate, and the projected-mixer
    route agrees with the JAX package's ssd_pmixer_supported at both weight
    widths."""
    from videomamba_tpu.ops.pallas.ssd_block import ssd_pmixer_supported
    from videomamba_tpu.ops.pallas.ssd_scan import pallas_ssd_supported

    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    for h, p, g, n in ((24, 64, 1, 64), (24, 64, 4, 64), (8, 256, 1, 256), (6, 256, 2, 128),
                       (8, 32, 2, 16), (16, 8, 8, 8), (12, 512, 3, 512)):
        assert pallas_ssd_supported(h, p, g, n, chunk)
        assert k12.ssd_kernel_supported(h, p, g, n, chunk)
        for e in (256, 384, 768, 192, 576):
            for wb in (2, 4):
                if ssd_pmixer_supported(e, h, p, g, n, chunk, wb):
                    assert k14.pmixer_route_ok(e, h, p, g, n, wb)
