"""K7 (whole-Block backward) and the Block's differentiated whole-block route
vs videomamba_tpu on the CPU.

The port's wrappers run their plain versions on CPU tensors; the JAX package
runs its Pallas kernels in interpret mode (VIDEOMAMBA_PALLAS_INTERPRET=1, as
tests/test_block_bwd.py does): block_fused_pallas with checkpoints and
block_bwd_pallas at block_l 16, so its kernel walks three time blocks and
carries its conv context between them. Inputs come from numpy seeds.
rel_err = max|a - b| / max|b|. Bars: gradients 2e-5 at fp32 and 2e-2 at
bf16 (tests/test_mixer_bwd.py:76, tests/test_block_bwd.py:115).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.checkpoint import params_to_torch_state_dict
from videomamba_tpu.models.block import _block_fused
from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.ops.pallas.block_bwd import block_bwd_pallas
from videomamba_tpu.ops.pallas.block_fused import block_fused_pallas
from videomamba_tpu.ops.pallas.mixer_fused import PACK, pack_weights
from videomamba_tpu_torch.checkpoint import load_state_dict, params_from_jax
from videomamba_tpu_torch.models.block import BlockFusedFn, create_block
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.kernels.block_bwd import block_bwd, block_bwd_plain
from videomamba_tpu_torch.ops.kernels.block_fused import block_fused_plain

GRAD_TOL = {"fp32": 2e-5, "bf16": 2e-2}
JDTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
CAST = ("hidden", "win", "wout", "conv_w", "conv_b", "wx", "wdt")
GRAD_NAMES = ("dres", "dnorm_w", "dnorm_b", "din_proj_w", "dout_proj_w", "dconv_w",
              "dconv_b", "dx_proj_w", "ddt_proj_w", "ddt_bias", "dA", "dD", "dh0",
              "dconv_state")


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def block_inputs(seed, with_state=True, b=2, L=37, e=64, di=128, n=16, r=4, w=4):
    """Block operands and cotangents in the JAX layouts, fp32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def normal(shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f)

    p = dict(
        hidden=normal((b, L, e)), residual=normal((b, L, e)),
        norm_w=(1 + normal((e,), 0.1)), norm_b=normal((e,), 0.1),
        win=normal((e, 2 * di), e ** -0.5), wout=normal((di, e), di ** -0.5),
        conv_w=normal((w, di), 0.5), conv_b=normal((di,), 0.1),
        wx=normal((di, r + 2 * n), di ** -0.5), wdt=normal((r, di), 0.3),
        A=-np.exp(normal((di, n), 0.3)), D=normal((di,)),
        dt_bias=np.linspace(-2.0, 0.5, di).astype(f),
        h0=normal((b, di, n), 0.2), conv_state=normal((b, di, w)),
        g_out=normal((b, L, e)), g_res=normal((b, L, e), 0.3),
        g_hlast=normal((b, di, n), 0.3),
    )
    if not with_state:
        p["h0"] = np.zeros_like(p["h0"])
        p["conv_state"] = np.zeros_like(p["conv_state"])
    return p


def torch_weights(t):
    """The JAX-layout weights of ``t`` (torch tensors) in the port's layouts."""
    return dict(in_proj_w=t["win"].t().contiguous(), out_proj_w=t["wout"].t().contiguous(),
                conv_w=t["conv_w"].t().contiguous(), conv_b=t["conv_b"],
                x_proj_w=t["wx"].t().contiguous(), dt_proj_w=t["wdt"].t().contiguous(),
                dt_bias=t["dt_bias"], A=t["A"], D=t["D"])


def jax_grads_in_torch_layouts(g, r, n):
    """block_bwd_pallas's outputs in the port's order and torch layouts."""
    (dres, dnw, dnb, dwin, dwout, dcw, dcb, dwxp, dwdtp, dbias, dA, dD, dh0, dcst) = g
    dwx = jnp.concatenate([dwxp[:, :r], dwxp[:, PACK:PACK + n],
                           dwxp[:, 2 * PACK:2 * PACK + n]], axis=1)
    return (dres, dnw, dnb, dwin.T, dwout.T, dcw.T, dcb, dwx.T, dwdtp[:r].T, dbias, dA, dD,
            dh0, dcst)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_block_bwd_plain_matches_pallas(dtype, norm_type, with_state):
    p = block_inputs(seed=21, with_state=with_state)
    r, n = p["wdt"].shape[0], p["A"].shape[1]
    jd, td = JDTYPE[dtype], TDTYPE[dtype]
    rms = norm_type == "rms"
    j = {k: jnp.asarray(v).astype(jd if k in CAST + ("g_out",) else jnp.float32)
         for k, v in p.items()}
    norm_b = None if rms else j["norm_b"]
    wx_pack, wdt_pack = pack_weights(j["wx"], j["wdt"], r, n)
    *_, hckpt = block_fused_pallas(
        j["hidden"], j["residual"], j["norm_w"], norm_b, j["win"], j["wout"], j["conv_w"],
        j["conv_b"], wx_pack, wdt_pack, j["A"], j["D"], j["dt_bias"], j["h0"],
        j["conv_state"], norm_rms=rms, eps=1e-5, residual_fp32=True, block_l=16,
        interpret=True, highest=dtype == "fp32", checkpoints=True,
    )
    res_out = j["hidden"].astype(jnp.float32) + j["residual"]
    jg = jax_grads_in_torch_layouts(block_bwd_pallas(
        res_out, j["norm_w"], norm_b, j["win"], j["wout"], j["conv_w"], j["conv_b"],
        wx_pack, wdt_pack, j["A"], j["D"], j["dt_bias"], j["conv_state"], hckpt,
        j["g_out"], j["g_res"], j["g_hlast"], norm_rms=rms, eps=1e-5,
        highest=dtype == "fp32", block_l=16, interpret=True,
    ), r, n)

    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    t = {k: v.to(td) if k in CAST + ("g_out",) else v for k, v in t.items()}
    w = torch_weights(t)
    tnorm_b = None if rms else t["norm_b"]
    *_, ckpt = block_fused_plain(t["hidden"], t["residual"], t["norm_w"], tnorm_b, h0=t["h0"],
                                 conv_state=t["conv_state"], norm_type=norm_type,
                                 checkpoints=True, **w)
    tres = t["hidden"].float() + t["residual"]
    got = block_bwd(tres, t["norm_w"], tnorm_b, conv_state=t["conv_state"], ckpt=ckpt,
                    g_out=t["g_out"], g_res=t["g_res"], g_hlast=t["g_hlast"],
                    norm_type=norm_type, **w)
    assert len(got) == len(GRAD_NAMES)
    for name, a, b in zip(GRAD_NAMES, got, jg):
        if name == "dnorm_b" and rms:
            continue  # RMSNorm has no shift: the caller drops it
        want_dtype = td if name in ("din_proj_w", "dout_proj_w", "dconv_w", "dconv_b",
                                    "dx_proj_w", "ddt_proj_w") else torch.float32
        assert a.dtype == want_dtype, name
        assert a.shape == b.shape, name
        assert rel_err(a, b) <= GRAD_TOL[dtype], (name, rel_err(a, b))


def test_block_bwd_wrapper_runs_plain_on_the_cpu():
    """On a CPU tensor the wrapper is its plain version and counts nothing."""
    p = block_inputs(seed=3, L=9)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    w = torch_weights(t)
    *_, ckpt = block_fused_plain(t["hidden"], t["residual"], t["norm_w"], None, h0=t["h0"],
                                 conv_state=t["conv_state"], checkpoints=True, **w)
    args = (t["hidden"] + t["residual"], t["norm_w"], None)
    kw = dict(conv_state=t["conv_state"], ckpt=ckpt, g_out=t["g_out"], g_res=t["g_res"],
              g_hlast=None, **w)
    before = block_bwd.launches
    got = block_bwd(*args, **kw)
    assert block_bwd.launches == before
    for a, b in zip(got, block_bwd_plain(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend,dtype", [("fused", "fp32"), ("composite", "fp32"),
                                           ("fused", "bf16"), ("composite", "bf16")])
def test_block_fused_fn_grads_match_jax(monkeypatch, backend, dtype):
    """jax.grad through the JAX package's ``_block_fused`` (K4 with hckpt,
    then K7 or the composite recompute) against backward through
    BlockFusedFn on the same loss, every differentiable input; the backend
    switch is one environment variable for both packages."""
    monkeypatch.setenv("VIDEOMAMBA_BLOCK_BWD", backend)
    assert dispatch.block_bwd_backend() == backend
    p = block_inputs(seed=31, L=20)
    jd, td = JDTYPE[dtype], TDTYPE[dtype]
    names = ("hidden", "residual", "norm_w", "norm_b", "win", "wout", "conv_w", "conv_b",
             "wx", "wdt", "dt_bias", "A", "D", "h0", "conv_state")
    j = [jnp.asarray(p[k]).astype(jd if k in CAST else jnp.float32) for k in names]
    go, gr, gh = (jnp.asarray(p[k]) for k in ("g_out", "g_res", "g_hlast"))

    def jloss(*args):
        out, res, h = _block_fused(*args, False, 1e-5, True)
        return (jnp.sum(out.astype(jnp.float32) * go) + jnp.sum(res * gr)
                + jnp.sum(h * gh))

    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(*j)

    t = {k: torch.from_numpy(np.ascontiguousarray(p[k])).to(td if k in CAST else torch.float32)
         .requires_grad_() for k in names}
    w = torch_weights(t)
    out, res, h = BlockFusedFn.apply(
        t["hidden"], t["residual"], t["norm_w"], t["norm_b"], w["in_proj_w"],
        w["out_proj_w"], w["conv_w"], w["conv_b"], w["x_proj_w"], w["dt_proj_w"],
        w["dt_bias"], w["A"], w["D"], t["h0"], t["conv_state"], "layer", 1e-5, True)
    tgo, tgr, tgh = (torch.from_numpy(p[k]) for k in ("g_out", "g_res", "g_hlast"))
    ((out.float() * tgo).sum() + (res * tgr).sum() + (h * tgh).sum()).backward()
    for k, jg in zip(names, jgrads):
        g = t[k].grad
        assert g is not None and g.dtype == t[k].dtype, k
        assert rel_err(g, jg) <= GRAD_TOL[dtype], (k, rel_err(g, jg))


@pytest.mark.parametrize("width", [9, 12])
def test_block_bwd_plain_matches_jax_at_wide_convs(monkeypatch, width):
    """A whole-block Block with d_conv 9 or 12: backward through
    BlockFusedFn (K7's plain version, its conv weight gradient at any width)
    against jax.grad through the JAX package's ``_block_fused``, fp32. The
    JAX package's whole-block backward kernel keeps 8 rows of conv-tap sums
    (block_bwd.py:100), so its gradients come from its composite route."""
    p = block_inputs(seed=70 + width, L=20, w=width)
    names = ("hidden", "residual", "norm_w", "norm_b", "win", "wout", "conv_w", "conv_b",
             "wx", "wdt", "dt_bias", "A", "D", "h0", "conv_state")
    j = [jnp.asarray(p[k]) for k in names]
    go, gr, gh = (jnp.asarray(p[k]) for k in ("g_out", "g_res", "g_hlast"))

    def jloss(*args):
        out, res, h = _block_fused(*args, True, 1e-5, True)
        return jnp.sum(out * go) + jnp.sum(res * gr) + jnp.sum(h * gh)

    monkeypatch.setenv("VIDEOMAMBA_BLOCK_BWD", "composite")
    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(*j)
    monkeypatch.setenv("VIDEOMAMBA_BLOCK_BWD", "fused")
    t = {k: torch.from_numpy(np.ascontiguousarray(p[k])).requires_grad_() for k in names}
    w = torch_weights(t)
    out, res, h = BlockFusedFn.apply(
        t["hidden"], t["residual"], t["norm_w"], None, w["in_proj_w"],
        w["out_proj_w"], w["conv_w"], w["conv_b"], w["x_proj_w"], w["dt_proj_w"],
        w["dt_bias"], w["A"], w["D"], t["h0"], t["conv_state"], "rms", 1e-5, True)
    before = block_bwd.launches
    tgo, tgr, tgh = (torch.from_numpy(p[k]) for k in ("g_out", "g_res", "g_hlast"))
    ((out * tgo).sum() + (res * tgr).sum() + (h * tgh).sum()).backward()
    assert block_bwd.launches == before  # the plain version on the CPU
    assert t["conv_w"].grad.shape == (width, 128)
    for k, jg in zip(names, jgrads):
        if k == "norm_b":
            continue  # RMSNorm has no shift
        assert rel_err(t[k].grad, jg) <= GRAD_TOL["fp32"], (k, rel_err(t[k].grad, jg))


GEOM = dict(img_size=16, patch_size=8, depth=2, embed_dim=64, channels=3,
            kernel_size=1, num_frames=4, add_pool_norm=False)


def test_eval_model_grads_match_jax():
    """Eval mode takes the whole-block route in both packages; a loss on
    x_vis reaches every parameter through K4 and K7 (the JAX package's
    deterministic=True gradients)."""
    jm = JModel(**GEOM, rng=0)
    tm = TModel(**GEOM, device="cpu").eval()
    load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
    assert all(layer._use_block_fused() for layer in tm.layers)
    rng = np.random.default_rng(4)
    video = rng.standard_normal((2, 3, 4, 16, 16)).astype(np.float32)
    target = rng.standard_normal((2, 17, 64)).astype(np.float32)

    def jloss(params):
        x_vis = jm.apply(params, jnp.asarray(video), deterministic=True)
        return jnp.mean(jnp.square(x_vis - jnp.asarray(target)))

    jgrads = jax.grad(jloss)(jm.params)
    view = copy.copy(jm)
    view.params = jax.tree.map(np.asarray, jgrads)
    want = params_to_torch_state_dict(view)

    x_vis = tm(torch.from_numpy(video))
    (x_vis - torch.from_numpy(target)).square().mean().backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert set(want) == set(grads)
    for name, g in want.items():
        assert grads[name] is not None, name
        assert rel_err(grads[name], g) <= GRAD_TOL["fp32"], (name, rel_err(grads[name], g))


def test_eval_block_routes_its_backward_through_block_fused_fn():
    """The fault this route repairs: a whole-block call under autograd must
    keep the graph (parameters get gradients) and run BlockFusedFn; without
    grad it is the bare kernel call."""
    block = create_block(64, device="cpu").eval()
    assert block._use_block_fused()
    h = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(0))
    out, res = block(h, residual=torch.zeros(2, 9, 64))
    assert out.grad_fn is not None and "BlockFusedFn" in type(out.grad_fn).__name__
    out.float().square().sum().backward()
    assert all(p.grad is not None for p in block.parameters())
    with torch.no_grad():
        out2, _ = block(h, residual=torch.zeros(2, 9, 64))
    assert out2.grad_fn is None and torch.equal(out2, out.detach())
