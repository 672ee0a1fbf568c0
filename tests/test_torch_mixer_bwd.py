"""K3 with checkpoints and at bf16, and K6 (mixer backward), vs videomamba_tpu.

The port's ``MixerFusedFn`` (K3 forward with checkpoints, K6 backward;
plain versions on the CPU) against ``jax.grad`` through the JAX package's
``_fused_mixer`` under VIDEOMAMBA_MIXER_BWD=fused, its Pallas kernels in
interpret mode (as tests/test_mixer_bwd.py:23-25). Same numpy inputs, in
the JAX layouts there and the torch layouts here. rel_err =
max|a - b| / max|b|. Bars: 2e-5 at fp32 (tests/test_mixer_bwd.py:76),
2e-2 at bf16 weights and activations (tests/test_block_bwd.py:115); the
port's composite route against its fused route, 2e-5 at fp32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.models import mamba as M
from videomamba_tpu_torch.models.mamba import Mamba as TMamba, MixerFusedFn
from videomamba_tpu_torch.ops.kernels import mixer_bwd as k6
from videomamba_tpu_torch.ops.kernels import mixer_fused as k3

NAMES = ["dx", "dz", "dconv_w", "dconv_b", "dwx", "dwdt", "dbias", "dA", "dD",
         "dh0", "dconv_state"]
TOL = {"fp32": 2e-5, "bf16": 2e-2}
JDTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
# Operands in the compute dtype (the rest stay fp32), as cast_params_for_compute
# and a bf16 in_proj leave them.
CAST = ("x", "z", "conv_w", "conv_b", "wx", "wdt", "conv_state")
# Whether each gradient (in NAMES order) is in the compute dtype: a
# gradient comes back in its primal's dtype.
CAST_OF_GRAD = (True, True, True, True, True, True, False, False, False, False, True)


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


def mixer_inputs(seed, b=1, L=24, di=128, r=4, n=16, w=4):
    """Operands in the JAX layouts (conv (W, Di), wx (Di, R+2N), wdt (R, Di))."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def normal(shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f)

    p = dict(x=normal((b, L, di)), z=normal((b, L, di)), conv_w=normal((w, di), 0.5),
             conv_b=normal((di,), 0.1), wx=normal((di, r + 2 * n), di ** -0.5),
             wdt=normal((r, di), r ** -0.5), dt_bias=np.linspace(-4.0, -1.0, di).astype(f),
             A=-np.exp(normal((di, n), 0.3)), D=normal((di,)), h0=normal((b, di, n), 0.2),
             conv_state=normal((b, di, w), 0.5))
    return p, normal((b, L, di)), normal((b, di, n), 0.3)


def torch_layout(p, dtype):
    """The port's operands: torch layouts, CAST in ``dtype``, leaves."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    t["conv_w"] = t["conv_w"].t().contiguous()
    t["wx"] = t["wx"].t().contiguous()
    t["wdt"] = t["wdt"].t().contiguous()
    return {k: (v.to(dtype) if k in CAST else v).requires_grad_() for k, v in t.items()}


def port_grads(p, gy, ghl, dtype):
    t = torch_layout(p, dtype)
    y, hl = MixerFusedFn.apply(*t.values())
    ((y.float() * torch.from_numpy(gy)).sum() + (hl * torch.from_numpy(ghl)).sum()).backward()
    g = [v.grad for v in t.values()]
    # Back to the JAX layouts of conv_w, wx, wdt.
    g[2], g[4], g[5] = g[2].t(), g[4].t(), g[5].t()
    return y, g


def jax_grads(p, gy, ghl, dtype):
    jd = JDTYPE[dtype]
    args = [jnp.asarray(v).astype(jd if k in CAST else jnp.float32) for k, v in p.items()]

    def loss(*a):
        y, hl = M._fused_mixer(*a)
        return jnp.sum(y.astype(jnp.float32) * gy) + jnp.sum(hl * ghl)

    y, _ = M._fused_mixer(*args)
    return y, jax.grad(loss, argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("seqlen", [24, 40])
def test_mixer_fused_fn_matches_jax(dtype, seqlen, monkeypatch):
    """L = 24 and L = 40 (two full 16-step segments and a ragged one), with
    nonzero h0, conv_state and h_last cotangent: forward output and all 11
    gradients."""
    monkeypatch.setenv("VIDEOMAMBA_MIXER_BWD", "fused")
    p, gy, ghl = mixer_inputs(seed=seqlen, L=seqlen)
    jy, jg = jax_grads(p, gy, ghl, dtype)
    ty, tg = port_grads(p, gy, ghl, TDTYPE[dtype])
    assert ty.dtype == TDTYPE[dtype]
    assert rel_err(ty, jy) <= (1e-5 if dtype == "fp32" else 1e-2)
    for name, a, b, primal in zip(NAMES, tg, jg, CAST_OF_GRAD):
        assert a.dtype == (TDTYPE[dtype] if primal else torch.float32), name
        assert rel_err(a, b) <= TOL[dtype], name


@pytest.mark.parametrize("width", [9, 12])
def test_mixer_fused_fn_matches_jax_at_wide_convs(width, monkeypatch):
    """A Mamba(d_conv=9 or 12) layer's mixer: K6's plain version (its conv
    weight gradient at any width) against jax.grad through the JAX package's
    mixer, fp32, all 11 gradients. The JAX package's own mixer-backward
    kernel keeps 8 rows of conv-tap sums (mixer_bwd.py:107), so its
    gradients here come from its composite route (K3's forward, then
    autodiff of the recompute around its scan backward)."""
    p, gy, ghl = mixer_inputs(seed=60 + width, L=40, w=width)
    monkeypatch.setenv("VIDEOMAMBA_MIXER_BWD", "composite")
    jy, jg = jax_grads(p, gy, ghl, "fp32")
    monkeypatch.setenv("VIDEOMAMBA_MIXER_BWD", "fused")
    ty, tg = port_grads(p, gy, ghl, torch.float32)
    assert tg[2].shape == (width, 128) and tg[10].shape == (1, 128, width)
    assert rel_err(ty, jy) <= 1e-5
    for name, a, b in zip(NAMES, tg, jg):
        assert rel_err(a, b) <= TOL["fp32"], name


def test_composite_route_matches_fused(monkeypatch):
    p, gy, ghl = mixer_inputs(seed=3, L=40)
    grads = {}
    for route in ("fused", "composite"):
        monkeypatch.setenv("VIDEOMAMBA_MIXER_BWD", route)
        grads[route] = port_grads(p, gy, ghl, torch.float32)[1]
    for name, a, b in zip(NAMES, grads["composite"], grads["fused"]):
        assert rel_err(a, b) <= 2e-5, name


def test_mixer_bwd_plain_matches_autograd_of_forward():
    """At fp32, K6's plain version is the gradient of K3's plain version:
    against autograd of it, 1e-5. (At bf16 it is not: K6 rounds its
    cotangents where the TPU kernel does.)"""
    p, gy, ghl = mixer_inputs(seed=5, b=2, L=19)
    t = torch_layout(p, torch.float32)
    y, hl, ckpt = k3.mixer_fused_plain(*t.values(), checkpoints=True)
    want = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (hl * torch.from_numpy(ghl)).sum(),
        list(t.values()))
    args = {k: v.detach() for k, v in t.items() if k != "h0"}
    got = k6.mixer_bwd(*args.values(), ckpt=ckpt, g_y=torch.from_numpy(gy),
                       g_hlast=torch.from_numpy(ghl))
    for name, a, b in zip(NAMES, got, want):
        assert rel_err(a, b) <= 1e-5, name


def test_mamba_layer_trains_through_mixer_fused_fn():
    """A training Mamba layer records MixerFusedFn and its gradients reach
    every parameter; no grad mode leaves the serving call untouched."""
    layer = TMamba(64, device="cpu")
    x = torch.randn(2, 21, 64, generator=torch.Generator().manual_seed(0))
    out = layer(x)
    assert out.grad_fn is not None
    out.square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in layer.parameters())
    with torch.no_grad():
        assert torch.allclose(layer(x), out.detach())
