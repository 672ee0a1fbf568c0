"""Plain PyTorch versions of the port's kernels vs the Pallas kernels they
replace, run in interpret mode on the CPU.

Each kernel's plain version (videomamba_tpu_torch/ops/kernels/*) is what the
CUDA kernel is compared against on the card, so here it is held to the Pallas
kernel itself: same numpy inputs, fp32, rel_err <= 1e-5 where
rel_err = max|a - b| / max|b|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videomamba_tpu.ops.pallas.fused_add_norm import fused_add_norm_pallas
from videomamba_tpu.ops.pallas.mixer_fused import mixer_fused_pallas, pack_weights
from videomamba_tpu.ops.pallas.scan import scan_chunked_pallas
from videomamba_tpu_torch.ops.kernels.fused_add_norm import fused_add_norm
from videomamba_tpu_torch.ops.kernels.mixer_fused import mixer_fused
from videomamba_tpu_torch.ops.kernels.scan import selective_scan

TOL = 1e-5


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("has_z,has_d", [(True, True), (False, False)])
def test_scan_plain_matches_pallas(has_z, has_d):
    rng = np.random.default_rng(0)
    b, L, d, n = 2, 40, 128, 16
    f = np.float32
    u = rng.standard_normal((b, L, d)).astype(f)
    delta = (0.5 * rng.standard_normal((b, L, d))).astype(f)
    A = -np.exp(0.3 * rng.standard_normal((d, n))).astype(f)
    B = rng.standard_normal((b, L, n)).astype(f)
    C = rng.standard_normal((b, L, n)).astype(f)
    D = rng.standard_normal(d).astype(f) if has_d else None
    z = rng.standard_normal((b, L, d)).astype(f) if has_z else None
    bias = np.linspace(-0.5, 0.5, d).astype(f)
    h0 = (0.2 * rng.standard_normal((b, d, n))).astype(f)

    jy, jh = scan_chunked_pallas(
        jnp.asarray(u), jnp.asarray(delta), jnp.asarray(A), jnp.asarray(B),
        jnp.asarray(C), None if D is None else jnp.asarray(D),
        None if z is None else jnp.asarray(z), jnp.asarray(bias),
        jnp.asarray(h0), softplus=True, has_z=has_z, interpret=True,
    )
    ty, th = selective_scan(t(u), t(delta), t(A), t(B), t(C), t(D), t(z),
                            t(bias), t(h0), softplus_delta=True)
    assert ty.shape == (b, L, d) and th.shape == (b, d, n)
    assert th.dtype == torch.float32
    assert rel_err(ty, jy) <= TOL
    assert rel_err(th, jh) <= TOL


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
@pytest.mark.parametrize("prenorm", [True, False])
@pytest.mark.parametrize("with_residual", [True, False])
def test_fused_add_norm_plain_matches_pallas(d, norm_type, prenorm, with_residual):
    rng = np.random.default_rng(d)
    m = 37
    x = rng.standard_normal((m, d)).astype(np.float32)
    res = rng.standard_normal((m, d)).astype(np.float32) if with_residual else None
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32) if norm_type == "layer" else None
    kw = dict(prenorm=prenorm, residual_in_fp32=with_residual, eps=1e-5,
              norm_type=norm_type)
    j = fused_add_norm_pallas(
        jnp.asarray(x), jnp.asarray(w), None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), interpret=True, **kw,
    )
    p = fused_add_norm(t(x), t(w), t(bias), residual=t(res), **kw)
    if prenorm:
        assert rel_err(p[0], j[0]) <= TOL
        assert p[1].dtype == torch.float32
        assert rel_err(p[1], j[1]) <= TOL
    else:
        assert rel_err(p, j) <= TOL


def test_mixer_fused_plain_matches_pallas():
    rng = np.random.default_rng(3)
    b, L, di, n, r, w = 2, 40, 128, 16, 4, 4
    f = np.float32
    x = rng.standard_normal((b, L, di)).astype(f)
    z = rng.standard_normal((b, L, di)).astype(f)
    conv_w = (0.5 * rng.standard_normal((w, di))).astype(f)  # JAX (W, Di)
    conv_b = (0.1 * rng.standard_normal(di)).astype(f)
    wx = (0.1 * rng.standard_normal((di, r + 2 * n))).astype(f)  # JAX (Di, R+2N)
    wdt = (0.3 * rng.standard_normal((r, di))).astype(f)  # JAX (R, Di)
    A = -np.exp(0.3 * rng.standard_normal((di, n))).astype(f)
    D = rng.standard_normal(di).astype(f)
    dt_bias = np.linspace(-2.0, 0.5, di).astype(f)
    h0 = (0.2 * rng.standard_normal((b, di, n))).astype(f)
    conv_state = rng.standard_normal((b, di, w)).astype(f)

    wx_pack, wdt_pack = pack_weights(jnp.asarray(wx), jnp.asarray(wdt), r, n)
    jy, jh = mixer_fused_pallas(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(conv_w), jnp.asarray(conv_b),
        wx_pack, wdt_pack, jnp.asarray(A), jnp.asarray(D), jnp.asarray(dt_bias),
        jnp.asarray(h0), jnp.asarray(conv_state), interpret=True, highest=True,
    )
    # The port takes the torch Linear/Conv1d layouts: (Di, W), (R+2N, Di), (Di, R).
    ty, th = mixer_fused(
        t(x), t(z), t(conv_w.T), t(conv_b), t(wx.T), t(wdt.T), t(dt_bias),
        t(A), t(D), t(h0), t(conv_state),
    )
    assert ty.shape == (b, L, di) and th.shape == (b, di, n)
    assert rel_err(ty, jy) <= TOL
    assert rel_err(th, jh) <= TOL
