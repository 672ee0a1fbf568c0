"""The port's plain ops vs their videomamba_tpu counterparts on the CPU.

Same numpy inputs through both, fp32, rel_err = max|a - b| / max|b| <= 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videomamba_tpu.ops.causal_conv1d import causal_conv1d as j_causal_conv1d
from videomamba_tpu.ops import norm as j_norm
from videomamba_tpu.ops import resample as j_rs
from videomamba_tpu.ops.selective_scan import selective_scan_bld as j_scan
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d as t_causal_conv1d
from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops import norm as t_norm
from videomamba_tpu_torch.ops import resample as t_rs
from videomamba_tpu_torch.ops.selective_scan import selective_scan_bld as t_scan

TOL = 1e-5


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_causal_conv1d_matches_jax(with_state, with_bias):
    rng = np.random.default_rng(1)
    b, L, d, w = 2, 9, 32, 4
    x = rng.standard_normal((b, L, d)).astype(np.float32)
    weight = rng.standard_normal((w, d)).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32) if with_bias else None
    state = rng.standard_normal((b, d, w)).astype(np.float32) if with_state else None
    jy, jst = j_causal_conv1d(j(x), j(weight), j(bias), initial_state=j(state),
                              return_final_state=True)
    ty, tst = t_causal_conv1d(t(x), t(weight), t(bias), initial_state=t(state),
                              return_final_state=True)
    assert rel_err(ty, jy) <= TOL
    assert tst.shape == (b, d, w) and tst.is_contiguous()
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("norm_type", ["rms", "layer"])
@pytest.mark.parametrize("prenorm", [True, False])
def test_norms_match_jax(norm_type, prenorm):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    res = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    assert rel_err(t_norm.rms_norm(t(x), t(w)), j_norm.rms_norm(j(x), j(w))) <= TOL
    assert rel_err(t_norm.layer_norm(t(x), t(w), t(bias)),
                   j_norm.layer_norm(j(x), j(w), j(bias))) <= TOL
    kw = dict(prenorm=prenorm, residual_in_fp32=True, norm_type=norm_type)
    jo = j_norm.fused_add_norm(j(x), j(w), j(bias), residual=j(res), **kw)
    for use_kernel in (False, True):  # the kernel route runs plain on CPU
        to = t_norm.fused_add_norm(t(x), t(w), t(bias), residual=t(res),
                                   use_kernel=use_kernel, **kw)
        for a, b in zip(to if prenorm else [to], jo if prenorm else [jo]):
            assert rel_err(a, b) <= TOL


@pytest.mark.parametrize("in_len,out_len", [(4, 7), (8, 3), (5, 5)])
def test_resample_matches_jax(in_len, out_len):
    np.testing.assert_array_equal(t_rs.linear_resample_matrix(in_len, out_len),
                                  j_rs.linear_resample_matrix(in_len, out_len))
    np.testing.assert_array_equal(t_rs.cubic_resample_matrix(in_len, out_len),
                                  j_rs.cubic_resample_matrix(in_len, out_len))
    rng = np.random.default_rng(in_len * 10 + out_len)
    seq = rng.standard_normal((2, in_len, 6)).astype(np.float32)
    assert rel_err(t_rs.resample_linear_1d(t(seq), out_len),
                   j_rs.resample_linear_1d(j(seq), out_len)) <= TOL
    grid = rng.standard_normal((1, in_len, in_len + 1, 6)).astype(np.float32)
    hw = (out_len, out_len + 2)
    assert rel_err(t_rs.resample_bicubic_2d(t(grid), hw),
                   j_rs.resample_bicubic_2d(j(grid), hw)) <= TOL
    for count in (in_len * out_len, 14, 196):
        assert t_rs.infer_spatial_grid(count, (in_len, out_len)) == \
            j_rs.infer_spatial_grid(count, (in_len, out_len))


@pytest.mark.parametrize("method", ["ref", "kernel"])
def test_selective_scan_bld_matches_jax(method):
    rng = np.random.default_rng(4)
    b, L, d, n = 2, 13, 32, 8
    u = rng.standard_normal((b, L, d)).astype(np.float32)
    delta = (0.5 * rng.standard_normal((b, L, d))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal((d, n))).astype(np.float32)
    B = rng.standard_normal((b, L, n)).astype(np.float32)
    C = rng.standard_normal((b, L, n)).astype(np.float32)
    D = rng.standard_normal(d).astype(np.float32)
    z = rng.standard_normal((b, L, d)).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32)
    kw = dict(delta_softplus=True, return_last_state=True)
    jy, jh = j_scan(j(u), j(delta), j(A), j(B), j(C), D=j(D), z=j(z),
                    delta_bias=j(bias), initial_state=j(h0), method="chunked", **kw)
    ty, th = t_scan(t(u), t(delta), t(A), t(B), t(C), D=t(D), z=t(z),
                    delta_bias=t(bias), initial_state=t(h0), method=method, **kw)
    assert rel_err(ty, jy) <= TOL and rel_err(th, jh) <= TOL
    # Without initial state, D, z or bias: the bare recurrence.
    jy = j_scan(j(u), j(delta), j(A), j(B), j(C), method="chunked")
    ty = t_scan(t(u), t(delta), t(A), t(B), t(C), method=method)
    assert rel_err(ty, jy) <= TOL


def test_dispatch_routes_by_device():
    assert dispatch.runs_plain(torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel route"):
        dispatch.runs_plain(torch.zeros(1, device="meta"))


def test_resolve_device_defaults_to_the_card(monkeypatch):
    """device=None means the card; without one it raises, never the CPU."""
    from videomamba_tpu_torch.models.presets import videomamba_tiny
    from videomamba_tpu_torch.runtime import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        videomamba_tiny(depth=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_backward_switches_read_the_jax_environment(monkeypatch):
    for var in ("VIDEOMAMBA_MIXER_BWD", "VIDEOMAMBA_NORM_BWD", "VIDEOMAMBA_BLOCK_BWD"):
        monkeypatch.delenv(var, raising=False)
    assert dispatch.mixer_bwd_backend() == "fused"
    assert not dispatch.norm_bwd_kernel() and dispatch.block_bwd_mode() is None
    assert dispatch.block_bwd_backend() == "fused"
    monkeypatch.setenv("VIDEOMAMBA_MIXER_BWD", "composite")
    monkeypatch.setenv("VIDEOMAMBA_NORM_BWD", "pallas")
    monkeypatch.setenv("VIDEOMAMBA_BLOCK_BWD", "fused")
    assert dispatch.mixer_bwd_backend() == "composite"
    assert dispatch.norm_bwd_kernel() and dispatch.block_bwd_mode() == "fused"
    monkeypatch.setenv("VIDEOMAMBA_MIXER_BWD", "bogus")
    monkeypatch.setenv("VIDEOMAMBA_BLOCK_BWD", "composite")
    assert dispatch.mixer_bwd_backend() == "fused"
    assert dispatch.block_bwd_mode() == "composite"
    assert dispatch.block_bwd_backend() == "composite"


def test_kill_switch_selects_plain_path(monkeypatch):
    from videomamba_tpu_torch.models.mamba import Mamba

    assert Mamba(16, device="cpu").use_fast_path and Mamba(16, device="cpu")._use_fused_mixer()
    assert not Mamba(16, use_fast_path=False, device="cpu")._use_fused_mixer()
    assert not Mamba(16, conv_bias=False, device="cpu")._use_fused_mixer()
    monkeypatch.setenv("VIDEOMAMBA_DISABLE_FUSED", "1")
    assert not Mamba(16, device="cpu").use_fast_path
    assert not Mamba(16, device="cpu")._use_fused_mixer()
