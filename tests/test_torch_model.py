"""The port's model, streaming session and checkpoint mapping vs videomamba_tpu.

Tiny geometry (embed 64, depth 2, img 16, patch 8, 4 frames, d_inner 128):
the same weights (exported from the JAX model) and the same numpy video go
through both packages on the CPU. JAX runs its plain reference there (chunked
scan, XLA add-norm); the port runs its kernels' plain versions. Bars:
1e-5 rel_err for the forward and streaming, 1e-4 layer-level and 1e-2
model-level for stitched chunks against the full clip (the reference's bars).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.checkpoint import params_to_torch_state_dict
from videomamba_tpu.models.mamba import Mamba as JMamba
from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.runtime import StreamingSession as JSession
from videomamba_tpu_torch.checkpoint import load_state_dict, params_from_jax
from videomamba_tpu_torch.models.mamba import Mamba as TMamba
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.runtime import StreamingSession as TSession

GEOM = dict(img_size=16, patch_size=8, depth=2, embed_dim=64, channels=3,
            kernel_size=1, num_frames=4)
TOL = 1e-5

CONFIGS = {
    # name: (pool_type, rms_norm, ssm_cfg)
    "fused": ("cls+avg", True, {"use_fast_path": True}),
    "fused_avg_layernorm": ("avg", False, {"use_fast_path": True}),
    "unfused_no_conv_bias": ("cls+avg", True, {"conv_bias": False}),
    "plain": ("avg", True, {"use_fast_path": False}),
}


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def _perturb(params, seed):
    """Nonzero CLS, temporal pos-embed and dt bias, so every path shows."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, params)
    p["cls_token"] = 0.1 * rng.standard_normal(p["cls_token"].shape).astype(np.float32)
    p["temporal_pos_embedding"] = 0.1 * rng.standard_normal(
        p["temporal_pos_embedding"].shape).astype(np.float32)
    for lp in p["layers"]:
        b = lp["mixer"]["dt_proj"]["bias"]
        lp["mixer"]["dt_proj"]["bias"] = rng.uniform(-3, 0, b.shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, p)


_PAIRS = {}


def model_pair(name):
    """(jax_model, port_model) sharing weights; built once per config."""
    if name not in _PAIRS:
        pool_type, rms, ssm_cfg = CONFIGS[name]
        kw = dict(GEOM, pool_type=pool_type, rms_norm=rms, ssm_cfg=ssm_cfg)
        jm = JModel(**kw, rng=0)
        jm.params = _perturb(jm.params, seed=1)
        tm = TModel(**kw, device="cpu").eval()
        load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
        _PAIRS[name] = (jm, tm)
    return _PAIRS[name]


def video(frames=4, h=16, w=16, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 3, frames, h, w)).astype(np.float32)


@pytest.mark.parametrize("name", ["fused", "fused_avg_layernorm", "unfused_no_conv_bias"])
def test_params_from_jax_equals_exporter(name):
    jm, tm = model_pair(name)
    sd = params_from_jax(jax.tree.map(np.asarray, jm.params), tm)
    ref = params_to_torch_state_dict(jm)
    assert list(sd) == list(ref)
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32 and sd[k].numpy().dtype == v.dtype
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_state_dict_loads_strictly():
    jm, tm = model_pair("fused")
    sd = params_from_jax(jax.tree.map(np.asarray, jm.params), tm)
    assert set(sd) == set(tm.state_dict())
    missing = dict(sd)
    missing.pop("layers.1.mixer.A_log")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_state_dict(tm, missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_state_dict(tm, dict(sd, extra=np.zeros(1, np.float32)))
    load_state_dict(tm, sd)  # restores the shared model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_full_clip_forward_matches_jax(name):
    jm, tm = model_pair(name)
    x = video()
    jv, jp = jm(jnp.asarray(x))
    with torch.no_grad():
        tv, tp = tm(torch.from_numpy(x))
    assert tv.shape == jv.shape and tp.shape == jp.shape
    assert rel_err(tv, jv) <= TOL and rel_err(tp, jp) <= TOL


@pytest.mark.parametrize("hw,keep_temporal", [((24, 16), False), ((16, 16), True)])
def test_regrid_and_keep_temporal_match_jax(hw, keep_temporal):
    jm, tm = model_pair("fused")
    x = video(h=hw[0], w=hw[1], seed=5)
    jv, jp = jm(jnp.asarray(x), keep_temporal=keep_temporal)
    with torch.no_grad():
        tv, tp = tm(torch.from_numpy(x), keep_temporal=keep_temporal)
    assert rel_err(tv, jv) <= TOL and rel_err(tp, jp) <= TOL


def test_streaming_session_matches_jax():
    """Three 2-frame chunks: CLS in chunk 0 only, the third chunk past the
    4-frame horizon (temporal extrapolation)."""
    jm, tm = model_pair("fused_avg_layernorm")
    x = video(frames=6, seed=2)
    js, ts = JSession(jm, batch_size=2), TSession(tm, batch_size=2)
    for c in range(3):
        chunk = x[:, :, 2 * c:2 * c + 2]
        jv, jp = js.process(jnp.asarray(chunk))
        tv, tp = ts.process(torch.from_numpy(chunk))
        assert tv.shape == jv.shape
        assert rel_err(tv, jv) <= TOL and rel_err(tp, jp) <= TOL
    for (jc, jss), (tc, tss) in zip(js.state, ts.state):
        assert tc.dtype == torch.float32 and tss.dtype == torch.float32
        assert rel_err(tc, jc) <= TOL and rel_err(tss, jss) <= TOL


def test_session_reset_zeroes_rows_and_offset():
    _, tm = model_pair("fused_avg_layernorm")
    session = TSession(tm, batch_size=2)
    with torch.no_grad():
        session.process(torch.from_numpy(video(frames=2, seed=8)))
    assert session.offset == 2
    assert all(float(s.abs().sum()) > 0 for layer in session.state for s in layer)
    session.reset(rows=[1])
    for conv, ssm in session.state:
        assert float(conv[1].abs().sum()) == 0 and float(ssm[1].abs().sum()) == 0
        assert float(conv[0].abs().sum()) > 0 and float(ssm[0].abs().sum()) > 0
    assert session.offset == 2
    session.reset()
    assert session.offset == 0
    assert all(float(s.abs().sum()) == 0 for layer in session.state for s in layer)


def test_streaming_contract_matches_jax():
    from videomamba_tpu import streaming as j_streaming
    from videomamba_tpu_torch import streaming as t_streaming

    jm, tm = model_pair("fused")
    assert tm.streaming_contract_version == t_streaming.STREAMING_CONTRACT_VERSION \
        == j_streaming.STREAMING_CONTRACT_VERSION
    assert t_streaming.expected_state_shapes(tm, 3) == {
        i: t_streaming.StateShape(s.conv_state, s.ssm_state)
        for i, s in j_streaming.expected_state_shapes(jm, 3).items()
    }
    for flag in (True, False):
        t_sem = t_streaming.forward_return_semantics(flag)
        j_sem = j_streaming.forward_return_semantics(flag)
        assert (t_sem.without_state, t_sem.with_state) == (j_sem.without_state, j_sem.with_state)
    state = t_streaming.allocate_state(tm, 3, as_dict=True)
    t_streaming.validate_state(tm, state, 3)
    with pytest.raises(ValueError, match="keys mismatch"):
        t_streaming.validate_state(tm, {0: state[0]}, 3)
    with pytest.raises(ValueError, match="conv_state shape mismatch"):
        t_streaming.validate_state(tm, [state[0], (state[1][0][:1], state[1][1])], 3)
    with pytest.raises(TypeError, match="2-tuple"):
        t_streaming.validate_state(tm, [state[0], state[1][1]], 3)


def test_ssm_only_state_matches_jax():
    jm, tm = model_pair("fused")
    x = video(seed=3)
    jv, jst = jm.forward_features(jnp.asarray(x), ssm_state=jm.init_ssm_state(2))
    with torch.no_grad():
        tv, tst = tm.forward_features(torch.from_numpy(x), ssm_state=tm.init_ssm_state(2))
    assert rel_err(tv, jv) <= TOL
    for a, b in zip(tst, jst):
        assert rel_err(a, b) <= TOL


@pytest.mark.parametrize("name", ["fused_avg_layernorm", "unfused_no_conv_bias"])
def test_stitched_chunks_match_full_clip(name):
    _, tm = model_pair(name)
    tm.pool_type = "avg"  # continuation chunks carry no CLS
    x = torch.from_numpy(video(seed=4))
    with torch.no_grad():
        full, _ = tm(x)
        session = TSession(tm, batch_size=2)
        a, _ = session.process(x[:, :, :2])
        b, _ = session.process(x[:, :, 2:])
    tm.pool_type = CONFIGS[name][0]
    assert rel_err(torch.cat([a, b], dim=1), full) <= 1e-2


def _mixer_state_dict(p):
    sd = {
        "in_proj.weight": p["in_proj"]["kernel"].T,
        "conv1d.weight": p["conv1d"]["weight"].T[:, None, :],
        "x_proj.weight": p["x_proj"]["kernel"].T,
        "dt_proj.weight": p["dt_proj"]["kernel"].T,
        "dt_proj.bias": p["dt_proj"]["bias"],
        "A_log": p["A_log"],
        "D": p["D"],
        "out_proj.weight": p["out_proj"]["kernel"].T,
    }
    if "bias" in p["conv1d"]:
        sd["conv1d.bias"] = p["conv1d"]["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("conv_bias", [True, False])
def test_mixer_branches_match_jax_and_stream(conv_bias):
    """conv_bias=True takes the fused branch (K3), False the unfused one (K1);
    both against JAX with carried state, and chunked against full at the
    layer-level bar."""
    jmix = JMamba(d_model=64, conv_bias=conv_bias, use_fast_path=True)
    params = jax.tree.map(np.asarray, jmix.init(jax.random.PRNGKey(0)))
    tmix = TMamba(64, conv_bias=conv_bias, device="cpu")
    tmix.load_state_dict(_mixer_state_dict(params), strict=True)
    assert tmix._use_fused_mixer() == conv_bias
    x = np.random.default_rng(6).standard_normal((2, 21, 64)).astype(np.float32)
    rng = np.random.default_rng(7)
    state = tuple(rng.standard_normal(s).astype(np.float32)
                  for s in ((2, 128, 4), (2, 128, 16)))

    jy, (jc, js) = jmix(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                        state=tuple(map(jnp.asarray, state)), return_state=True)
    with torch.no_grad():
        ty, (tc, ts) = tmix(torch.from_numpy(x),
                            state=tuple(map(torch.from_numpy, state)),
                            return_state=True)
        assert rel_err(ty, jy) <= TOL
        assert rel_err(tc, jc) <= TOL and rel_err(ts, js) <= TOL

        full = tmix(torch.from_numpy(x))
        st = tmix.allocate_state(2)
        y1, st = tmix(torch.from_numpy(x[:, :8]), state=st, return_state=True)
        y2, st = tmix(torch.from_numpy(x[:, 8:]), state=st, return_state=True)
    assert rel_err(torch.cat([y1, y2], dim=1), full) <= 1e-4
    assert st[0].shape == (2, 128, 4) and st[1].shape == (2, 128, 16)
