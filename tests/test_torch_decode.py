"""Token decode (K9 and K15, DecodeSession, InferenceCache, Mamba.step and
the two single-token ops) vs videomamba_tpu on the CPU.

The port's K9 and K15 wrappers run their plain versions on CPU tensors; the
JAX package runs its decode kernels in interpret mode (VIDEOMAMBA_PALLAS_
INTERPRET=1, as tests/test_decode_pallas.py does), where its
``precision=DEFAULT`` products are exact fp32. Same weights (exported from
the JAX model), same numpy tokens. rel_err = max|a - b| / max|b|. Bars: a
decode step and its states 1e-5 at fp32 (tests/test_decode_pallas.py), 1e-2
at bf16; decode against the full forward 1e-4 (tests/test_decode_session.py:
52-54); the single-token ops 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.models.mamba import InferenceCache as JCache
from videomamba_tpu.models.mamba import Mamba as JMamba
from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.ops.causal_conv1d import causal_conv1d_update as j_conv_update
from videomamba_tpu.ops.selective_scan import selective_state_update as j_state_update
from videomamba_tpu.runtime import DecodeSession as JSession
from videomamba_tpu.utils.precision import cast_params_for_compute
from videomamba_tpu_torch import (
    DecodeSession,
    InferenceCache,
    causal_conv1d_update,
    selective_state_update,
)
from videomamba_tpu_torch.checkpoint import load_state_dict, params_from_jax
from videomamba_tpu_torch.models.mamba import Mamba
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.ops.kernels import decode_step as k9
from videomamba_tpu_torch.utils.precision import cast_module_for_compute

TOL = {"fp32": 1e-5, "bf16": 1e-2}
GEOM = dict(img_size=16, patch_size=8, depth=3, embed_dim=64, channels=3,
            kernel_size=1, num_frames=4, add_pool_norm=False)


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


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("full", [True, False])
def test_selective_state_update_matches_jax(full):
    rng = np.random.default_rng(1)
    b, d, n = 3, 32, 8
    f = np.float32
    state = rng.standard_normal((b, d, n)).astype(f)
    x, dt = rng.standard_normal((b, d)).astype(f), (0.5 * rng.standard_normal((b, d))).astype(f)
    A = -np.exp(0.3 * rng.standard_normal((d, n))).astype(f)
    B, C = rng.standard_normal((b, n)).astype(f), rng.standard_normal((b, n)).astype(f)
    D = rng.standard_normal(d).astype(f) if full else None
    z = rng.standard_normal((b, d)).astype(f) if full else None
    bias = rng.standard_normal(d).astype(f) if full else None
    jy, jh = j_state_update(j(state), j(x), j(dt), j(A), j(B), j(C), D=j(D), z=j(z),
                            dt_bias=j(bias), dt_softplus=full)
    ty, th = selective_state_update(t(state), t(x), t(dt), t(A), t(B), t(C), D=t(D), z=t(z),
                                    dt_bias=t(bias), dt_softplus=full)
    assert ty.dtype == th.dtype == torch.float32
    assert rel_err(ty, jy) <= 1e-5 and rel_err(th, jh) <= 1e-5
    # A bf16 state comes back bf16 (the math stays fp32).
    _, hb = selective_state_update(t(state).bfloat16(), t(x), t(dt), t(A), t(B), t(C))
    assert hb.dtype == torch.bfloat16


@pytest.mark.parametrize("with_bias", [True, False])
def test_causal_conv1d_update_matches_jax(with_bias):
    rng = np.random.default_rng(2)
    b, d, w = 2, 32, 4
    x = rng.standard_normal((b, d)).astype(np.float32)
    state = rng.standard_normal((b, d, w)).astype(np.float32)
    weight = rng.standard_normal((w, d)).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32) if with_bias else None
    jy, js = j_conv_update(j(x), j(state), j(weight), j(bias))
    ty, ts = causal_conv1d_update(t(x), t(state), t(weight), t(bias))
    assert rel_err(ty, jy) <= 1e-5
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


_MODELS = {}


def pair(dtype="fp32", **overrides):
    """(JAX model, port model) on the same weights; bf16 as each package
    casts for serving."""
    key = (dtype, repr(sorted(overrides.items())))
    if key not in _MODELS:
        geom = dict(GEOM, **overrides)
        jm = JModel(**geom, rng=0)
        tm = TModel(**geom, device="cpu").eval()
        load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
        if dtype == "bf16":
            jm = JModel(**geom, params=cast_params_for_compute(jm.params, jnp.bfloat16),
                        dtype=jnp.bfloat16)
            cast_module_for_compute(tm, torch.bfloat16)
        _MODELS[key] = (jm, tm)
    return _MODELS[key]


def tokens(seed, b=2, e=64, steps=1):
    return np.random.default_rng(seed).standard_normal((steps, b, e)).astype(np.float32)


@pytest.mark.parametrize("dtype,rms", [("fp32", True), ("fp32", False), ("bf16", True)])
def test_decode_kernel_route_matches_jax_kernel(dtype, rms):
    """Five steps of the port's K9 route (its plain version here) against
    JAX's K9: features and both state stacks each step."""
    jm, tm = pair(dtype, rms_norm=rms)
    js = JSession(jm, batch_size=2, use_pallas=True)
    ts = DecodeSession(tm, batch_size=2, use_kernel=True)
    assert js.backend == "pallas" and ts.use_kernel
    before = k9.decode_stack.launches
    for tok in tokens(10, steps=5):
        jf, tf = js.step(j(tok)), ts.step(t(tok))
        assert tf.shape == jf.shape and tf.dtype == torch.float32
        assert rel_err(tf, jf) <= TOL[dtype]
        # JAX keeps its kernel's lane-major states: (K, B, W, Di), (K, B, N, Di).
        assert rel_err(ts.conv_states, js.conv_states.swapaxes(2, 3)) <= TOL[dtype]
        assert rel_err(ts.ssm_states, js.ssm_states.swapaxes(2, 3)) <= TOL[dtype]
    assert k9.decode_stack.launches == before  # plain on the CPU


def test_decode_step_route_matches_jax_xla_route():
    """use_kernel=False (Mamba.step per layer) against JAX's XLA route."""
    jm, tm = pair()
    js = JSession(jm, batch_size=2, use_pallas=False)
    ts = DecodeSession(tm, batch_size=2, use_kernel=False)
    assert js.backend == "xla" and not ts.use_kernel
    for tok in tokens(11, steps=3):
        assert rel_err(ts.step(t(tok)), js.step(j(tok))) <= TOL["fp32"]
    assert rel_err(ts.conv_states, js.conv_states) <= TOL["fp32"]
    assert rel_err(ts.ssm_states, js.ssm_states) <= TOL["fp32"]


def _port_tokens(tm, x, offset):
    """Patchify + positional adds, as the port's encoder front end does."""
    tok = tm.patch_embed(x)
    spatial = tm._get_spatial_pos_embedding(2, 2, tok.dtype)
    temporal = tm._get_temporal_pos_embedding(tok.shape[1], offset, tok.dtype)
    tok = tok + spatial[:, None] + temporal[:, :, None]
    return tok.reshape(tok.shape[0], -1, tm.embed_dim)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_prefill_then_decode_matches_full_forward(use_kernel):
    """Streaming prefill of 2 frames, load_streaming_state, then the last 2
    frames token by token: the JAX package's full forward's last tokens."""
    jm, tm = pair()
    x = np.random.default_rng(5).standard_normal((1, 3, 4, 16, 16)).astype(np.float32)
    full = jm.forward_features(j(x))
    with torch.no_grad():
        _, state = tm.forward_features(t(x)[:, :, :2], ssm_state=tm.allocate_state(1))
        session = DecodeSession(tm, batch_size=1, use_kernel=use_kernel)
        session.load_streaming_state(state)
        tok = _port_tokens(tm, t(x)[:, :, 2:], offset=2)
        decoded = torch.stack([session.step(tok[:, i]) for i in range(tok.shape[1])], dim=1)
    assert rel_err(decoded, full[:, -8:]) <= 1e-4


def test_forced_kernel_on_an_unsupported_model_raises():
    _, tm = pair(ssm_cfg={"bias": True})
    with pytest.raises(ValueError, match="decode kernel"):
        DecodeSession(tm, batch_size=1, use_kernel=True)
    session = DecodeSession(tm, batch_size=1)  # automatic: the per-layer route
    assert not session.use_kernel
    assert session.step(torch.zeros(1, 64)).shape == (1, 64)


def test_kernel_gate_takes_any_batch():
    """K9's gate is the model's widths alone: a large batch stays on the
    kernel route (the kernel stages it eight rows at a time), and so do
    widths that are not multiples of 8, which the JAX kernels take (the
    launch pads them to 16-byte rows with zero lanes)."""
    assert k9.decode_stack_supported(768, 1536)
    assert not k9.decode_stack_supported(6408, 12816) and k9.decode_stack_supported(60, 120)
    _, tm = pair()
    assert DecodeSession(tm, batch_size=80).use_kernel
    assert DecodeSession(tm, batch_size=80, use_kernel=True).use_kernel
    _, odd = pair(embed_dim=60)
    assert odd.layers[0].mixer.d_inner == 120
    assert DecodeSession(odd, batch_size=3, use_kernel=True).use_kernel


def test_decode_widths_pad_to_16_byte_rows():
    """d_model and d_inner that are not multiples of 8 run at the next
    multiple of 8: the states gain zero channels, K15's gate takes a d_model
    of any width (its d_inner rule is the JAX package's)."""
    assert [k9.decode_width(n) for n in (60, 64, 120, 121)] == [64, 64, 120, 128]
    conv, ssm = torch.randn(2, 3, 60, 4), torch.randn(2, 3, 60, 16)
    pconv, pssm = k9.pad_decode_states(conv, ssm, 60)
    assert pconv.shape == (2, 3, 64, 4) and pssm.shape == (2, 3, 64, 16)
    assert torch.equal(pconv[:, :, :60], conv) and not pconv[:, :, 60:].any()
    assert torch.equal(pssm[:, :, :60], ssm) and not pssm[:, :, 60:].any()
    even = torch.randn(2, 3, 64, 4)
    assert k9.pad_decode_states(even, even, 64)[0] is even
    assert k9.decode_stack_m2_supported(100, 128, 4, 1, 16)
    assert not k9.decode_stack_m2_supported(100, 120, 4, 1, 16)


M2_CFG = {"layer": "Mamba2", "d_state": 32, "headdim": 32, "chunk_size": 8}


def m2_states_from_jax(js):
    """JAX's K15 keeps lane-major states, (K, B, W, CD) and (K, B, N, H*P);
    the port keeps the streaming contract's (K, B, CD, W), (K, B, H, P, N)."""
    k, b, n, hp = js.ssm_states.shape
    ssm = np.asarray(js.ssm_states).swapaxes(2, 3).reshape(k, b, hp // 32, 32, n)
    return np.asarray(js.conv_states).swapaxes(2, 3), ssm


@pytest.mark.parametrize("dtype,rms", [("fp32", True), ("fp32", False), ("bf16", True)])
def test_m2_decode_kernel_route_matches_jax_kernel(dtype, rms):
    """Five steps of the port's K15 route (its plain version here) against
    JAX's K15 (decode_stack_pallas_m2 in interpret mode): features and both
    state stacks each step."""
    jm, tm = pair(dtype, rms_norm=rms, ssm_cfg=M2_CFG)
    js = JSession(jm, batch_size=2, use_pallas=True)
    ts = DecodeSession(tm, batch_size=2, use_kernel=True)
    assert js.backend == "pallas" and ts.use_kernel and ts.is_m2
    assert ts.ssm_states.shape == (3, 2, 4, 32, 32) and ts.ssm_states.dtype == torch.float32
    before = (k9.decode_stack.launches, k9.decode_stack_m2.launches)
    for tok in tokens(12, steps=5):
        jf, tf = js.step(j(tok)), ts.step(t(tok))
        assert tf.shape == jf.shape and tf.dtype == torch.float32
        assert rel_err(tf, jf) <= TOL[dtype]
        conv, ssm = m2_states_from_jax(js)
        assert rel_err(ts.conv_states, conv) <= TOL[dtype]
        assert rel_err(ts.ssm_states, ssm) <= TOL[dtype]
    assert (k9.decode_stack.launches, k9.decode_stack_m2.launches) == before  # plain on the CPU


def test_m2_decode_bf16_windows_match_jax_kernel():
    """dtype=bf16 stores the conv windows in bf16 while the SSD states stay
    fp32 (the Mamba-2 contract), on both packages' K15 routes."""
    jm, tm = pair(ssm_cfg=M2_CFG)
    js = JSession(jm, batch_size=2, dtype=jnp.bfloat16, use_pallas=True)
    ts = DecodeSession(tm, batch_size=2, dtype=torch.bfloat16, use_kernel=True)
    assert ts.conv_states.dtype == torch.bfloat16 and ts.ssm_states.dtype == torch.float32
    for tok in tokens(14, steps=3):
        assert rel_err(ts.step(t(tok)), js.step(j(tok))) <= TOL["bf16"]
    conv, ssm = m2_states_from_jax(js)
    assert rel_err(ts.conv_states, conv) <= TOL["bf16"]
    assert rel_err(ts.ssm_states, ssm) <= TOL["bf16"]


def test_m2_decode_step_route_matches_jax_xla_route():
    """use_kernel=False (Mamba2.step per layer) against JAX's XLA route."""
    jm, tm = pair(ssm_cfg=M2_CFG)
    js = JSession(jm, batch_size=2, use_pallas=False)
    ts = DecodeSession(tm, batch_size=2, use_kernel=False)
    assert js.backend == "xla" and not ts.use_kernel
    for tok in tokens(13, steps=3):
        assert rel_err(ts.step(t(tok)), js.step(j(tok))) <= TOL["fp32"]
    assert rel_err(ts.conv_states, js.conv_states) <= TOL["fp32"]
    assert rel_err(ts.ssm_states, js.ssm_states) <= TOL["fp32"]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_m2_prefill_then_decode_matches_full_forward(use_kernel):
    """A 2-frame streaming prefill, load_streaming_state, then the last 2
    frames token by token: the JAX package's full m2 forward's last tokens."""
    jm, tm = pair(ssm_cfg=M2_CFG)
    x = np.random.default_rng(6).standard_normal((1, 3, 4, 16, 16)).astype(np.float32)
    full = jm.forward_features(j(x))
    with torch.no_grad():
        _, state = tm.forward_features(t(x)[:, :, :2], ssm_state=tm.allocate_state(1))
        session = DecodeSession(tm, batch_size=1, use_kernel=use_kernel)
        session.load_streaming_state(state)
        tok = _port_tokens(tm, t(x)[:, :, 2:], offset=2)
        decoded = torch.stack([session.step(tok[:, i]) for i in range(tok.shape[1])], dim=1)
    assert rel_err(decoded, full[:, -8:]) <= 1e-4


def test_m2_kernel_gate():
    """K15's gate is the JAX package's (one B/C group, d_inner a multiple of
    128, its weight budget) and the card's widths, with no batch limit; a
    model outside it decodes per layer, and forcing the kernel raises."""
    assert k9.decode_stack_m2_supported(768, 1536, 24, 1, 64)
    assert not k9.decode_stack_m2_supported(768, 1536, 24, 2, 64)
    assert not k9.decode_stack_m2_supported(576, 1152 + 64, 19, 1, 64)
    _, tm = pair(ssm_cfg=M2_CFG)
    assert DecodeSession(tm, batch_size=80).use_kernel
    _, two_groups = pair(ssm_cfg=dict(M2_CFG, ngroups=2))
    with pytest.raises(ValueError, match="decode kernel"):
        DecodeSession(two_groups, batch_size=1, use_kernel=True)
    session = DecodeSession(two_groups, batch_size=1)
    assert not session.use_kernel
    assert session.step(torch.zeros(1, 64)).shape == (1, 64)


@pytest.fixture(scope="module")
def mixers():
    jmix = JMamba(d_model=8, d_state=4, d_conv=2, expand=2, use_fast_path=False, layer_idx=0)
    jp = jmix.init(jax.random.PRNGKey(0))
    tmix = Mamba(d_model=8, d_state=4, d_conv=2, expand=2, use_fast_path=False, layer_idx=0,
                 device="cpu")
    sd = {"in_proj.weight": jp["in_proj"]["kernel"].T, "x_proj.weight": jp["x_proj"]["kernel"].T,
          "dt_proj.weight": jp["dt_proj"]["kernel"].T, "dt_proj.bias": jp["dt_proj"]["bias"],
          "out_proj.weight": jp["out_proj"]["kernel"].T, "A_log": jp["A_log"], "D": jp["D"],
          "conv1d.weight": jp["conv1d"]["weight"].T[:, None, :],
          "conv1d.bias": jp["conv1d"]["bias"]}
    tmix.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()})
    return jmix, jp, tmix


def test_inference_cache_prefill_and_steps_match_jax(mixers):
    """Prefill 3 tokens through the cache, then 4 single-token steps; each
    output against the JAX mixer's, and the stitched outputs against one
    full forward."""
    jmix, jp, tmix = mixers
    x = np.random.default_rng(3).standard_normal((2, 7, 8)).astype(np.float32)
    jc, tc = JCache(), InferenceCache()
    with torch.no_grad():
        outs = [tmix(t(x[:, :3]), inference_params=tc)]
        assert rel_err(outs[0], jmix(jp, j(x[:, :3]), inference_params=jc)) <= 1e-5
        for step in range(3, 7):
            jc.seqlen_offset = tc.seqlen_offset = step
            outs.append(tmix(t(x[:, step:step + 1]), inference_params=tc))
            jout = jmix(jp, j(x[:, step:step + 1]), inference_params=jc)
            assert rel_err(outs[-1], jout) <= 1e-5
        full = tmix(t(x))
    assert rel_err(torch.cat(outs, dim=1), full) <= 1e-4
    (tcv, tss), (jcv, jss) = tc.key_value_memory_dict[0], jc.key_value_memory_dict[0]
    assert rel_err(tcv, jcv) <= 1e-5 and rel_err(tss, jss) <= 1e-5


def test_inference_cache_resizes_when_batch_size_changes(mixers):
    _, _, tmix = mixers
    cache = InferenceCache()
    out_a = tmix(torch.randn(2, 1, 8), inference_params=cache)
    cache.seqlen_offset = 1
    out_b = tmix(torch.randn(1, 1, 8), inference_params=cache)
    conv_state, ssm_state = cache.key_value_memory_dict[0]
    assert out_a.shape == (2, 1, 8) and out_b.shape == (1, 1, 8)
    assert conv_state.shape == (1, 16, 2) and ssm_state.shape == (1, 16, 4)


def test_inference_cache_argument_rules(mixers):
    _, _, tmix = mixers
    with pytest.raises(ValueError, match="layer_idx"):
        Mamba(d_model=8, d_state=4, d_conv=2, device="cpu")(
            torch.ones(1, 1, 8), inference_params=InferenceCache())
    with pytest.raises(ValueError, match="not supported with inference_params"):
        tmix(torch.ones(1, 1, 8), state=tmix.allocate_state(1),
             inference_params=InferenceCache())
    with pytest.raises(ValueError, match="exactly one token"):
        tmix.step(torch.ones(1, 2, 8), *tmix.allocate_state(1))


def test_model_allocate_inference_cache_and_block_pass_through():
    _, tm = pair()
    cache = tm.allocate_inference_cache(batch_size=2, max_seqlen=16)
    assert set(cache) == {0, 1, 2}
    conv, ssm = cache[0]
    assert conv.shape == (2, 128, 4) and ssm.shape == (2, 128, 16)
    # A Block given the cache takes the mixer route (not the whole-block
    # one) and writes its layer's entry.
    block = tm.layers[1]
    assert block._use_block_fused()
    params = InferenceCache()
    with torch.no_grad():
        out, res = block(torch.randn(2, 5, 64), inference_params=params)
    assert out.shape == (2, 5, 64) and set(params.key_value_memory_dict) == {1}
