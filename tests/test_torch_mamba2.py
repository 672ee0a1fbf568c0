"""The port's Mamba-2 (SSD) mixer, m2 model, presets and checkpoint vs videomamba_tpu.

Small widths that take the projected-mixer route (K14): d_model 128,
headdim 32 (8 heads), d_state 16, chunk 16, with sequences that are not a
multiple of the chunk. The same weights (exported from the JAX package) and
the same numpy inputs go through both packages on the CPU: JAX on its exact
chunked XLA route, the port on each of its routes (K14's and K12's plain
versions, the plain chunked SSD, the sequential oracle). Bars: fp32 1e-5,
bf16 1e-2 (the packages round bf16 at other points), stitched chunks against
the full clip 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu import streaming as j_streaming
from videomamba_tpu.models import presets as j_presets
from videomamba_tpu.models.mamba import InferenceCache as JCache
from videomamba_tpu.models.mamba2 import Mamba2 as JMamba2
from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.runtime import StreamingSession as JSession
from videomamba_tpu.utils.precision import cast_params_for_compute
from videomamba_tpu_torch import streaming as t_streaming
from videomamba_tpu_torch.checkpoint import load_state_dict, params_from_jax
from videomamba_tpu_torch.models import presets as t_presets
from videomamba_tpu_torch.models.block import create_block
from videomamba_tpu_torch.models.mamba import InferenceCache
from videomamba_tpu_torch.models.mamba2 import Mamba2
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14
from videomamba_tpu_torch.runtime import StreamingSession as TSession
from videomamba_tpu_torch.utils.precision import cast_module_for_compute

TOL = {"fp32": 1e-5, "bf16": 1e-2}
MIXER = dict(d_model=128, d_state=16, headdim=32, chunk_size=16)
SSM_CFG = {"layer": "Mamba2", "d_state": 16, "headdim": 32, "chunk_size": 16}
GEOM = dict(img_size=16, patch_size=8, depth=2, embed_dim=128, channels=3, kernel_size=1,
            num_frames=4, pool_type="avg", ssm_cfg=SSM_CFG)


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def mixer_state_dict(jp) -> dict:
    sd = {"in_proj.weight": np.asarray(jp["in_proj"]["kernel"]).T,
          "conv1d.weight": np.asarray(jp["conv1d"]["weight"]).T[:, None, :],
          "conv1d.bias": jp["conv1d"]["bias"], "dt_bias": jp["dt_bias"],
          "A_log": jp["A_log"], "D": jp["D"], "norm.weight": jp["norm"]["weight"],
          "out_proj.weight": np.asarray(jp["out_proj"]["kernel"]).T}
    for name in ("in_proj", "out_proj"):
        if "bias" in jp[name]:
            sd[name + ".bias"] = jp[name]["bias"]
    return {k: t(v) for k, v in sd.items()}


_MIXERS = {}


def mixer_pair(bias=False):
    """(JAX mixer, its params, port mixer) on the same weights; the dt bias
    and the gated norm's weight perturbed so every term shows."""
    if bias not in _MIXERS:
        jm = JMamba2(**MIXER, bias=bias, layer_idx=0)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
        rng = np.random.default_rng(4)
        jp["dt_bias"] = rng.uniform(-4, -1, jp["dt_bias"].shape).astype(np.float32)
        jp["norm"]["weight"] = (1 + 0.1 * rng.standard_normal(jp["norm"]["weight"].shape)
                                ).astype(np.float32)
        jp = jax.tree.map(jnp.asarray, jp)
        tm = Mamba2(**MIXER, bias=bias, layer_idx=0, device="cpu").eval()
        tm.load_state_dict(mixer_state_dict(jp))
        _MIXERS[bias] = (jm, jp, tm)
    return _MIXERS[bias]


def tokens(seed, b=2, seqlen=37, e=128):
    return np.random.default_rng(seed).standard_normal((b, seqlen, e)).astype(np.float32)


ROUTES = {
    # name: (env, mixer kwargs, the kernel wrapper the route reaches)
    "pmixer": ({}, {}, "k14"),
    "mixer": ({"VIDEOMAMBA_SSD_PMIXER": "0"}, {}, "k12"),
    "bias": ({}, {"bias": True}, "k12"),
    "chunked": ({"VIDEOMAMBA_SSD_METHOD": "chunked"}, {}, None),
    "ref": ({"VIDEOMAMBA_SSD_METHOD": "ref"}, {}, None),
}


def _plain_calls(monkeypatch, used):
    """Count the wrappers' calls (their plain versions on the CPU)."""
    for name, mod, fn in (("k12", k12, "ssd_mixer_plain"), ("k14", k14, "ssd_pmixer_plain")):
        orig = getattr(mod, fn)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            used.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, fn, wrapped)



def test_shape_outside_kernel_gate_routes_by_device(monkeypatch):
    """A head dim the kernels do not take (30, not a multiple of 4): a CPU
    tensor takes the plain chunked SSD, no kernel's plain version; a card
    tensor keeps the kernel route, whose wrapper raises for the shape."""
    from videomamba_tpu_torch.ops import dispatch

    used = []
    _plain_calls(monkeypatch, used)
    tm = Mamba2(d_model=60, d_state=16, headdim=30, chunk_size=16, device="cpu").eval()
    assert not k12.ssd_kernel_supported(tm.nheads, 30, 1, 16, 16)
    x = t(tokens(5, seqlen=21, e=60))
    with torch.no_grad():
        out = tm(x)
        monkeypatch.setenv("VIDEOMAMBA_SSD_METHOD", "chunked")
        want = tm(x)
        monkeypatch.delenv("VIDEOMAMBA_SSD_METHOD")
    assert used == [] and torch.equal(out, want)
    assert tm._method(x) == "chunked"
    monkeypatch.setattr(dispatch, "runs_plain", lambda *ts: False)
    assert tm._method(x) == "pallas"

@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mixer_routes_and_state_paths_match_jax(route, monkeypatch):
    """Full sequence, two-chunk streaming with (conv, ssm) state, and the
    bare ssm_state path, on each route, against the JAX mixer."""
    env, kw, wrapper = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    used = []
    _plain_calls(monkeypatch, used)
    jm, jp, tm = mixer_pair(**kw)
    x = tokens(1)
    with torch.no_grad():
        assert rel_err(tm(t(x)), jm(jp, jnp.asarray(x))) <= TOL["fp32"]
        jstate = jm.allocate_state(2)
        tstate = tm.allocate_state(2)
        for sl in (slice(0, 21), slice(21, 37)):
            jo, jstate = jm(jp, jnp.asarray(x[:, sl]), state=jstate, return_state=True)
            to, tstate = tm(t(x[:, sl]), state=tstate, return_state=True)
            assert rel_err(to, jo) <= TOL["fp32"]
            for a, b in zip(tstate, jstate):
                assert a.shape == b.shape and a.dtype == torch.float32
                assert rel_err(a, b) <= TOL["fp32"]
        h0 = np.random.default_rng(2).standard_normal(jstate[1].shape).astype(np.float32)
        jo, jh = jm(jp, jnp.asarray(x), ssm_state=jnp.asarray(h0), return_ssm_state=True)
        to, th = tm(t(x), ssm_state=t(h0), return_ssm_state=True)
        assert rel_err(to, jo) <= TOL["fp32"] and rel_err(th, jh) <= TOL["fp32"]
    assert set(used) == ({wrapper} if wrapper else set())


def test_mixer_decode_cache_and_step_match_jax():
    """A 3-token prefill through the decode cache, then 4 single-token
    steps, against the JAX mixer's cache route; and step() alone."""
    jm, jp, tm = mixer_pair()
    x = tokens(5, seqlen=7)
    jc, tc = JCache(), InferenceCache()
    with torch.no_grad():
        for i, sl in enumerate([slice(0, 3)] + [slice(k, k + 1) for k in range(3, 7)]):
            jc.seqlen_offset = tc.seqlen_offset = 0 if i == 0 else sl.start
            jo = jm(jp, jnp.asarray(x[:, sl]), inference_params=jc)
            to = tm(t(x[:, sl]), inference_params=tc)
            assert rel_err(to, jo) <= TOL["fp32"]
            for a, b in zip(tc.key_value_memory_dict[0], jc.key_value_memory_dict[0]):
                assert rel_err(a, b) <= TOL["fp32"]
        conv, ssm = tc.key_value_memory_dict[0]
        jout = jm.step(jp, jnp.asarray(x[:, :1]), jnp.asarray(f64(conv)), jnp.asarray(f64(ssm)))
        tout = tm.step(t(x[:, :1]), conv, ssm)
    for a, b in zip(tout, jout):
        assert rel_err(a, b) <= TOL["fp32"]
    with pytest.raises(ValueError, match="inference_params"):
        tm(t(x), ssm_state=ssm, inference_params=tc)


def test_mixer_plain_versions_stay_differentiable_on_the_cpu():
    """On CPU tensors K14's and K12's plain versions are autograd's to
    differentiate: every parameter gets a finite gradient."""
    _, _, tm = mixer_pair()
    x = t(tokens(6, seqlen=20)).requires_grad_()
    for env in ("1", "0"):
        tm.zero_grad()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VIDEOMAMBA_SSD_PMIXER", env)
            tm(x).square().mean().backward()
        for name, p in tm.named_parameters():
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


def test_mixer_validation_and_block_route():
    with pytest.raises(ValueError, match="headdim"):
        Mamba2(d_model=100, headdim=24, device="cpu")
    with pytest.raises(ValueError, match="ngroups"):
        Mamba2(d_model=96, headdim=24, ngroups=3, device="cpu")
    with pytest.raises(TypeError, match="process group"):
        Mamba2(d_model=128, headdim=32, sp_axis="sp", device="cpu")
    with pytest.raises(ValueError, match="unknown ssm_cfg layer"):
        create_block(64, ssm_cfg={"layer": "Mamba3"}, device="cpu")
    block = create_block(128, ssm_cfg=SSM_CFG, device="cpu")
    assert isinstance(block.mixer, Mamba2) and not block._use_block_fused()
    assert block.allocate_state(3)[1].shape == (3, 8, 32, 16)


# ------------------------------------------------------------------ model

_PAIRS = {}


def model_pair(dtype="fp32"):
    """(JAX model, port model) sharing weights; bf16 as each package casts
    for serving."""
    if dtype not in _PAIRS:
        jm = JModel(**GEOM, rng=0)
        rng = np.random.default_rng(1)
        p = jax.tree.map(np.asarray, jm.params)
        for lp in p["layers"]:
            lp["mixer"]["dt_bias"] = rng.uniform(-4, -1, lp["mixer"]["dt_bias"].shape).astype(
                np.float32)
        jm.params = jax.tree.map(jnp.asarray, p)
        tm = TModel(**GEOM, device="cpu").eval()
        load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
        if dtype == "bf16":
            jm = JModel(**GEOM, params=cast_params_for_compute(jm.params, jnp.bfloat16),
                        dtype=jnp.bfloat16)
            cast_module_for_compute(tm, torch.bfloat16)
        _PAIRS[dtype] = (jm, tm)
    return _PAIRS[dtype]


def video(frames=4, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 3, frames, 16, 16)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_model_full_clip_and_streaming_match_jax(dtype):
    """The m2 model's full clip and a two-chunk StreamingSession against
    JAX's; the session's states stay fp32 at bf16; the stitched chunks
    against the full clip."""
    jm, tm = model_pair(dtype)
    x = video()
    jv, jp = jm(jnp.asarray(x))
    with torch.no_grad():
        tv, tp = tm(t(x).to(tm.patch_embed.proj.weight.dtype))
    assert tv.dtype == (torch.float32 if dtype == "fp32" else torch.bfloat16)
    assert rel_err(tv, jv) <= TOL[dtype] and rel_err(tp, jp) <= TOL[dtype]
    js, ts = JSession(jm, batch_size=2), TSession(tm, batch_size=2)
    outs = []
    for c in range(2):
        chunk = x[:, :, 2 * c:2 * c + 2]
        jcv, _ = js.process(jnp.asarray(chunk))
        tcv, _ = ts.process(t(chunk))
        assert rel_err(tcv, jcv) <= TOL[dtype]
        outs.append(tcv)
    for (jc, jss), (tc, tss) in zip(js.state, ts.state):
        assert tc.dtype == tss.dtype == torch.float32 and tss.ndim == 4
        assert rel_err(tc, jc) <= TOL[dtype] and rel_err(tss, jss) <= TOL[dtype]
    assert rel_err(torch.cat(outs, dim=1), tv) <= (1e-4 if dtype == "fp32" else 1e-2)


def test_params_from_jax_round_trip_is_strict():
    jm, tm = model_pair()
    sd = params_from_jax(jax.tree.map(np.asarray, jm.params), tm)
    assert set(sd) == set(tm.state_dict())
    assert "layers.0.mixer.dt_bias" in sd and "layers.1.mixer.norm.weight" in sd
    assert sd["layers.0.mixer.conv1d.weight"].shape == (288, 1, 4)
    back = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), back[k], err_msg=k)
    missing = dict(sd)
    missing.pop("layers.1.mixer.dt_bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_state_dict(tm, missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_state_dict(tm, dict(sd, extra=np.zeros(1, np.float32)))
    load_state_dict(tm, sd)  # restores the shared model


def test_streaming_contract_for_m2():
    jm, tm = model_pair()
    assert t_streaming.expected_state_shapes(tm, 3) == {
        i: t_streaming.StateShape(s.conv_state, s.ssm_state)
        for i, s in j_streaming.expected_state_shapes(jm, 3).items()
    }
    state = t_streaming.allocate_state(tm, 3)
    t_streaming.validate_state(tm, state, 3)
    with pytest.raises(ValueError, match="ssm_state shape mismatch"):
        t_streaming.validate_state(tm, [state[0], (state[1][0], state[1][1][:, :1])], 3)


@pytest.mark.parametrize("preset", ["tiny", "small", "middle", "base"])
def test_m2_presets_match_jax_shapes(preset):
    """Each ``videomamba_*_m2`` preset's mixer (built at depth 1): its
    parameter shapes against the JAX preset mixer's (mapped by
    params_from_jax's layouts), its state shapes, and its route (K14 for
    Small and Base, K12 for Tiny and Middle, at fp32 and bf16)."""
    tm = getattr(t_presets, f"videomamba_{preset}_m2")(depth=1, device="cpu")
    tmix = tm.layers[0].mixer
    assert t_presets.M2_SSM_CFG == j_presets.M2_SSM_CFG
    cfg = {k: v for k, v in j_presets.M2_SSM_CFG.items() if k != "layer"}
    jmix = JMamba2(d_model=j_presets.PRESETS[preset]["embed_dim"], **cfg)
    jshapes = jax.eval_shape(jmix.init, jax.random.PRNGKey(0))
    want = {"in_proj.weight": jshapes["in_proj"]["kernel"].shape[::-1],
            "conv1d.weight": (jmix.conv_dim, 1, jmix.d_conv),
            "conv1d.bias": jshapes["conv1d"]["bias"].shape,
            "dt_bias": jshapes["dt_bias"].shape, "A_log": jshapes["A_log"].shape,
            "D": jshapes["D"].shape, "norm.weight": jshapes["norm"]["weight"].shape,
            "out_proj.weight": jshapes["out_proj"]["kernel"].shape[::-1]}
    assert jshapes["conv1d"]["weight"].shape == (jmix.d_conv, jmix.conv_dim)
    assert {k: tuple(v.shape) for k, v in tmix.state_dict().items()} == want
    assert tmix.state_shapes(2) == jmix.state_shapes(2)
    assert (tmix.nheads, tmix.conv_dim, tmix.d_in_proj, tmix.chunk_size) == (
        jmix.nheads, jmix.conv_dim, jmix.d_in_proj, jmix.chunk_size)
    assert tmix._pmixer_ok() == (preset in ("small", "base"))
    cast_module_for_compute(tm, torch.bfloat16)
    assert tmix._pmixer_ok() == (preset in ("small", "base"))


def test_bf16_cast_keeps_the_jax_packages_fp32_leaves():
    """cast_module_for_compute, as the JAX package's rule: ``dt_bias`` is
    cast to bf16 (only ``dt_proj.bias`` is pinned), while the gated norm's
    weight, ``A_log`` and ``D`` stay fp32."""
    _, tm = model_pair("bf16")
    mx = tm.layers[0].mixer
    assert mx.dt_bias.dtype == torch.bfloat16
    assert mx.norm.weight.dtype == mx.A_log.dtype == mx.D.dtype == torch.float32
    assert mx.in_proj.weight.dtype == mx.conv1d.weight.dtype == torch.bfloat16
    jm, _ = model_pair("bf16")
    assert jm.params["layers"][0]["mixer"]["dt_bias"].dtype == jnp.bfloat16
    assert jm.params["layers"][0]["mixer"]["norm"]["weight"].dtype == jnp.float32
