"""The port's VideoMAE masking vs videomamba_tpu on the CPU.

Tiny geometry (img 16, patch 8, depth 2, embed 64, 4 frames: 16 patch
tokens and CLS): the same weights (exported from the JAX model, with a
nonzero CLS, temporal pos-embed and dt bias), the same numpy video and mask
go through both packages. The port runs its kernels' plain versions; JAX
runs its XLA route at fp32 and its Pallas kernels in interpret mode at bf16.
rel_err = max|a - b| / max|b|. Bars: 1e-5 fp32 forward, 1e-2 bf16, 2e-5
gradients (tests/test_mixer_bwd.py:76); mask generators bit-equal; error
cases raise the same type with the same message.
"""

import copy
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.checkpoint import params_to_torch_state_dict
from videomamba_tpu.data.masking import RandomMaskingGenerator as JRandom
from videomamba_tpu.data.masking import TubeMaskingGenerator as JTube
from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.runtime import StreamingSession as JSession
from videomamba_tpu.utils.precision import cast_params_for_compute
from videomamba_tpu_torch.checkpoint import load_state_dict, params_from_jax
from videomamba_tpu_torch.data.masking import RandomMaskingGenerator as TRandom
from videomamba_tpu_torch.data.masking import TubeMaskingGenerator as TTube
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.parallel.train_step import make_train_step
from videomamba_tpu_torch.runtime import StreamingSession as TSession
from videomamba_tpu_torch.utils.precision import cast_module_for_compute

GEOM = dict(img_size=16, patch_size=8, depth=2, embed_dim=64, channels=3,
            kernel_size=1, num_frames=4)
TOKENS = 1 + 4 * 4
TOL = {"fp32": 1e-5, "bf16": 1e-2}


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def _perturb(params, seed=1):
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


def pair(pool_type="cls+avg", dtype="fp32", add_pool_norm=True):
    """(JAX model, port model) on the same weights; built once per key."""
    key = (pool_type, dtype, add_pool_norm)
    if key not in _PAIRS:
        kw = dict(GEOM, pool_type=pool_type, add_pool_norm=add_pool_norm)
        jm = JModel(**kw, rng=0)
        jm.params = _perturb(jm.params)
        tm = TModel(**kw, device="cpu").eval()
        load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
        if dtype == "bf16":
            jm = JModel(**kw, params=cast_params_for_compute(jm.params, jnp.bfloat16),
                        dtype=jnp.bfloat16)
            cast_module_for_compute(tm, torch.bfloat16)
        _PAIRS[key] = (jm, tm)
    return _PAIRS[key]


def video(batch=2, frames=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, 3, frames, 16, 16)).astype(np.float32)


def visible_mask(batch, visible, tokens=TOKENS):
    mask = np.ones((batch, tokens), bool)
    mask[:, visible] = False
    return mask


def _error_case(name):
    """(mask, batch, forward kwargs, pool_type) of each refused input."""
    z = np.zeros((1, TOKENS), bool)
    if name == "legacy_shape":
        return np.zeros((1, TOKENS - 1), bool), 1, {}, "cls+avg"
    if name == "masked_cls":
        m = z.copy()
        m[:, 0] = True
        return m, 1, {}, "cls+avg"
    if name == "variable_counts":
        m = np.zeros((2, TOKENS), bool)
        m[0, 3:7] = True
        m[1, 3:11] = True
        return m, 2, {"use_image": True}, "cls+avg"
    if name == "no_patch_visible":
        return visible_mask(1, [0]), 1, {}, "cls+avg"
    if name == "empty_frame_keep_temporal":
        return visible_mask(1, [0, 1, 2]), 1, {"keep_temporal": True}, "cls+avg"
    if name == "not_2d":
        return np.zeros((TOKENS,), bool), 1, {}, "avg"
    if name == "batch_mismatch":
        return z, 2, {}, "avg"
    raise KeyError(name)


@pytest.mark.parametrize("name", ["legacy_shape", "masked_cls", "variable_counts",
                                  "no_patch_visible", "empty_frame_keep_temporal",
                                  "not_2d", "batch_mismatch"])
def test_mask_errors_match_jax(name):
    mask, batch, kw, pool_type = _error_case(name)
    jm, tm = pair(pool_type)
    x = video(batch=batch, seed=7)
    with pytest.raises(ValueError) as jerr:
        jm(jnp.asarray(x), mask=mask, **kw)
    with pytest.raises(type(jerr.value), match=re.escape(str(jerr.value))):
        with torch.no_grad():
            tm(torch.from_numpy(x), mask=mask, **kw)


def _mask(kind, batch=2):
    if kind == "tube":
        return TTube((4, 2, 2), 0.5)(batch, rng=np.random.default_rng(3))
    if kind == "random":
        return TRandom((4, 2, 2), 0.5)(batch, rng=np.random.default_rng(4))
    # nonuniform visible tokens per frame: 1, 2, 1 and 3 of the 4
    return visible_mask(batch, [0, 1, 5, 6, 9, 13, 14, 15])


@pytest.mark.parametrize("pool_type,kind,keep_temporal", [
    ("cls+avg", "tube", False),
    ("avg", "random", False),
    ("cls+avg", "nonuniform", True),
    ("cls_cat_avg", "tube", True),
])
def test_masked_forward_matches_jax(pool_type, kind, keep_temporal):
    jm, tm = pair(pool_type)
    x, mask = video(seed=1), _mask(kind)
    jv, jp = jm(jnp.asarray(x), mask=mask, keep_temporal=keep_temporal)
    with torch.no_grad():
        tv, tp = tm(torch.from_numpy(x), mask=mask, keep_temporal=keep_temporal)
    visible = int((~mask[0]).sum())
    assert tv.shape == jv.shape == (2, visible - 1, 64)
    assert tp.shape == jp.shape
    assert rel_err(tv, jv) <= TOL["fp32"] and rel_err(tp, jp) <= TOL["fp32"]


def test_masked_forward_features_and_tensor_masks_match_jax():
    """forward_features keeps CLS and the visible tokens in order; a CPU
    tensor mask gives the bits of the NumPy mask."""
    jm, tm = pair("avg", add_pool_norm=False)
    x, mask = video(seed=2), _mask("random")
    jv = jm.forward_features(jnp.asarray(x), mask=mask)
    with torch.no_grad():
        tv = tm.forward_features(torch.from_numpy(x), mask=mask)
        tv_t = tm.forward_features(torch.from_numpy(x), mask=torch.from_numpy(mask))
    assert tv.shape == jv.shape == (2, int((~mask[0]).sum()), 64)
    assert rel_err(tv, jv) <= TOL["fp32"]
    assert torch.equal(tv, tv_t)


def test_masked_temporal_average_is_the_visible_mean():
    """The one-hot pool equals a per-frame mean over the visible tokens."""
    _, tm = pair()
    rng = np.random.default_rng(5)
    mask = _mask("nonuniform", batch=1)
    _, vis = tm._visible_token_positions(mask, 1, TOKENS, require_cls_visible=True)
    patch = torch.from_numpy(rng.standard_normal((1, vis.shape[1] - 1, 8)).astype(np.float32))
    got = tm._masked_temporal_average(patch, vis, 4, 4, has_cls=True)
    frames = (vis[0, 1:] - 1) // 4
    want = np.stack([patch[0].numpy()[frames == t].mean(0) for t in range(4)])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-6, atol=1e-7)


def test_masked_streaming_chunks_match_jax():
    """Chunk 0 (CLS, mask width 1 + 2*4) and a continuation chunk (no CLS,
    width 2*4) with carried state, through both packages' sessions."""
    jm, tm = pair("avg")
    x = video(seed=3)
    masks = [TTube((2, 2, 2), 0.5)(2, rng=np.random.default_rng(6)),
             TTube((2, 2, 2), 0.5, with_cls=False)(2, rng=np.random.default_rng(7))]
    js, ts = JSession(jm, batch_size=2), TSession(tm, batch_size=2)
    for c, mask in enumerate(masks):
        chunk = x[:, :, 2 * c:2 * c + 2]
        jv, jp = js.process(jnp.asarray(chunk), mask=mask, keep_temporal=True)
        tv, tp = ts.process(torch.from_numpy(chunk), mask=mask, keep_temporal=True)
        assert tv.shape == jv.shape and tp.shape == jp.shape == (2, 2, 64)
        assert rel_err(tv, jv) <= TOL["fp32"] and rel_err(tp, jp) <= TOL["fp32"]
        for (jc, jss), (tc, tss) in zip(js.state, ts.state):
            assert rel_err(tc, jc) <= TOL["fp32"] and rel_err(tss, jss) <= TOL["fp32"]


@pytest.mark.parametrize("keep_temporal", [False, True])
def test_masked_bf16_forward_matches_jax_interpret(monkeypatch, keep_temporal):
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    jm, tm = pair("cls+avg", dtype="bf16")
    x, mask = video(seed=4), _mask("tube")
    jv, jp = jm(jnp.asarray(x), mask=mask, keep_temporal=keep_temporal)
    with torch.no_grad():
        tv, tp = tm(torch.from_numpy(x), mask=mask, keep_temporal=keep_temporal)
    assert tv.dtype == torch.bfloat16 and tv.shape == jv.shape and tp.shape == jp.shape
    assert rel_err(tv, jv) <= TOL["bf16"] and rel_err(tp, jp) <= TOL["bf16"]


@pytest.mark.parametrize("cls,size,ratio,batch,seed", [
    ("tube", (8, 14, 14), 0.75, 2, 0),
    ("tube", (4, 2, 2), 0.5, 3, 11),
    ("random", (8, 14, 14), 0.9, 2, 1),
    ("random", (4, 3, 5), 0.3, 4, 12),
])
@pytest.mark.parametrize("with_cls", [True, False])
def test_generator_masks_are_bit_equal_to_jax(cls, size, ratio, batch, seed, with_cls):
    jgen, tgen = {"tube": (JTube, TTube), "random": (JRandom, TRandom)}[cls]
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # consecutive draws from one generator too
        want = jgen(size, ratio, with_cls=with_cls)(batch, rng=rng_j)
        got = tgen(size, ratio, with_cls=with_cls)(batch, rng=rng_t)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)
    assert repr(TTube(size, ratio)) == repr(JTube(size, ratio))


def test_generator_rejects_out_of_range_ratio():
    for gen in (TTube, TRandom):
        with pytest.raises(ValueError, match="out of range"):
            gen((4, 2, 2), 1.5)


TRAIN_GEOM = dict(GEOM, ssm_cfg={"use_fast_path": True}, fused_add_norm=True,
                  rms_norm=True, residual_in_fp32=True, add_pool_norm=False)


def test_masked_train_step_matches_jax_value_and_grad():
    """The port's default loss with ``batch["mask"]`` (visible tokens
    regressed onto a target) against JAX value_and_grad of the same loss."""
    jm = JModel(**TRAIN_GEOM, rng=0)
    jm.params = _perturb(jm.params)
    tm = TModel(**TRAIN_GEOM, device="cpu")
    load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
    rng = np.random.default_rng(8)
    mask = TTube((4, 2, 2), 0.5)(2, rng=rng)
    visible = int((~mask[0]).sum())
    x = rng.standard_normal((2, 3, 4, 16, 16)).astype(np.float32)
    target = rng.standard_normal((2, visible, 64)).astype(np.float32)

    def jloss(p):
        x_vis = jm.apply(p, jnp.asarray(x), mask=mask, deterministic=False,
                         rng=jax.random.PRNGKey(0))
        return jnp.mean(jnp.square(x_vis.astype(jnp.float32) - jnp.asarray(target)))

    jl, jgrads = jax.value_and_grad(jloss)(jm.params)
    opt = torch.optim.AdamW(tm.parameters(), lr=1e-3, weight_decay=0.05)
    metrics = make_train_step(tm, opt)(
        {"video": torch.from_numpy(x), "target": torch.from_numpy(target), "mask": mask})
    assert rel_err(metrics["loss"], jl) <= 2e-5
    view = copy.copy(jm)
    view.params = jax.tree.map(np.asarray, jgrads)
    want = params_to_torch_state_dict(view)
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert set(want) == set(grads)
    for name, g in want.items():
        assert rel_err(grads[name], g) <= 2e-5, name
