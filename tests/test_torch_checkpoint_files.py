"""The port's checkpoint files vs videomamba_tpu's on the CPU.

Every file is written by the test. A ``.pt`` state_dict written by either
package loads into the other with bit-equal parameters, the spatial
pos-embed re-grid and the temporal resample included (both packages build
the same NumPy matrices and run the same NumPy einsums); the loaded models'
forwards agree within 1e-5 (rel_err = max|a - b| / max|b|). ``load_timm_npz``
maps a synthetic timm ``.npz`` to the same values as the JAX loader. The
geometry is the JAX checkpoint test's (img 8, patch 4, depth 2, embed 16).
"""

import re
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu import checkpoint as jckpt
from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.models.videomamba import build_videomamba as j_build
from videomamba_tpu_torch import checkpoint as tckpt
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.models.videomamba import build_videomamba as t_build

SMALL = dict(img_size=8, patch_size=4, depth=2, embed_dim=16, channels=3,
             ssm_cfg={"use_fast_path": False, "d_state": 8}, fused_add_norm=False,
             rms_norm=False, residual_in_fp32=False, kernel_size=1, num_frames=4)


def jmodel(rng=1, **overrides):
    jm = JModel(**dict(SMALL, **overrides), rng=rng)
    # A nonzero temporal embedding, so its resample shows.
    p = jax.tree.map(np.asarray, jm.params)
    p["temporal_pos_embedding"] = np.random.default_rng(rng).standard_normal(
        p["temporal_pos_embedding"].shape).astype(np.float32)
    jm.params = jax.tree.map(jnp.asarray, p)
    return jm


def tmodel(**overrides):
    return TModel(**dict(SMALL, **overrides), device="cpu",
                  generator=torch.Generator().manual_seed(5)).eval()


def jax_sd(jm):
    """The JAX model's parameters as a torch-layout state_dict (numpy)."""
    return jckpt.params_to_torch_state_dict(jm)


def assert_sd_equal(port_model, want):
    got = port_model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def forwards_agree(jm, tm, frames, hw):
    x = np.random.default_rng(3).standard_normal((1, 3, frames) + hw).astype(np.float32)
    jv, jp = jm(jnp.asarray(x))
    with torch.no_grad():
        tv, tp = tm(torch.from_numpy(x))
    assert rel_err(tv.numpy(), jv) <= 1e-5 and rel_err(tp.numpy(), jp) <= 1e-5


@pytest.mark.parametrize("img,num_frames", [(8, 4), ((8, 12), 8), ((12, 8), 2)])
def test_jax_file_loads_into_port_like_jax(tmp_path, img, num_frames):
    """JAX save -> port load_checkpoint and JAX load_state_dict of the same
    file: bit-equal parameters (re-grid 2x2 -> target grid, temporal 4 ->
    num_frames), forwards within 1e-5."""
    path = str(tmp_path / "sd.pt")
    jckpt.save_torch_state_dict(path, jmodel())
    jdst = jmodel(rng=2, img_size=img, num_frames=num_frames)
    jckpt.load_state_dict(path, jdst, ckpt_num_frame=4, num_frames=num_frames)
    tdst = tmodel(img_size=img, num_frames=num_frames)
    tckpt.load_checkpoint(path, tdst, ckpt_num_frame=4, num_frames=num_frames)
    assert_sd_equal(tdst, jax_sd(jdst))
    forwards_agree(jdst, tdst, num_frames, (img, img) if isinstance(img, int) else img)


def test_port_file_loads_into_jax(tmp_path):
    """Port save -> JAX load (with a re-grid and a resample) equals port
    save -> port load, bit for bit."""
    src = tmodel()
    with torch.no_grad():
        src.temporal_pos_embedding.normal_(generator=torch.Generator().manual_seed(6))
    path = str(tmp_path / "port.pt")
    tckpt.save_torch_state_dict(path, src)
    saved = torch.load(path, weights_only=True)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in saved.values())
    jdst = jmodel(rng=3, img_size=(8, 12), num_frames=8)
    jckpt.load_state_dict(path, jdst, ckpt_num_frame=4, num_frames=8)
    tdst = tmodel(img_size=(8, 12), num_frames=8)
    tckpt.load_checkpoint(path, tdst, ckpt_num_frame=4, num_frames=8)
    assert_sd_equal(tdst, jax_sd(jdst))
    # Without a re-grid the round trip is the identity.
    same = tmodel()
    tckpt.load_checkpoint(path, same, ckpt_num_frame=4, num_frames=4)
    assert_sd_equal(same, {k: v.numpy() for k, v in src.state_dict().items()})


def _bad_file(tmp_path, kind):
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in jax_sd(jmodel()).items()}
    path = tmp_path / f"{kind}.pt"
    if kind == "model_wrapper":
        torch.save({"model": sd}, path)
    elif kind == "module_wrapper":
        torch.save({"module": sd, "epoch": 3}, path)
    elif kind == "not_a_dict":
        torch.save(torch.ones(3), path)
    elif kind == "non_tensor_entry":
        torch.save(dict(sd, step=torch.ones(1), note=[1, 2]), path)
    return str(path)


@pytest.mark.parametrize("kind", ["model_wrapper", "module_wrapper", "not_a_dict",
                                  "non_tensor_entry"])
def test_refusals_match_jax(tmp_path, kind):
    path = _bad_file(tmp_path, kind)
    with pytest.raises((TypeError, ValueError)) as jerr:
        jckpt.load_state_dict(path, jmodel(), ckpt_num_frame=4, num_frames=4)
    with pytest.raises(type(jerr.value), match=re.escape(str(jerr.value))):
        tckpt.load_checkpoint(path, tmodel(), ckpt_num_frame=4, num_frames=4)


@pytest.mark.parametrize("ckpt_num_frame", [None, 0, -4])
def test_ckpt_num_frame_is_required(tmp_path, ckpt_num_frame):
    path = str(tmp_path / "sd.pt")
    tckpt.save_torch_state_dict(path, tmodel())
    with pytest.raises(ValueError, match="ckpt_num_frame must be a positive integer"):
        tckpt.load_checkpoint(path, tmodel(), ckpt_num_frame=ckpt_num_frame, num_frames=4)


def test_missing_and_unexpected_keys_raise(tmp_path):
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in jax_sd(jmodel()).items()}
    missing = dict(sd)
    del missing["layers.0.mixer.A_log"]
    torch.save(missing, tmp_path / "missing.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        tckpt.load_checkpoint(str(tmp_path / "missing.pt"), tmodel(), 4, 4)
    torch.save(dict(sd, **{"bogus.weight": torch.ones(3)}), tmp_path / "extra.pt")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tckpt.load_checkpoint(str(tmp_path / "extra.pt"), tmodel(), 4, 4)


# --------------------------------------------------------------- timm .npz

def _timm_npz(tmp_path, grid=2, embed=16, patch=4, with_blocks=True, prefix_tokens=1):
    rng = np.random.default_rng(0)
    arrs = {
        "embedding/kernel": rng.normal(size=(patch, patch, 3, embed)).astype(np.float32),
        "embedding/bias": rng.normal(size=(embed,)).astype(np.float32),
        "cls": rng.normal(size=(1, 1, embed)).astype(np.float32),
        "Transformer/posembed_input/pos_embedding":
            rng.normal(size=(1, prefix_tokens + grid * grid, embed)).astype(np.float32),
        "Transformer/encoder_norm/scale": rng.normal(size=(embed,)).astype(np.float32),
        "Transformer/encoder_norm/bias": rng.normal(size=(embed,)).astype(np.float32),
    }
    if with_blocks:
        arrs["Transformer/encoderblock_0/LayerNorm_0/scale"] = np.ones(embed, np.float32)
        arrs["head/kernel"] = rng.normal(size=(embed, 10)).astype(np.float32)
    path = tmp_path / "vit.npz"
    np.savez(str(path), **arrs)
    return str(path)


VIT = dict(SMALL, kernel_size=2, num_frames=2, add_pool_norm=False)


def vit_pair():
    jm = JModel(**VIT, rng=0)
    tm = TModel(**VIT, device="cpu")
    tckpt.load_state_dict(tm, tckpt.params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
    return jm, tm


@pytest.mark.parametrize("grid,prefix_tokens,num_prefix", [(2, 1, None), (3, 1, None),
                                                           (3, 2, 2)])
@pytest.mark.parametrize("on_unmapped", ["ignore", "warn", "error"])
def test_load_timm_npz_matches_jax(tmp_path, grid, prefix_tokens, num_prefix, on_unmapped):
    """The same mapped values as the JAX loader (tubelet broadcast of the
    patch kernel, the pos-embed re-grid after the prefix tokens, the encoder
    norm), bit for bit; unmapped ViT groups ignored, warned of or refused."""
    jm, tm = vit_pair()
    path = _timm_npz(tmp_path, grid=grid, prefix_tokens=prefix_tokens)
    kw = dict(on_unmapped=on_unmapped, num_prefix_tokens=num_prefix)
    if on_unmapped == "error":
        with pytest.raises(ValueError) as jerr:
            jckpt.load_timm_npz(path, jm, **kw)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            tckpt.load_timm_npz(path, tm, **kw)
        return
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jparams = jckpt.load_timm_npz(path, jm, **kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        sd = tckpt.load_timm_npz(path, tm, **kw)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(tw) == (on_unmapped == "warn")
    want = tckpt.params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)


def test_load_timm_npz_refuses_an_implausible_grid(tmp_path):
    jm, tm = vit_pair()
    path = _timm_npz(tmp_path, grid=2, prefix_tokens=0, with_blocks=False)
    with pytest.raises(ValueError) as jerr:
        jckpt.load_timm_npz(path, jm)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        tckpt.load_timm_npz(path, tm)


def test_load_pretrained_loads_the_mapped_subset(tmp_path):
    jm, tm = vit_pair()
    path = _timm_npz(tmp_path, with_blocks=False)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.load_pretrained(path)
    jm.load_pretrained(path)
    assert_sd_equal(tm, jax_sd(jm))
    assert torch.equal(tm.layers[0].mixer.A_log, before["layers.0.mixer.A_log"])
    assert not torch.equal(tm.cls_token, before["cls_token"])


# ----------------------------------------------------- params and train state

def test_params_round_trip(tmp_path):
    src, dst = tmodel(), TModel(**SMALL, device="cpu")
    path = str(tmp_path / "params.pt")
    tckpt.save_params(path, src)
    assert tckpt.load_params(path, dst) is dst
    assert_sd_equal(dst, {k: v.numpy() for k, v in src.state_dict().items()})


def test_train_state_round_trip_resumes_the_same_run(tmp_path):
    """Two AdamW steps straight through equal one step, a save, a load into
    a fresh model and optimizer, and the second step: bit for bit."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 3, 4, 8, 8)).astype(np.float32))

    def step(model, opt):
        opt.zero_grad()
        model(x)[0].square().mean().backward()
        opt.step()

    def fresh():
        m = tmodel()
        return m, torch.optim.AdamW(m.parameters(), lr=1e-2, weight_decay=0.05)

    straight, opt = fresh()
    step(straight, opt)
    step(straight, opt)

    first, opt1 = fresh()
    step(first, opt1)
    path = str(tmp_path / "train.pt")
    tckpt.save_train_state(path, first, opt1, step=1)
    resumed, opt2 = fresh()
    assert tckpt.load_train_state(path, resumed, opt2) == 1
    step(resumed, opt2)
    assert_sd_equal(resumed, {k: v.numpy() for k, v in straight.state_dict().items()})


def test_build_videomamba_with_pretrained_matches_jax(tmp_path):
    path = str(tmp_path / "mini.pt")
    jckpt.save_torch_state_dict(path, jmodel(rng=4))
    enc = dict(img_size=8, patch_size=4, depth=2, embed_dim=16, channels=3,
               drop_path_rate=0.0, ssm_cfg={"use_fast_path": False, "d_state": 8},
               norm_epsilon=1e-5, fused_add_norm=False, rms_norm=False,
               residual_in_fp32=False, bimamba=True, pool_type="cls+avg",
               kernel_size=1, num_frames=8, use_checkpoint=False, checkpoint_num=0,
               pretrained=path, ckpt_num_frame=4)
    cfg = SimpleNamespace(vision_encoder=SimpleNamespace(**enc))
    jm = j_build(cfg)
    tm = t_build(cfg, device="cpu").eval()
    assert isinstance(tm, TModel)
    assert_sd_equal(tm, jax_sd(jm))
    forwards_agree(jm, tm, 8, (8, 8))


@pytest.mark.parametrize("num_frames", [8, 16])
def test_load_state_dict_takes_the_jax_form(tmp_path, num_frames):
    """``load_state_dict(path, model, ckpt_num_frame, num_frames)``, the JAX
    and reference form, equals ``load_checkpoint`` bit for bit (at 16
    frames through the temporal resample) and the JAX loader's values; the
    ``(model, state_dict)`` form still loads."""
    path = str(tmp_path / "sd.pt")
    jckpt.save_torch_state_dict(path, jmodel(num_frames=8))
    by_name, by_loader = tmodel(num_frames=num_frames), tmodel(num_frames=num_frames)
    tckpt.load_state_dict(path, by_name, 8, num_frames)
    tckpt.load_checkpoint(path, by_loader, 8, num_frames)
    assert_sd_equal(by_name, {k: v.numpy() for k, v in by_loader.state_dict().items()})
    jdst = jmodel(rng=2, num_frames=num_frames)
    jckpt.load_state_dict(path, jdst, 8, num_frames)
    assert_sd_equal(by_name, jax_sd(jdst))
    again = tmodel(num_frames=num_frames)
    tckpt.load_state_dict(again, by_name.state_dict())
    assert_sd_equal(again, {k: v.numpy() for k, v in by_name.state_dict().items()})
