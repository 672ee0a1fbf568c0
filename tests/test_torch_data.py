"""The port's data package vs videomamba_tpu's on the CPU.

Chunk iteration and dataset scans against the JAX package's functions; the
port's native clip loader against the JAX loader on the same files, seed and
epoch (bit-equal batches). Both loaders bind the same C++ source; the JAX
wrapper is pointed at the port's build of it, so no test writes the JAX
package's own ``native/build/`` and parallel test workers never race on one
output file.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from videomamba_tpu.data import dataset as jds
from videomamba_tpu.data import native as jnat
from videomamba_tpu.data import video as jvideo
from videomamba_tpu_torch.data import dataset as tds
from videomamba_tpu_torch.data import native as tnat
from videomamba_tpu_torch.data import video as tvideo
from videomamba_tpu_torch.data.masking import RandomMaskingGenerator, TubeMaskingGenerator
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba


@pytest.mark.parametrize("total,chunk,tubelet", [(8, 4, 1), (10, 4, 2), (9, 4, 2),
                                                 (3, 4, 1), (16, 6, 2), (0, 2, 1)])
def test_chunk_video_matches_jax(total, chunk, tubelet):
    assert list(tvideo.chunk_video(total, chunk, tubelet)) == \
        list(jvideo.chunk_video(total, chunk, tubelet))


def test_chunk_video_rejects_misaligned_chunks():
    with pytest.raises(ValueError, match="divisible"):
        list(tvideo.chunk_video(8, 3, tubelet_size=2))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_iter_video_chunks_matches_jax(as_tensor):
    x = np.random.default_rng(0).standard_normal((2, 3, 9, 4, 4)).astype(np.float32)
    want = list(jvideo.iter_video_chunks(x, chunk_frames=4, tubelet_size=2))
    got = list(tvideo.iter_video_chunks(torch.from_numpy(x) if as_tensor else x,
                                        chunk_frames=4, tubelet_size=2))
    assert [o for _, o in got] == [o for _, o in want] == [0, 2]
    for (g, _), (w, _) in zip(got, want):
        assert isinstance(g, torch.Tensor) is as_tensor
        np.testing.assert_array_equal(np.asarray(g), w)
    with pytest.raises(ValueError, match=r"\[B, C, T, H, W\]"):
        list(tvideo.iter_video_chunks(x[0], 4))


def test_chunks_stream_to_the_full_clip():
    """iter_video_chunks' offsets drive the port's streaming forward to the
    full clip's tokens (1e-4, the reference's layer-level bar)."""
    model = PretrainVideoMamba(img_size=8, patch_size=4, depth=2, embed_dim=16,
                               ssm_cfg={"use_fast_path": False, "d_state": 8},
                               fused_add_norm=False, rms_norm=False, residual_in_fp32=False,
                               num_frames=8, add_pool_norm=False, device="cpu").eval()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 3, 8, 8, 8)).astype(np.float32))
    with torch.no_grad():
        full = model(x)
        state = model.init_state(batch_size=1)
        outs = []
        for chunk, offset in tvideo.iter_video_chunks(x, chunk_frames=2):
            out, state = model(chunk, ssm_state=state, temporal_pos_offset=offset)
            outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gen_cls", [TubeMaskingGenerator, RandomMaskingGenerator])
def test_generator_masks_satisfy_the_port_models_contract(gen_cls):
    masks = gen_cls((4, 2, 2), mask_ratio=0.5)(3, rng=np.random.default_rng(0))
    assert masks.shape == (3, 1 + 4 * 2 * 2) and not masks[:, 0].any()
    model = PretrainVideoMamba(img_size=8, patch_size=4, depth=2, embed_dim=16,
                               ssm_cfg={"use_fast_path": False, "d_state": 8},
                               num_frames=4, device="cpu").eval()
    x = torch.zeros((3, 3, 4, 8, 8))
    with torch.no_grad():
        x_vis, _ = model(x, mask=masks)
    assert x_vis.shape == (3, int((~masks[0]).sum()) - 1, 16)


def _write_tree(root, classes=("jump", "run"), per_class=3, T=8, hw=24):
    rng = np.random.default_rng(0)
    for name in classes:
        d = root / name
        d.mkdir()
        for i in range(per_class):
            vid = rng.integers(0, 256, (T, hw, hw, 3), dtype=np.uint8)
            if i % 2:
                np.save(d / f"clip{i}.npy", vid)
            else:
                tnat.write_vraw(d / f"clip{i}.vraw", vid)
    return root


def test_dataset_scans_match_jax(tmp_path):
    root = _write_tree(tmp_path)
    assert tds.scan_class_directories(root) == jds.scan_class_directories(root)
    paths, labels, _ = tds.scan_class_directories(root)
    lst = tmp_path / "train.txt"
    rel = str(Path(paths[2]).relative_to(tmp_path))
    lst.write_text("\n".join(["# comment", "", f"{paths[0]} {labels[0]}",
                              f"'{paths[1]}' {labels[1]}", f"{rel},{labels[2]}"]))
    assert tds.load_file_list(lst) == jds.load_file_list(lst)
    assert tds.load_file_list(lst, root=str(tmp_path)) == \
        jds.load_file_list(lst, root=str(tmp_path))


@pytest.mark.parametrize("content,match", [("just_a_path\n", "expected"),
                                           ("p.vraw notanint\n", "not an int"),
                                           ("# only a comment\n", "no samples")])
def test_file_list_refusals_match_jax(tmp_path, content, match):
    lst = tmp_path / "bad.txt"
    lst.write_text(content)
    with pytest.raises(ValueError, match=match) as jerr:
        jds.load_file_list(lst)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        tds.load_file_list(lst)


def test_scan_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        tds.scan_class_directories(tmp_path / "absent")
    with pytest.raises(ValueError, match="no class subdirectories"):
        tds.scan_class_directories(tmp_path)
    (tmp_path / "empty_class").mkdir()
    with pytest.raises(ValueError, match="no clip files"):
        tds.scan_class_directories(tmp_path)
    with pytest.raises(ValueError, match="exactly one"):
        tds.make_clip_loader()


@pytest.fixture
def jax_loader_on_port_build(monkeypatch):
    """The JAX loader's wrapper bound to the port's build of the same C++."""
    monkeypatch.setattr(jnat, "_SO", tnat.build_native())
    monkeypatch.setattr(jnat, "_lib", None)


def test_native_build_goes_to_the_ports_build_directory():
    so = tnat.build_native()
    assert so.parent == tnat._REPO_ROOT / "build" / "videomamba_tpu_torch"
    assert so.name.startswith("libvideoloader_") and so.exists()
    assert tnat.native_available()


@pytest.mark.parametrize("train,shuffle,short_side,threads", [
    (False, False, 0, 1), (True, True, 28, 3), (True, False, 0, 2)])
def test_native_loader_batches_are_bit_equal_to_jax(tmp_path, jax_loader_on_port_build,
                                                    train, shuffle, short_side, threads):
    root = _write_tree(tmp_path)
    kw = dict(clip_len=4, crop=16, batch_size=4, num_threads=threads, train=train,
              short_side=short_side)
    tload, n_cls = tds.make_clip_loader(data_dir=root, **kw)
    jload, j_cls = jds.make_clip_loader(data_dir=root, **kw)
    assert n_cls == j_cls == 2
    try:
        for epoch in (0, 3):
            got = list(tload.epoch(seed=7, shuffle=shuffle, epoch=epoch))
            want = list(jload.epoch(seed=7, shuffle=shuffle, epoch=epoch))
            assert [c.shape[0] for c, _ in got] == [c.shape[0] for c, _ in want] == [4, 2]
            for (c, lab), (jc, jlab) in zip(got, want):
                assert c.dtype == torch.float32 and lab.dtype == torch.int64
                assert c.device.type == "cpu"
                np.testing.assert_array_equal(c.numpy(), jc)
                np.testing.assert_array_equal(lab.numpy(), jlab)
    finally:
        tload.close()
        jload.close()


def test_native_loader_batches_own_their_memory(tmp_path):
    root = _write_tree(tmp_path, per_class=2)
    loader, _ = tds.make_clip_loader(data_dir=root, clip_len=2, crop=16, batch_size=2)
    try:
        batches = list(loader.epoch(seed=0))
        again = list(loader.epoch(seed=0, epoch=0))
    finally:
        loader.close()
    assert len(batches) == 2
    assert batches[0][0].data_ptr() != batches[1][0].data_ptr()
    assert not torch.equal(batches[0][0], batches[1][0])
    assert torch.equal(batches[0][0], again[0][0])


def test_native_loader_refusals(tmp_path):
    bad = tmp_path / "bad.vraw"
    bad.write_bytes(b"NOTMAGIC" + b"\0" * 16)
    with pytest.raises(RuntimeError, match="magic"):
        tnat.NativeClipLoader([str(bad)], clip_len=2, crop=8, batch_size=1)
    with pytest.raises(ValueError, match=r"\(T, H, W, C\)"):
        tnat.write_vraw(tmp_path / "x.vraw", np.zeros((4, 4, 3), np.uint8))
