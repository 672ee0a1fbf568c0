"""The port's three examples, run on the CPU at small sizes.

The classifier runs the whole loop (shards, native loader, FSDP2 step over
a one-rank gloo mesh, train state saved each epoch, resume) with the JAX
example test's checks (tests/test_example_classifier.py): loss below 1.0,
resume parity exactly 0, ``ckpt_ep1`` written. The masked-pretraining
example takes three steps with finite losses, its first step's loss and
gradient norm the JAX model's on the same weights and batch; the streaming
example's first chunk equals a full forward of those frames at
rel_err = max|a - b| / max|b| <= 1e-4, and on the JAX preset's weights
every chunk's pooled features are the JAX session's at 1e-5. Every new
entry point raises without a card unless given ``--device cpu``.
"""

import importlib.util
import math
import os
import tempfile

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(relpath):
    name = "example_" + relpath.replace("/", "_").replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_classifier_end_to_end(tmp_path, capsys, monkeypatch):
    from videomamba_tpu_torch.data import native as nat

    if not nat.native_available():  # pragma: no cover - g++ is in the image
        pytest.skip("native loader unavailable")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the synthesized shards
    result = load("examples/train_classifier_torch.py").main([
        "--epochs", "2", "--depth", "1", "--embed-dim", "32",
        "--img", "32", "--frames", "4", "--classes", "2", "--batch", "4",
        "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert result.loss < 1.0  # 2-class CE starts at ~0.69 + margin; must be finite/learning
    assert "resume parity: max |param diff| after replayed epoch = 0.00e+00" in out
    assert os.path.exists(tmp_path / "ckpt" / "ckpt_ep1.pt")
    assert not torch.distributed.is_initialized()


def test_masked_pretrain_takes_three_steps(capsys, monkeypatch, tmp_path):
    """Three steps at the JAX example's defaults with finite losses; the
    first step's loss and ``grad_norm`` against the JAX model on the same
    weights (the port model's, read by the JAX ``load_state_dict``), video,
    tube mask and target: loss 1e-5, ``grad_norm`` 1e-4 (relative)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from videomamba_tpu import checkpoint as jckpt
    from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
    from videomamba_tpu_torch import parallel

    first = {}
    make_step = parallel.make_train_step

    def recording(model, optimizer, **kw):
        step = make_step(model, optimizer, **kw)

        def recorded(batch, *args, **kwargs):
            if not first:
                first["params"] = parallel.full_state_dict(model)  # before the update
                first["batch"] = {k: np.array(v) for k, v in batch.items()}
                first["metrics"] = {k: float(v) for k, v in step(batch, *args, **kwargs).items()}
                return first["metrics"]
            return step(batch, *args, **kwargs)
        return recorded

    monkeypatch.setattr(parallel, "make_train_step", recording)
    result = load("examples/train_masked_pretrain_torch.py").main(
        ["--steps", "3", "--device", "cpu"])
    assert len(result.losses) == 3 and all(math.isfinite(v) for v in result.losses)
    assert result.n_visible == 1 + 8 * 1  # CLS + a quarter of the 2 x 2 grid, 8 frames
    assert "mesh: {'dp': 1, 'fsdp': 1, 'tp': 1}" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()

    path = str(tmp_path / "step0.pt")
    torch.save({k: v.float() for k, v in first["params"].items()}, path)
    jm = JModel(img_size=32, patch_size=16, depth=4, embed_dim=128, channels=3,
                fused_add_norm=True, rms_norm=True, residual_in_fp32=True, kernel_size=1,
                num_frames=8, add_pool_norm=False, rng=1)
    jckpt.load_state_dict(path, jm, ckpt_num_frame=8, num_frames=8)
    batch = first["batch"]

    def loss_fn(params):
        x_vis = jm.apply(params, jnp.asarray(batch["video"]), mask=batch["mask"])
        return jnp.mean(jnp.square(x_vis.astype(jnp.float32) - batch["target"]))

    loss, grads = jax.value_and_grad(loss_fn)(jm.params)
    grad_norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree.leaves(grads))))
    assert abs(first["metrics"]["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    assert abs(first["metrics"]["grad_norm"] - grad_norm) <= 1e-4 * grad_norm


def test_streaming_serving_first_chunk_equals_full_forward(monkeypatch):
    """The tiny preset at 4-frame chunks of a 16-frame clip, fp32, its
    weights the JAX preset's (``params_from_jax``): the first chunk's
    features equal a full forward of those frames at 1e-4, and every
    chunk's pooled features and patch tokens the JAX ``StreamingSession``'s
    on the same clip at 1e-5."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from videomamba_tpu import StreamingSession as JSession
    from videomamba_tpu.models import presets as jpresets
    from videomamba_tpu_torch.checkpoint import load_state_dict, params_from_jax
    from videomamba_tpu_torch.models import presets

    jm = jpresets.videomamba_tiny(num_frames=4, pool_type="avg", dtype=jnp.float32, rng=0)
    tree = jax.tree.map(np.asarray, jm.params)
    build = presets.videomamba_tiny

    def jax_weights(**kw):
        model = build(**kw)
        load_state_dict(model, params_from_jax(tree, model))
        return model

    monkeypatch.setattr(presets, "videomamba_tiny", jax_weights)
    result = load("examples/streaming_serving_torch.py").main(
        ["--preset", "tiny", "--frames", "16", "--chunk", "4", "--fp32", "--device", "cpu"])
    assert len(result.pools) == 4 and len(result.chunk_ms) == 4
    with torch.no_grad():
        x_vis, _ = result.model(result.video[:, :, :4])
    err = float((result.first_vis - x_vis).abs().max() / x_vis.abs().max())
    assert err <= 1e-4
    session = JSession(jm, batch_size=1, dtype=jnp.float32)
    video = result.video.numpy()
    for i, pool in enumerate(result.pools):
        j_vis, j_pool = session.process(jnp.asarray(video[:, :, 4 * i:4 * i + 4]))
        j_pool = np.asarray(j_pool, np.float64)
        assert float(np.abs(pool.numpy() - j_pool).max() / np.abs(j_pool).max()) <= 1e-5, i
        if i == 0:
            j_vis = np.asarray(j_vis, np.float64)
            got = result.first_vis.numpy()
            assert float(np.abs(got - j_vis).max() / np.abs(j_vis).max()) <= 1e-5


ENTRY_POINTS = {
    "scripts/check_streaming_state_torch.py": [],
    "scripts/convert_checkpoint_torch.py": ["to-torch", "in.pt", "out.pt"],
    "examples/streaming_serving_torch.py": [],
    "examples/train_masked_pretrain_torch.py": [],
    "examples/train_classifier_torch.py": ["--data-dir", "."],
}


@pytest.mark.parametrize("relpath", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_a_card(relpath, monkeypatch):
    """No card and no ``--device cpu``: each raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        load(relpath).main(ENTRY_POINTS[relpath])
