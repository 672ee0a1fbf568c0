"""The port's command-line scripts vs the JAX package's on the CPU.

``scripts/check_streaming_state_torch.py`` passes where
``scripts/check_streaming_state.py`` passes, on the same arguments (each
holds its own full sequence against the split one at rtol / atol 1e-4),
and its check, on the JAX script's mixer and input, gives the JAX mixer's
outputs at 1e-5 and its input gradient at 2e-5.
``scripts/convert_checkpoint_torch.py`` round-trips a reference ``.pt``
bit for bit, and a model loaded from its native file agrees with the JAX
model loaded from the same ``.pt`` by the JAX ``load_state_dict``, at
rel_err = max|a - b| / max|b| <= 1e-5.
"""

import importlib.util
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(relpath):
    """A script of the repo as a module (its ``main`` not run)."""
    name = "script_" + relpath.replace("/", "_").replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


@pytest.fixture
def global_modes(monkeypatch):
    """Undo what the scripts' determinism flags set process-wide: torch's
    switches, the CUBLAS variable, both packages' key counters and JAX's
    matmul precision."""
    import videomamba_tpu.determinism as jdet
    import videomamba_tpu_torch.determinism as tdet

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    saved = dict(
        det=torch.are_deterministic_algorithms_enabled(),
        warn=torch.is_deterministic_algorithms_warn_only_enabled(),
        cudnn=(torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
               torch.backends.cudnn.allow_tf32),
        tf32=torch.backends.cuda.matmul.allow_tf32,
        tkeys=(tdet._KEYS.seed, tdet._KEYS.count),
        jkeys=(jdet._ROOT_KEY, jdet._KEY_COUNTER),
        precision=jax.config.jax_default_matmul_precision,
    )
    yield
    torch.use_deterministic_algorithms(saved["det"], warn_only=saved["warn"])
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32) = saved["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = saved["tf32"]
    tdet._KEYS.seed, tdet._KEYS.count = saved["tkeys"]
    jdet._ROOT_KEY, jdet._KEY_COUNTER = saved["jkeys"]
    jax.config.update("jax_default_matmul_precision", saved["precision"])


STREAM_ARGS = ["--seed", "7", "--deterministic", "--batch-size", "2", "--seqlen", "12",
               "--split", "5", "--d-model", "16"]


def test_streaming_check_passes_where_the_jax_script_passes(capsys, monkeypatch, global_modes):
    jax_script = load_script("scripts/check_streaming_state.py")
    monkeypatch.setattr(sys, "argv", ["check_streaming_state.py"] + STREAM_ARGS)
    jax_script.main()
    jax_out = capsys.readouterr().out.strip().splitlines()[-1]
    port = load_script("scripts/check_streaming_state_torch.py")
    max_diff = port.main(STREAM_ARGS + ["--device", "cpu"])
    port_out = capsys.readouterr().out.strip().splitlines()
    assert port_out[-1] == jax_out == "Streaming state check passed. contract=1.0.0"
    assert max_diff <= 1e-4 and port_out[0].startswith("full vs split at")


@pytest.mark.parametrize("fast_path,d_model,batch,seqlen,split",
                         [(False, 16, 2, 12, 5), (True, 128, 1, 40, 17)])
def test_streaming_check_holds_the_jax_mixer_numbers(fast_path, d_model, batch, seqlen, split):
    """The port CLI's check (``check_streaming``) on the JAX script's mixer:
    its weights carried across and its input drawn as the JAX script draws
    them (seed 7). The full and the split outputs agree with the JAX
    mixer's at 1e-5, the input gradient of the split outputs' sum with
    ``jax.grad``'s at 2e-5 (tests/test_mixer_bwd.py:76's bar). At d_model
    128 both packages take their fused mixer (K3 and K6's plain versions
    here)."""
    from test_torch_model import _mixer_state_dict
    from videomamba_tpu.models.mamba import Mamba as JMamba
    from videomamba_tpu_torch.models.mamba import Mamba as TMamba

    jmix = JMamba(d_model=d_model, d_state=8, d_conv=4, expand=2, use_fast_path=fast_path)
    k_params, k_x = jax.random.split(jax.random.PRNGKey(7))
    params = jmix.init(k_params)
    x = jax.random.normal(k_x, (batch, seqlen, d_model), jnp.float32)
    j_full = jmix(params, x)
    o1, st = jmix(params, x[:, :split], return_state=True)
    o2, _ = jmix(params, x[:, split:], state=st, return_state=True)
    j_split = jnp.concatenate([o1, o2], axis=1)

    def loss(x_):
        a, s = jmix(params, x_[:, :split], return_state=True)
        b, _ = jmix(params, x_[:, split:], state=s, return_state=True)
        return jnp.sum(a) + jnp.sum(b)

    j_grad = jax.grad(loss)(x)
    tmix = TMamba(d_model, d_state=8, d_conv=4, expand=2, use_fast_path=fast_path,
                  device="cpu")
    tmix.load_state_dict(_mixer_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    assert tmix._use_fused_mixer() == fast_path
    got = load_script("scripts/check_streaming_state_torch.py").check_streaming(
        tmix, torch.from_numpy(np.array(x)), split)
    assert rel_err(got.out_full, j_full) <= 1e-5
    assert rel_err(got.out_chunked, j_split) <= 1e-5
    assert rel_err(got.grad, j_grad) <= 2e-5


def test_streaming_check_on_the_fast_path(capsys, global_modes):
    """``--fast-path`` at a width the fused mixer takes (d_inner 256): the
    mixer kernel's plain version forward and its backward's, through the
    split with carried state."""
    from videomamba_tpu_torch.ops.kernels import mixer_bwd, mixer_fused

    port = load_script("scripts/check_streaming_state_torch.py")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = mixer_fused.mixer_fused_plain, mixer_bwd.mixer_bwd_plain

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mixer_fused, "mixer_fused_plain", count("fwd", fwd))
        mp.setattr(mixer_bwd, "mixer_bwd_plain", count("bwd", bwd))
        max_diff = port.main(["--seed", "3", "--batch-size", "1", "--seqlen", "40",
                              "--split", "17", "--d-model", "128", "--fast-path",
                              "--device", "cpu"])
    assert max_diff <= 1e-4 and calls["fwd"] >= 5 and calls["bwd"] == 2
    assert capsys.readouterr().out.strip().endswith("contract=1.0.0")


GEOM = ["--img-size", "32", "--patch-size", "16", "--depth", "2", "--embed-dim", "32"]


def _port_reference_pt(tmp_path, frames):
    """A seeded port model of GEOM's shape with a nonzero temporal
    embedding, written as a reference ``.pt``."""
    from videomamba_tpu_torch.checkpoint import save_torch_state_dict
    from videomamba_tpu_torch.models import PretrainVideoMamba

    src = PretrainVideoMamba(img_size=32, patch_size=16, depth=2, embed_dim=32,
                             num_frames=frames, device="cpu",
                             generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        src.temporal_pos_embedding.normal_(generator=torch.Generator().manual_seed(12))
    path = str(tmp_path / f"ref_{frames}.pt")
    save_torch_state_dict(path, src)
    return path


def test_checkpoint_cli_round_trip_is_bit_equal(tmp_path):
    cli = load_script("scripts/convert_checkpoint_torch.py")
    ref = _port_reference_pt(tmp_path, 4)
    native, back = str(tmp_path / "native.pt"), str(tmp_path / "back.pt")
    cli.main(["to-native", ref, native, *GEOM, "--num-frames", "4", "--device", "cpu"])
    cli.main(["to-torch", native, back, *GEOM, "--num-frames", "4", "--device", "cpu"])
    a = torch.load(ref, weights_only=True)
    b = torch.load(back, weights_only=True)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("ckpt_frames,frames", [(4, 4), (4, 8)])
def test_native_file_model_matches_jax_loaded_model(tmp_path, ckpt_frames, frames):
    """The port model from the ``to-native`` file, and the JAX model the JAX
    script builds for the same flags, loaded from the same ``.pt`` by the
    JAX ``load_state_dict`` (at 8 frames through the temporal resample):
    the same features at 1e-5."""
    from videomamba_tpu import checkpoint as jckpt
    from videomamba_tpu_torch import checkpoint as tckpt

    cli = load_script("scripts/convert_checkpoint_torch.py")
    jcli = load_script("scripts/convert_checkpoint.py")
    ref = _port_reference_pt(tmp_path, ckpt_frames)
    native = str(tmp_path / "native.pt")
    flags = [*GEOM, "--num-frames", str(frames), "--ckpt-num-frame", str(ckpt_frames)]
    cli.main(["to-native", ref, native, *flags, "--device", "cpu"])
    tm = cli._build(SimpleNamespace(img_size=32, patch_size=16, depth=2, embed_dim=32,
                                    channels=3, kernel_size=1, num_frames=frames,
                                    rms_norm=True, no_pool_norm=False), "cpu")
    tckpt.load_params(native, tm)
    jm = jcli._build(SimpleNamespace(img_size=32, patch_size=16, depth=2, embed_dim=32,
                                     channels=3, kernel_size=1, num_frames=frames,
                                     rms_norm=True, no_pool_norm=False))
    jckpt.load_state_dict(ref, jm, ckpt_num_frame=ckpt_frames, num_frames=frames)
    x = np.random.default_rng(5).standard_normal((1, 3, frames, 32, 32)).astype(np.float32)
    jv, jp = jm(jnp.asarray(x))
    with torch.no_grad():
        tv, tp = tm.eval()(torch.from_numpy(x))
    assert rel_err(tv, jv) <= 1e-5 and rel_err(tp, jp) <= 1e-5
