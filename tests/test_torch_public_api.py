"""The port's public surface vs videomamba_tpu's (tests/test_public_api_contract.py
without its ``video_mamba`` / ``models`` alias checks, whose facades import
the JAX package)."""

import numpy as np
import pytest
import torch

import videomamba_tpu
import videomamba_tpu.models
import videomamba_tpu.data
import videomamba_tpu_torch
import videomamba_tpu_torch.data
import videomamba_tpu_torch.models
from videomamba_tpu_torch.models import PretrainVideoMamba


@pytest.mark.parametrize("jax_mod,port_mod", [
    (videomamba_tpu, videomamba_tpu_torch),
    (videomamba_tpu.models, videomamba_tpu_torch.models),
    (videomamba_tpu.data, videomamba_tpu_torch.data),
])
def test_every_jax_export_is_a_port_export(jax_mod, port_mod):
    missing = sorted(set(jax_mod.__all__) - set(port_mod.__all__))
    assert not missing, f"{port_mod.__name__} lacks {missing}"
    for name in port_mod.__all__:
        assert getattr(port_mod, name) is not None, name


def _small_model(**overrides):
    kwargs = dict(img_size=8, patch_size=4, depth=2, embed_dim=16, channels=3,
                  ssm_cfg={"use_fast_path": False, "d_state": 8}, fused_add_norm=False,
                  rms_norm=False, residual_in_fp32=False, kernel_size=1, num_frames=4,
                  device="cpu")
    kwargs.update(overrides)
    return PretrainVideoMamba(**kwargs).eval()


def test_streaming_contract_allocate_and_validate():
    vm = videomamba_tpu_torch
    model = _small_model()
    state = vm.allocate_state(model, batch_size=2, dtype=torch.float32)
    vm.validate_state(model, state, batch_size=2)
    shapes = vm.expected_state_shapes(model, batch_size=2)
    assert shapes == model.expected_state_shapes(2)
    assert len(shapes) == model.depth == model.get_num_layers()
    assert shapes[0].conv_state == (2, model.layers[0].mixer.d_inner, 4)
    assert shapes[0].ssm_state == (2, model.layers[0].mixer.d_inner, 8)
    with pytest.raises(ValueError, match="positive"):
        model.expected_state_shapes(0)
    assert [tuple(c.shape) for c, _ in model.init_state(2)] == \
        [s.conv_state for s in shapes.values()]


def test_mamba2_state_shapes_come_from_the_mixer():
    model = _small_model(ssm_cfg={"layer": "Mamba2", "d_state": 8, "headdim": 8,
                                  "chunk_size": 4})
    shapes = model.expected_state_shapes(3)
    conv, ssm = model.layers[0].mixer.state_shapes(3)
    assert shapes[1].conv_state == tuple(conv) and shapes[1].ssm_state == tuple(ssm)
    assert len(shapes[0].ssm_state) == 4


def test_model_contract_metadata_and_forward_semantics():
    vm = videomamba_tpu_torch
    model = _small_model(add_pool_norm=True)
    assert model.streaming_contract_version == vm.STREAMING_CONTRACT_VERSION
    semantics = model.forward_return_semantics()
    assert semantics == vm.model_forward_return_semantics(model)
    assert semantics.without_state == "(x_vis, x_pool)"
    assert semantics.with_state == "(x_vis, x_pool, next_state)"
    s = _small_model(add_pool_norm=False).forward_return_semantics()
    assert s.without_state == "x_vis"
    assert s.with_state == "(x_vis, next_state)"
    assert vm.model_forward_return_semantics(object()) == vm.forward_return_semantics(True)


def test_configure_determinism_reseeds_rng():
    vm = videomamba_tpu_torch
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_rng_state(), np.random.get_state())
    try:
        vm.configure_determinism(seed=1234, deterministic=True)
        x1 = torch.randn(8, generator=vm.next_rng_key())
        vm.configure_determinism(seed=1234, deterministic=True)
        x2 = torch.randn(8, generator=vm.next_rng_key())
        assert torch.equal(x1, x2)
    finally:  # the other tests in this worker see the switches they had
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = saved[2:6]
        torch.set_rng_state(saved[6])
        np.random.set_state(saved[7])


def test_minimal_streaming_forward_contract():
    vm = videomamba_tpu_torch
    model = _small_model(add_pool_norm=False)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, 4, 8, 8)).astype(np.float32))
    state = vm.allocate_state(model, batch_size=1, dtype=x.dtype)
    with torch.no_grad():
        first_chunk, state = model(x[:, :, :2], mask=None, use_image=False,
                                   ssm_state=state, temporal_pos_offset=0)
        second_chunk, next_state = model(x[:, :, 2:], mask=None, use_image=False,
                                         ssm_state=state, temporal_pos_offset=2)
    vm.validate_state(model, next_state, batch_size=1)
    assert first_chunk.shape == (1, 1 + 2 * 2 * 2, model.embed_dim)
    assert second_chunk.shape == (1, 2 * 2 * 2, model.embed_dim)


def test_time_fn_returns_the_median_of_synced_calls():
    from videomamba_tpu_torch.runtime import time_fn

    calls = []
    median, times = time_fn(lambda v: calls.append(v), 3, warmup=2, iters=5, device="cpu")
    assert calls == [3] * 7 and len(times) == 5
    assert median == sorted(times)[2] and all(t >= 0 for t in times)
