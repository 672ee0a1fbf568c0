"""The port's determinism module: flags, tri-state arguments, seeding.

Runs on the CPU; it sets PyTorch's process-wide switches, so a fixture
saves every one of them (and every RNG state) before each test and restores
them after, for the other test files that share the worker process.
"""

import argparse
import os
import random

import numpy as np
import pytest
import torch

from videomamba_tpu import determinism as jdet
from videomamba_tpu_torch import determinism as tdet


@pytest.fixture(autouse=True)
def _restore_global_state():
    saved = dict(
        deterministic=torch.are_deterministic_algorithms_enabled(),
        warn_only=torch.is_deterministic_algorithms_warn_only_enabled(),
        cudnn_deterministic=torch.backends.cudnn.deterministic,
        cudnn_benchmark=torch.backends.cudnn.benchmark,
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        cublas=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        torch_rng=torch.get_rng_state(),
        np_rng=np.random.get_state(),
        py_rng=random.getstate(),
        keys=(tdet._KEYS.seed, tdet._KEYS.count),
    )
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved["deterministic"],
                                           warn_only=saved["warn_only"])
        torch.backends.cudnn.deterministic = saved["cudnn_deterministic"]
        torch.backends.cudnn.benchmark = saved["cudnn_benchmark"]
        torch.backends.cuda.matmul.allow_tf32 = saved["matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = saved["cudnn_tf32"]
        if saved["cublas"] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved["cublas"]
        torch.set_rng_state(saved["torch_rng"])
        np.random.set_state(saved["np_rng"])
        random.setstate(saved["py_rng"])
        tdet._KEYS.seed, tdet._KEYS.count = saved["keys"]


def flags():
    return dict(deterministic=torch.are_deterministic_algorithms_enabled(),
                warn_only=torch.is_deterministic_algorithms_warn_only_enabled(),
                cudnn_deterministic=torch.backends.cudnn.deterministic,
                cudnn_benchmark=torch.backends.cudnn.benchmark,
                matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_tf32=torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("warn_only", [True, False])
def test_flags_follow_deterministic(deterministic, warn_only, monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    cfg = tdet.configure_determinism(3, deterministic, warn_only=warn_only)
    assert cfg == tdet.DeterminismConfig(seed=3, deterministic=deterministic,
                                         warn_only=warn_only,
                                         cudnn_benchmark=not deterministic,
                                         allow_tf32=not deterministic)
    assert flags() == dict(deterministic=deterministic,
                           warn_only=warn_only,
                           cudnn_deterministic=deterministic,
                           cudnn_benchmark=not deterministic,
                           matmul_tf32=not deterministic, cudnn_tf32=not deterministic)
    want_cublas = tdet.CUBLAS_WORKSPACE if deterministic else None
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == want_cublas


def test_an_existing_cublas_workspace_setting_is_kept(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    tdet.configure_determinism(0, True)
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


@pytest.mark.parametrize("benchmark", [True, False])
@pytest.mark.parametrize("tf32", [True, False])
def test_explicit_switches_override_the_default(benchmark, tf32):
    cfg = tdet.configure_determinism(0, True, cudnn_benchmark=benchmark, allow_tf32=tf32)
    assert cfg.cudnn_benchmark is benchmark and cfg.allow_tf32 is tf32
    assert torch.backends.cudnn.benchmark is benchmark
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32


def test_deterministic_mode_fills_uninitialized_memory():
    """Deterministic mode fills ``torch.empty`` with NaN, which is how a
    kernel wrapper that reads lanes its kernel never wrote shows up."""
    tdet.configure_determinism(0, True)
    assert torch.isnan(torch.empty(8)).all()
    tdet.configure_determinism(0, False)
    assert not torch.are_deterministic_algorithms_enabled()


def _parse(argv):
    parser = tdet.add_determinism_args(argparse.ArgumentParser())
    jparser = jdet.add_determinism_args(argparse.ArgumentParser())
    args = parser.parse_args(argv)
    assert vars(args) == vars(jparser.parse_args(argv))
    return args


@pytest.mark.parametrize("argv,want", [
    ([], dict(seed=0, deterministic=False, warn_only=False, cudnn_benchmark=True,
              allow_tf32=True)),
    (["--deterministic"], dict(seed=0, deterministic=True, warn_only=False,
                               cudnn_benchmark=False, allow_tf32=False)),
    (["--deterministic", "--deterministic-warn-only", "--seed", "9",
      "--cudnn-benchmark", "on", "--allow-tf32", "off"],
     dict(seed=9, deterministic=True, warn_only=True, cudnn_benchmark=True,
          allow_tf32=False)),
    (["--cudnn-benchmark", "off", "--allow-tf32", "on"],
     dict(seed=0, deterministic=False, warn_only=False, cudnn_benchmark=False,
          allow_tf32=True)),
])
def test_from_args_resolves_the_tri_states(argv, want):
    cfg = tdet.configure_determinism_from_args(_parse(argv))
    assert cfg == tdet.DeterminismConfig(**want)
    assert flags()["cudnn_benchmark"] is want["cudnn_benchmark"]
    assert flags()["matmul_tf32"] is want["allow_tf32"]


def test_tri_state_choices_are_the_jax_packages():
    with pytest.raises(SystemExit):
        _parse(["--allow-tf32", "maybe"])


def test_seeding_and_rng_keys_are_reproducible():
    draws = []
    for _ in range(2):
        tdet.configure_determinism(1234, deterministic=False)
        root = torch.randn(3, generator=tdet.get_rng_key())
        keys = [torch.randn(4, generator=tdet.next_rng_key()) for _ in range(3)]
        draws.append((root, keys, torch.randn(2), np.random.rand(2), random.random()))
    (r1, k1, t1, n1, p1), (r2, k2, t2, n2, p2) = draws
    assert torch.equal(r1, r2) and torch.equal(t1, t2)
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    np.testing.assert_array_equal(n1, n2)
    assert p1 == p2
    # Each key is its own stream, and another seed gives other streams.
    assert not torch.equal(k1[0], k1[1]) and not torch.equal(k1[1], k1[2])
    tdet.configure_determinism(1235, deterministic=False)
    assert not torch.equal(torch.randn(4, generator=tdet.next_rng_key()), k1[0])


def test_key_rule_is_the_documented_one():
    tdet.configure_determinism(7, deterministic=False)
    tdet.next_rng_key()
    got = torch.randn(5, generator=tdet.next_rng_key())
    word = np.random.SeedSequence((7, 2)).generate_state(1, np.uint64)[0]
    want = torch.randn(5, generator=torch.Generator().manual_seed(int(word)))
    assert torch.equal(got, want)
    root = torch.randn(5, generator=tdet.get_rng_key())
    word0 = np.random.SeedSequence((7, 0)).generate_state(1, np.uint64)[0]
    assert torch.equal(root, torch.randn(5, generator=torch.Generator().manual_seed(int(word0))))
