"""The PyTorch port imports without jax or the JAX package, and builds
nothing at import."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "videomamba_tpu_torch",
    "videomamba_tpu_torch.checkpoint",
    "videomamba_tpu_torch.data",
    "videomamba_tpu_torch.data.dataset",
    "videomamba_tpu_torch.data.masking",
    "videomamba_tpu_torch.data.native",
    "videomamba_tpu_torch.data.video",
    "videomamba_tpu_torch.determinism",
    "videomamba_tpu_torch.runtime",
    "videomamba_tpu_torch.streaming",
    "videomamba_tpu_torch.models",
    "videomamba_tpu_torch.models.block",
    "videomamba_tpu_torch.models.initializers",
    "videomamba_tpu_torch.models.mamba",
    "videomamba_tpu_torch.models.mamba2",
    "videomamba_tpu_torch.models.presets",
    "videomamba_tpu_torch.models.refiner",
    "videomamba_tpu_torch.models.videomamba",
    "videomamba_tpu_torch.ops",
    "videomamba_tpu_torch.ops.causal_conv1d",
    "videomamba_tpu_torch.ops.dispatch",
    "videomamba_tpu_torch.ops.norm",
    "videomamba_tpu_torch.ops.resample",
    "videomamba_tpu_torch.ops.selective_scan",
    "videomamba_tpu_torch.ops.ssd",
    "videomamba_tpu_torch.ops.kernels",
    "videomamba_tpu_torch.ops.kernels._build",
    "videomamba_tpu_torch.ops.kernels.block_bwd",
    "videomamba_tpu_torch.ops.kernels.block_fused",
    "videomamba_tpu_torch.ops.kernels.causal_conv",
    "videomamba_tpu_torch.ops.kernels.decode_step",
    "videomamba_tpu_torch.ops.kernels.fused_add_norm",
    "videomamba_tpu_torch.ops.kernels.mixer_bwd",
    "videomamba_tpu_torch.ops.kernels.mixer_fused",
    "videomamba_tpu_torch.ops.kernels.scan",
    "videomamba_tpu_torch.ops.kernels.ssd_core",
    "videomamba_tpu_torch.ops.kernels.ssd_mixer",
    "videomamba_tpu_torch.ops.kernels.ssd_mixer_bwd",
    "videomamba_tpu_torch.ops.kernels.ssd_pmixer",
    "videomamba_tpu_torch.parallel",
    "videomamba_tpu_torch.parallel.train_step",
    "videomamba_tpu_torch.utils",
    "videomamba_tpu_torch.utils.optimizer",
    "videomamba_tpu_torch.utils.precision",
    "videomamba_tpu_torch.utils.scheduler",
]


def test_port_imports_without_jax():
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in MODULES]
        + [
            "assert 'jax' not in sys.modules, 'jax was imported'",
            "assert not any(m == 'videomamba_tpu' or m.startswith('videomamba_tpu.')"
            " for m in sys.modules), 'the JAX package was imported'",
            "assert not any(m == 'triton' or m.startswith('triton.') for m in sys.modules)",
            "from videomamba_tpu_torch.ops.kernels import _build",
            "assert _build.library.cache_info().currsize == 0, 'built at import'",
            "from videomamba_tpu_torch.data import native",
            "assert native._load_lib.cache_info().currsize == 0, 'loader built at import'",
        ]
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300)
