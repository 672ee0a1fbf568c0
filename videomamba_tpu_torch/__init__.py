"""videomamba_tpu_torch — the PyTorch / CUDA (Hopper) port of videomamba_tpu.

The JAX package ``videomamba_tpu`` is the reference this port is held
against. This package imports torch and never jax. Ported so far: the fp32
and bf16 serving path of the Mamba-1 VideoMamba (full-clip forward and
chunked streaming with carried (conv_state, ssm_state)) and its training
path (``parallel.train_step``, ``utils.optimizer``, ``utils.scheduler``;
fp32 or bf16 compute over fp32 masters; stochastic depth and activation
checkpointing), through seven hand-written Hopper kernels (``ops/kernels``):
the selective scan and its backward, the fused residual add + norm and its
backward, the fused mixer core and its backward, and the whole Block (no
backward yet). bf16 serving weights come from
``utils.precision.cast_module_for_compute``. Entry points build on the CUDA
card unless given ``device="cpu"`` (``runtime.resolve_device``).
"""

from videomamba_tpu_torch.models import (
    Mamba,
    PretrainVideoMamba,
    build_videomamba,
    videomamba_base,
    videomamba_middle,
    videomamba_small,
    videomamba_tiny,
)
from videomamba_tpu_torch.runtime import StreamingSession
from videomamba_tpu_torch.streaming import (
    STREAMING_CONTRACT_VERSION,
    StateShape,
    allocate_state,
    expected_state_shapes,
    forward_return_semantics,
    validate_state,
)

__all__ = [
    "Mamba",
    "PretrainVideoMamba",
    "STREAMING_CONTRACT_VERSION",
    "StateShape",
    "StreamingSession",
    "allocate_state",
    "build_videomamba",
    "expected_state_shapes",
    "forward_return_semantics",
    "validate_state",
    "videomamba_base",
    "videomamba_middle",
    "videomamba_small",
    "videomamba_tiny",
]
