"""videomamba_tpu_torch — the PyTorch / CUDA (Hopper) port of videomamba_tpu.

The JAX package ``videomamba_tpu`` is the reference this port is held
against. This package imports torch and never jax. The slice ported so far
is the fp32 and bf16 serving path of the Mamba-1 VideoMamba: full-clip
forward and chunked streaming with carried (conv_state, ssm_state), through
four hand-written Hopper kernels (``ops/kernels``): the selective scan, the
fused residual add + norm, the fused mixer core and the whole Block. bf16
serving weights come from ``utils.precision.cast_module_for_compute``.
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
