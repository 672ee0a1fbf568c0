"""videomamba_tpu_torch — the PyTorch / CUDA (Hopper) port of videomamba_tpu.

The JAX package ``videomamba_tpu`` is the reference this port is held
against. This package imports torch and never jax. Ported so far: the fp32
and bf16 serving path of the Mamba-1 VideoMamba (full-clip forward, chunked
streaming with carried (conv_state, ssm_state), and token decode through
``DecodeSession`` or the mixers' ``InferenceCache``) and its training path
(``parallel.train_step``, ``utils.optimizer``, ``utils.scheduler``; fp32 or
bf16 compute over fp32 masters; stochastic depth and activation
checkpointing; the whole-block route with its backward), and the fp32 and
bf16 serving and training paths of the Mamba-2 (SSD) VideoMamba
(``videomamba_*_m2``: full clip, streaming, ``DecodeSession`` and
``parallel.train_step``), through the fifteen hand-written Hopper kernels
(``ops/kernels``) that replace the JAX package's Pallas kernels: the
selective scan and its backward, the fused residual add + norm and its
backward, the fused mixer core and its backward, the whole Block and its
backward, the whole-stack decode step (Mamba-1 and Mamba-2), the causal
conv, the SSD chunk scan with its backward, the SSD mixer core and its
backward, and the projected mixer with its backward (training runs those
backwards on the card under ``torch.autograd``). bf16 serving weights come
from ``utils.precision.cast_module_for_compute``. Entry points build on the CUDA
card unless given ``device="cpu"`` (``runtime.resolve_device``).

Beside those paths: VideoMAE-style masking (``forward(mask=...)``, mask
generators in ``data``), the ``BiMambaRefinerBlock``, checkpoint files
(``checkpoint.load_checkpoint``, ``save_torch_state_dict``, timm ``.npz``,
train state), ``determinism``, the native clip loader (``data.native``)
and distribution over ``torch.distributed`` (``utils.distributed``: NCCL
init and collectives; ``parallel``: the dp / fsdp / tp mesh, FSDP2 and
tensor-parallel training, sequence-parallel mixers). The root exports
every name of the JAX package's root.

The port also serves a model the JAX package lacks: ``HybridMambaLM``
(``granite_4_0_h_micro``, IBM Granite-4.0-H-Micro), a causal language
model of Mamba-2 and grouped-query attention layers with an MLP in every
Block, prefilled chunk by chunk through ``StreamingSession`` with a
``KVCache`` for each attention layer beside the Mamba-2 states.
"""

from videomamba_tpu_torch.determinism import (
    DeterminismConfig,
    add_determinism_args,
    configure_determinism,
    configure_determinism_from_args,
    get_rng_key,
    next_rng_key,
)
from videomamba_tpu_torch.models import (
    BiMambaRefinerBlock,
    Block,
    HybridMambaLM,
    InferenceCache,
    Mamba,
    Mamba2,
    PatchEmbed,
    PretrainVideoMamba,
    build_videomamba,
    create_block,
    granite_4_0_h_micro,
    videomamba_base,
    videomamba_base_m2,
    videomamba_middle,
    videomamba_middle_m2,
    videomamba_small,
    videomamba_small_m2,
    videomamba_tiny,
    videomamba_tiny_m2,
)
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d_update
from videomamba_tpu_torch.ops.selective_scan import selective_state_update
from videomamba_tpu_torch.runtime import DecodeSession, StreamingSession
from videomamba_tpu_torch.streaming import (
    STREAMING_CONTRACT_VERSION,
    ForwardReturnSemantics,
    LayerState,
    KVCache,
    KVStateShape,
    StateShape,
    StreamingState,
    allocate_state,
    expected_state_shapes,
    forward_return_semantics,
    model_forward_return_semantics,
    validate_state,
)

__all__ = [
    "BiMambaRefinerBlock",
    "Block",
    "DecodeSession",
    "DeterminismConfig",
    "ForwardReturnSemantics",
    "HybridMambaLM",
    "InferenceCache",
    "KVCache",
    "KVStateShape",
    "LayerState",
    "Mamba",
    "Mamba2",
    "PatchEmbed",
    "PretrainVideoMamba",
    "STREAMING_CONTRACT_VERSION",
    "StateShape",
    "StreamingSession",
    "StreamingState",
    "add_determinism_args",
    "allocate_state",
    "build_videomamba",
    "causal_conv1d_update",
    "configure_determinism",
    "configure_determinism_from_args",
    "create_block",
    "expected_state_shapes",
    "forward_return_semantics",
    "get_rng_key",
    "granite_4_0_h_micro",
    "model_forward_return_semantics",
    "next_rng_key",
    "selective_state_update",
    "validate_state",
    "videomamba_base",
    "videomamba_base_m2",
    "videomamba_middle",
    "videomamba_middle_m2",
    "videomamba_small",
    "videomamba_small_m2",
    "videomamba_tiny",
    "videomamba_tiny_m2",
]
