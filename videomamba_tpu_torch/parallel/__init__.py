"""Distribution layer: the mesh and its sharding rules, the training step
(data, FSDP and tensor parallelism over ``torch.distributed``), and the
sequence-parallel scans (videomamba_tpu/parallel)."""

from videomamba_tpu_torch.parallel.mesh import (
    batch_rows,
    batch_sharding,
    make_hybrid_mesh,
    make_mesh,
    param_shardings,
    replicated,
    shard_params,
)
from videomamba_tpu_torch.parallel.sequence import (
    sequence_parallel_mixer,
    sequence_parallel_mixer_m2,
    sequence_parallel_scan,
    sequence_parallel_ssd,
)
from videomamba_tpu_torch.parallel.train_step import (
    default_loss_fn,
    full_state_dict,
    init_train_state,
    make_train_step,
)

__all__ = [
    "batch_rows",
    "batch_sharding",
    "default_loss_fn",
    "full_state_dict",
    "init_train_state",
    "make_hybrid_mesh",
    "make_mesh",
    "make_train_step",
    "param_shardings",
    "replicated",
    "sequence_parallel_mixer",
    "sequence_parallel_mixer_m2",
    "sequence_parallel_scan",
    "sequence_parallel_ssd",
    "shard_params",
]
