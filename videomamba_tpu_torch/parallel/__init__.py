"""Training entry points (the sharded mesh is a later slice)."""

from videomamba_tpu_torch.parallel.train_step import (
    default_loss_fn,
    init_train_state,
    make_train_step,
)

__all__ = ["default_loss_fn", "init_train_state", "make_train_step"]
