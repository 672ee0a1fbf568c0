"""Learning-rate schedules — port of videomamba_tpu/utils/scheduler.py.

Cosine decay with linear warmup and a ``min_lr_multi`` floor, as a
``LambdaLR`` multiplier on each parameter group's base learning rate.
"""

from __future__ import annotations

import math

from torch.optim import Optimizer
from torch.optim.lr_scheduler import LambdaLR


def cosine_multiplier(step: int, num_warmup_steps: int, num_training_steps: int,
                      num_cycles: float = 0.5, min_lr_multi: float = 0.0) -> float:
    """max(min_lr_multi, step / warmup) during warmup, then
    max(min_lr_multi, 0.5 (1 + cos(2 pi num_cycles progress)))
    (JAX scheduler.py:17-46)."""
    if step < num_warmup_steps:
        return max(min_lr_multi, step / max(1.0, float(num_warmup_steps)))
    progress = (step - num_warmup_steps) / max(1.0, float(num_training_steps - num_warmup_steps))
    return max(min_lr_multi, 0.5 * (1.0 + math.cos(math.pi * float(num_cycles) * 2.0 * progress)))


def get_cosine_schedule_with_warmup(optimizer: Optimizer, num_warmup_steps: int,
                                    num_training_steps: int, num_cycles: float = 0.5,
                                    min_lr_multi: float = 0.0) -> LambdaLR:
    return LambdaLR(optimizer, lambda step: cosine_multiplier(
        step, num_warmup_steps, num_training_steps, num_cycles, min_lr_multi))


def create_scheduler(args, optimizer: Optimizer):
    """JAX create_scheduler: ``args.sched == "cosine"``, else None."""
    if args.sched == "cosine":
        return get_cosine_schedule_with_warmup(
            optimizer, num_warmup_steps=args.num_warmup_steps,
            num_training_steps=args.num_training_steps, num_cycles=0.5,
            min_lr_multi=args.min_lr_multi,
        )
    return None
