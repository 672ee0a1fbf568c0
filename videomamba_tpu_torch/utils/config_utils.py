"""Run setup and ZeRO-config generation: port of
videomamba_tpu/utils/config_utils.py (the reference's utils/config_utils.py).

Two jobs, as in the JAX module:

1. Emit the ``deepspeed_config.json`` users' configs expect. The ZeRO preset
   blocks of :func:`setup_deepspeed_zero_config` and the block layout of
   :func:`build_deepspeed_config` are a schema contract: key names, order,
   values and the "fp16 or bf16 when using ZERO" check match the reference's
   file. DeepSpeed itself is not needed and never imported.
2. :func:`zero_stage_to_mesh_plan`: what a ZeRO stage means for the port's
   mesh (``parallel.make_mesh`` axes dp / fsdp / tp), where FSDP2 carries it.

``setup_main`` and its helpers start a run on the port's
``utils.distributed.init_distributed_mode``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict

from videomamba_tpu_torch.utils.config import Config
from videomamba_tpu_torch.utils.distributed import (
    get_world_size,
    init_distributed_mode,
    is_main_process,
)

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# DeepSpeed-JSON schema contract
# --------------------------------------------------------------------------

def setup_deepspeed_zero_config(stage: int) -> dict:
    """ZeRO preset block by stage (JAX config_utils.py:40-79)."""
    if stage == 1:
        return {"stage": 1, "reduce_bucket_size": 5e8}
    if stage == 2:
        return {
            "stage": 2,
            "contiguous_gradients": False,
            "overlap_comm": False,
            "reduce_scatter": True,
            "reduce_bucket_size": 5e8,
            "allgather_bucket_size": 5e8,
            "offload_optimizer": {"device": "cpu"},
        }
    if stage == 3:
        return {
            "stage": 3,
            "contiguous_gradients": True,
            "stage3_max_live_parameters": 1e9,
            "stage3_max_reuse_distance": 1e9,
            "stage3_prefetch_bucket_size": 1e7,
            "stage3_param_persistence_threshold": 1e5,
            "reduce_bucket_size": 1e7,
            "sub_group_size": 1e9,
            "offload_optimizer": {"device": "cpu"},
            "offload_param": {"device": "cpu"},
        }
    raise ValueError(f"Wrong stage for deepspeed {stage}")


_FP16_BLOCK = {
    "enabled": True,
    "auto_cast": False,
    "loss_scale": 0,
    "initial_scale_power": 16,
    "loss_scale_window": 1000,
    "hysteresis": 2,
    "consecutive_hysteresis": False,
    "min_loss_scale": 1,
}


def build_deepspeed_config(config) -> dict:
    """The DeepSpeed config dict (no filesystem access); blocks in the
    reference file's order."""
    opts = config.optimizer
    ds: dict = {
        "train_batch_size": config.batch_size * get_world_size(),
        "train_micro_batch_size_per_gpu": config.batch_size,
        "steps_per_print": 100,
        "optimizer": {
            "type": "Adam",
            "adam_w_mode": True,
            "params": {
                "lr": opts.lr,
                "weight_decay": opts.weight_decay,
                "bias_correction": True,
                "betas": [opts.opt_betas[0], opts.opt_betas[1]],
                "eps": 1e-8,
            },
        },
    }
    if config.deepspeed.stage != 0:
        ds["zero_optimization"] = setup_deepspeed_zero_config(config.deepspeed.stage)

    if bool(config.get("bf16", False)):
        ds["bf16"] = {"enabled": True}
    elif bool(config.get("fp16", False)):
        ds["fp16"] = dict(_FP16_BLOCK)
    elif config.deepspeed.stage != 0:
        raise AssertionError("You must use fp16 or bf16 when using ZERO!!!")

    if config.get("max_grad_norm", -1) > 0:
        ds["gradient_clipping"] = config.max_grad_norm
    return ds


def setup_deepspeed_config(config):
    """Set ``config.deepspeed_config`` on every process; the main process
    writes the JSON there."""
    config.deepspeed_config = os.path.join(config.output_dir, "deepspeed_config.json")
    logger.info("Write deepspeed config to %s", config.deepspeed_config)
    if is_main_process():
        os.makedirs(config.output_dir, exist_ok=True)
        with open(config.deepspeed_config, "w") as writer:
            writer.write(json.dumps(build_deepspeed_config(config), indent=2))
    return config


# --------------------------------------------------------------------------
# The port's execution mapping
# --------------------------------------------------------------------------

def zero_stage_to_mesh_plan(stage: int, n_devices: int) -> Dict[str, int]:
    """Axis sizes for ``parallel.make_mesh`` that carry a ZeRO stage on
    ``n_devices`` cards (one rank a card), the JAX plan:

    stage 0: pure data parallelism (every rank a whole copy; the gradients
        averaged).
    stage 1 and 2: FSDP2 shards parameters and optimizer state together
        (``parallel.init_train_state``: ``fully_shard`` gathers a Block's
        parameters before its forward and reduce-scatters its gradients), so
        both stages take a small fsdp axis (up to 8 cards, one node) and
        replicate over dp (HSDP) across the rest.
    stage 3: full parameter sharding, fsdp over every card.
    """
    if stage == 0:
        return {"dp": n_devices, "fsdp": 1, "tp": 1}
    if stage in (1, 2):
        fsdp = min(8, n_devices)
        return {"dp": max(1, n_devices // fsdp), "fsdp": fsdp, "tp": 1}
    if stage == 3:
        return {"dp": 1, "fsdp": n_devices, "tp": 1}
    raise ValueError(f"Wrong stage for deepspeed {stage}")


# --------------------------------------------------------------------------
# Run orchestration
# --------------------------------------------------------------------------

def setup_config():
    """The config file merged with the command-line overrides."""
    config = Config.get_config()
    if config.debug:
        config.wandb.enable = False
    return config


def setup_evaluate_config(config):
    """Evaluation defaults: wandb off, ``output_dir`` beside the weights."""
    assert config.evaluate
    config.wandb.enable = False
    if config.output_dir is None:
        config.output_dir = os.path.join(os.path.dirname(config.pretrained_path), "eval")
    return config


def setup_output_dir(output_dir, excludes=("code",)):
    """Create ``output_dir``; if it exists, warn about what is left in it
    (but ``excludes`` and SLURM logs) instead of clobbering it."""
    if not os.path.exists(output_dir):
        os.makedirs(output_dir, exist_ok=False)
        return
    leftovers = [
        entry for entry in set(os.listdir(output_dir)) - set(excludes)
        if "slurm" not in entry and ".out" not in entry
    ]
    logger.warning("remaining dirs or files: %s", leftovers)


def setup_main():
    """Config, process group, DeepSpeed JSON, output dir and logger: the
    shared entry of a training script."""
    from videomamba_tpu_torch.utils.logger import setup_logger

    config = setup_config()
    if getattr(config, "evaluate", False):
        config = setup_evaluate_config(config)
    init_distributed_mode(config)

    if getattr(getattr(config, "deepspeed", None), "enable", False):
        config = setup_deepspeed_config(config)

    if is_main_process():
        setup_output_dir(config.output_dir, excludes=("code",))
        setup_logger(output=config.output_dir, color=True, name="videomamba_tpu_torch")
        logger.info("config: %s", Config.pretty_text(config))
        Config.dump(config, os.path.join(config.output_dir, "config.json"))
    return config
