# Logger setup derived from MMF:
#   https://github.com/facebookresearch/mmf/blob/master/mmf/utils/logger.py
# Copyright (c) Facebook, Inc. and its affiliates.
"""Rank-aware logging and experiment trackers: port of
videomamba_tpu/utils/logger.py (the reference's utils/logger.py).

Colour console on the main process only, a log file per rank, warnings
captured, wandb and TensorBoard helpers. The optional packages (wandb,
termcolor, tensorboard through ``torch.utils.tensorboard``) are imported
only inside the function or class that needs them, and their absence
degrades: no colour without termcolor, :func:`setup_wandb` returns None and
:func:`log_dict_to_wandb` does nothing without wandb, and
:class:`TensorboardLogger` raises ImportError at construction without
tensorboard (importing it loads TensorFlow where that is installed, which
takes seconds, so nothing imports it at module level).
"""

from __future__ import annotations

import functools
import logging
import os
import sys
import time
from typing import Optional

from videomamba_tpu_torch.utils.distributed import get_rank, is_main_process

_DATEFMT = "%Y-%m-%dT%H:%M:%S"
_PLAIN_FMT = "%(asctime)s | %(levelname)s | %(name)s : %(message)s"


def _colored(text, color=None, attrs=None):
    try:
        from termcolor import colored

        return colored(text, color, attrs=attrs)
    except ImportError:
        return text


def _plain_formatter() -> logging.Formatter:
    return logging.Formatter(_PLAIN_FMT, datefmt=_DATEFMT)


class ColorfulFormatter(logging.Formatter):
    """Prefix WARNING/ERROR records with a colored severity tag."""

    _TAGS = {
        logging.WARNING: ("WARNING", ["blink"]),
        logging.ERROR: ("ERROR", ["blink", "underline"]),
        logging.CRITICAL: ("ERROR", ["blink", "underline"]),
    }

    def formatMessage(self, record):
        line = super().formatMessage(record)
        tag = self._TAGS.get(record.levelno)
        if tag is None:
            return line
        return _colored(tag[0], "red", attrs=tag[1]) + " " + line


def _console_handler(color: bool) -> logging.Handler:
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setLevel(logging.INFO)
    if color:
        handler.setFormatter(ColorfulFormatter(
            _colored("%(asctime)s | %(name)s: ", "green") + "%(message)s",
            datefmt=_DATEFMT,
        ))
    else:
        handler.setFormatter(_plain_formatter())
    return handler


@functools.lru_cache(maxsize=None)
def _cached_log_stream(filename):
    # Cache the opened file object so repeated setup_logger calls with the
    # same filename safely share one stream.
    return open(filename, "a")


def _file_handler(filename: str) -> logging.Handler:
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    handler = logging.StreamHandler(_cached_log_stream(filename))
    handler.setLevel(logging.INFO)
    handler.setFormatter(_plain_formatter())
    return handler


def _rank_log_filename(output: str, rank: int) -> str:
    """Resolve the per-rank log path: rank 0 owns ``train.log``, other
    ranks append ``.rank{N}``."""
    if output.endswith((".txt", ".log")):
        filename = output
    else:
        filename = os.path.join(output, "train.log")
    return filename if rank == 0 else f"{filename}.rank{rank}"


def setup_output_folder(save_dir: str = ".", folder_only: bool = False) -> str:
    """Output log path: save_dir/logs/train_<timestamp>.log."""
    log_folder = os.path.join(save_dir, "logs")
    os.makedirs(log_folder, exist_ok=True)
    if folder_only:
        return log_folder
    stamp = time.strftime("%Y_%m_%dT%H_%M_%S")
    return os.path.join(log_folder, f"train_{stamp}.log")


def setup_logger(
    output: Optional[str] = None,
    color: bool = True,
    name: str = "videomamba_tpu_torch",
    disable: bool = False,
    clear_handlers=True,
    *args,
    **kwargs,
):
    """Configure the package logger (JAX logger.py:107-148).

    Master logs to stdout (colored); every rank logs to its own file
    (``train.log`` on rank 0, ``train.log.rank{N}`` otherwise); Python
    warnings are captured into the same handlers.
    """
    if disable:
        return None

    logger = logging.getLogger(name)
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logging.captureWarnings(True)
    warnings_logger = logging.getLogger("py.warnings")

    rank = get_rank()
    handlers = []
    if rank == 0:
        handlers.append(_console_handler(color))

    filename = _rank_log_filename(output or setup_output_folder(), rank)
    handlers.append(_file_handler(filename))

    for handler in handlers:
        logger.addHandler(handler)
        warnings_logger.addHandler(handler)
    logger.info(f"Logging to: {filename}")

    if clear_handlers:
        for handler in logging.root.handlers[:]:
            logging.root.removeHandler(handler)
    logging.basicConfig(level=logging.INFO, handlers=handlers)
    return logger


def setup_very_basic_config(color=True):
    logging.basicConfig(level=logging.INFO, handlers=[_console_handler(color)])


def _wandb():
    """The wandb module, or None when it is not installed."""
    try:
        import wandb
    except ImportError:
        return None
    return wandb


def log_dict_to_wandb(log_dict, step, prefix=""):
    """include a separator `/` at the end of `prefix`; a tensor value is
    logged as its Python number. Does nothing without wandb."""
    wandb = _wandb() if is_main_process() else None
    if wandb is None:
        return
    wandb.log({f"{prefix}{k}": v.item() if hasattr(v, "item") else v
               for k, v in log_dict.items()}, step)


def setup_wandb(config):
    """A wandb run on the main process when ``config.wandb.enable``; None
    elsewhere, and None (with a warning) when wandb is not installed."""
    if not (config.wandb.enable and is_main_process()):
        return None
    wandb = _wandb()
    if wandb is None:
        logging.getLogger(__name__).warning("wandb is not installed; not logging to it")
        return None
    return wandb.init(
        config=config,
        project=config.wandb.project,
        entity=config.wandb.entity,
        name=os.path.basename(config.output_dir),
        reinit=True,
    )


class TensorboardLogger:
    """Main-process TensorBoard writer (JAX logger.py:178-222).

    Requires the ``tensorboard`` package (through
    ``torch.utils.tensorboard``, imported here and nowhere at module level);
    raises ImportError at construction when it is unavailable.
    """

    def __init__(self, log_folder="./logs", iteration=0):
        from torch.utils.tensorboard import SummaryWriter

        self.summary_writer = None
        self._is_master = is_main_process()
        self.log_folder = log_folder
        if self._is_master:
            stamp = time.strftime(_DATEFMT)
            self.summary_writer = SummaryWriter(
                os.path.join(log_folder, f"tensorboard_{stamp}")
            )

    def __del__(self):
        if getattr(self, "summary_writer", None) is not None:
            self.summary_writer.close()

    def _should_log_tensorboard(self):
        return self.summary_writer is not None and self._is_master

    def add_scalar(self, key, value, iteration):
        if self._should_log_tensorboard():
            self.summary_writer.add_scalar(key, value, iteration)

    def add_scalars(self, scalar_dict, iteration):
        if not self._should_log_tensorboard():
            return
        for key, val in scalar_dict.items():
            self.summary_writer.add_scalar(key, val, iteration)

    def add_histogram_for_model(self, model, iteration):
        if not self._should_log_tensorboard():
            return
        for name, param in model.named_parameters():
            t = param.detach()
            t = t.full_tensor() if hasattr(t, "full_tensor") else t
            self.summary_writer.add_histogram(name, t.float().cpu(), iteration)
