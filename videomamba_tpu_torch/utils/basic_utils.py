"""Training meters and small helpers: port of
videomamba_tpu/utils/basic_utils.py (the reference's utils/basic_utils.py).

``SmoothedValue`` and ``MetricLogger`` keep the torchvision / DeiT surface
the reference uses (constructor arguments, properties, the ``log_every``
progress line). Values are Python floats: a 0-d tensor is read with one
``.item()`` an update (a synchronisation with the card when it lives
there). Cross-process sums all-reduce over the default process group when
one is initialised; the progress line's memory column reads
``torch.cuda.max_memory_allocated`` and ``torch.cuda.mem_get_info`` of the
current card, and is left out where no card reports memory (the CPU).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import random
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from videomamba_tpu_torch.utils.distributed import is_dist_avail_and_initialized

logger = logging.getLogger(__name__)


def _as_float(value) -> float:
    if isinstance(value, torch.Tensor):
        if value.numel() != 1:
            raise TypeError(f"meter values must be scalar, got a tensor of shape "
                            f"{tuple(value.shape)}")
        return float(value.item())
    if isinstance(value, np.ndarray):
        return float(value)
    if not isinstance(value, (int, float, np.number)):
        raise TypeError(f"meter values must be scalar, got {type(value)!r}")
    return float(value)


class SmoothedValue:
    """A scalar series with window-smoothed and whole-run statistics.

    ``fmt`` is a ``str.format`` template over the stat names
    (median/avg/global_avg/max/value); ``str(meter)`` renders it.
    """

    def __init__(self, window: int = 20, fmt: Optional[str] = None):
        self._window: deque = deque(maxlen=window)
        self._run_total = 0.0
        self._run_count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n: int = 1) -> None:
        value = _as_float(value)
        self._window.append(value)
        self._run_count += n
        self._run_total += value * n

    def synchronize_between_processes(self) -> None:
        """Sum the run count and total over the default process group. The
        smoothing window stays local: it is for the progress line, not for
        metrics."""
        if not is_dist_avail_and_initialized():
            return
        import torch.distributed as dist

        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([self._run_count, self._run_total], dtype=torch.float64,
                         device=device)
        dist.all_reduce(t)
        self._run_count = int(t[0].item())
        self._run_total = float(t[1].item())

    # Window stats ---------------------------------------------------------
    @property
    def median(self) -> float:
        return float(np.median(np.asarray(self._window)))

    @property
    def avg(self) -> float:
        return float(np.mean(np.asarray(self._window)))

    @property
    def max(self) -> float:
        return max(self._window)

    @property
    def value(self) -> float:
        return self._window[-1]

    # Whole-run stats ------------------------------------------------------
    @property
    def count(self) -> int:
        return self._run_count

    @property
    def total(self) -> float:
        return self._run_total

    @property
    def global_avg(self) -> float:
        return self._run_total / self._run_count

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


def _device_memory_mb() -> Optional[tuple]:
    """(peak allocated MB, card total MB) of the current card, or None
    without one."""
    if not torch.cuda.is_available():
        return None
    mb = float(1024 * 1024)
    _, total = torch.cuda.mem_get_info()
    return torch.cuda.max_memory_allocated() / mb, total / mb


@dataclass
class _ProgressFormat:
    """Renders one ``log_every`` progress line; built once per loop."""

    header: str
    total: int
    delimiter: str
    with_memory: bool

    def line(self, i: int, eta_s: float, meters: str, it_t: str,
             data_t: str) -> str:
        width = len(str(self.total))
        parts = [
            self.header,
            f"[{i:{width}d}/{self.total}]",
            f"eta: {datetime.timedelta(seconds=int(eta_s))}",
            meters,
            f"time: {it_t}",
            f"data: {data_t}",
        ]
        if self.with_memory:
            used, limit = _device_memory_mb() or (0.0, 0.0)
            parts.append(f"max mem: {used:.0f} mem limit: {limit:.0f}")
        return self.delimiter.join(parts)


class MetricLogger:
    """Named-meter registry with a timed progress-logging iterator."""

    def __init__(self, delimiter: str = "\t"):
        self.meters: Dict[str, SmoothedValue] = {}
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for name, value in kwargs.items():
            self.meters.setdefault(name, SmoothedValue()).update(value)

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def __getattr__(self, attr: str):
        meters = self.__dict__.get("meters", {})
        if attr in meters:
            return meters[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'"
        )

    def _render(self, stat) -> str:
        return self.delimiter.join(
            f"{name}: {stat(m) if m.count else 'No data'}"
            for name, m in self.meters.items()
        )

    def __str__(self) -> str:
        return self._render(str)

    def global_avg(self) -> str:
        return self._render(lambda m: f"{m.global_avg:.4f}")

    def get_global_avg_dict(self, prefix: str = "") -> Dict[str, float]:
        """include a separator (e.g., `/`, or "_") at the end of `prefix`"""
        return {
            f"{prefix}{name}": m.global_avg if m.count else 0.0
            for name, m in self.meters.items()
        }

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def log_every(self, iterable, log_freq: int, header: Optional[str] = None):
        """Yield from ``iterable``, logging progress every ``log_freq``
        steps: position, ETA, all meters, iteration and data-wait time, and
        the card's memory when there is a card."""
        total = len(iterable)
        fmt = _ProgressFormat(
            header=header or "", total=total, delimiter=self.delimiter,
            with_memory=_device_memory_mb() is not None,
        )
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        started = prev = time.time()
        for i, item in enumerate(iterable):
            data_time.update(time.time() - prev)
            yield item
            iter_time.update(time.time() - prev)
            if i % log_freq == 0 or i == total - 1:
                eta = iter_time.global_avg * (total - i)
                logger.info(fmt.line(i, eta, str(self), str(iter_time),
                                     str(data_time)))
            prev = time.time()
        elapsed = time.time() - started
        logger.info(
            f"{fmt.header} Total time: "
            f"{datetime.timedelta(seconds=int(elapsed))} "
            f"({elapsed / max(1, total):.4f} s / it)"
        )


class AttrDict(dict):
    """Dict whose items are also attributes (config ergonomics)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self


def compute_acc(logits, label, reduction: str = "mean"):
    """Top-1 hits of ``logits`` (N, K) against ``label`` (N,): per sample
    (fp32 tensor) for ``reduction="none"``, their mean as a float for
    ``"mean"``."""
    hits = (torch.as_tensor(logits).argmax(dim=1) == torch.as_tensor(label)).float()
    if reduction == "none":
        return hits
    if reduction == "mean":
        return float(hits.mean())
    raise ValueError(f"Unknown reduction: {reduction}")


def compute_n_params(model_or_params, return_str: bool = True):
    """Parameter count of a module (``parameters()``) or of a dict of
    tensors; a ``DTensor`` counts its whole shape."""
    if isinstance(model_or_params, torch.nn.Module):
        tensors = list(model_or_params.parameters())
    else:
        tensors = list(model_or_params.values())
    total = sum(int(np.prod(tuple(t.shape))) for t in tensors)
    if not return_str:
        return total
    return (f"{total / 1e6:.1f}M" if total >= 1e6 else f"{total / 1e3:.1f}K")


def setup_seed(seed: int, deterministic: bool = False):
    """Seed NumPy, ``random`` and torch (the older twin of
    ``determinism.configure_determinism``, which it calls)."""
    from videomamba_tpu_torch.determinism import configure_determinism

    np.random.seed(seed)
    random.seed(seed)
    return configure_determinism(seed=seed, deterministic=deterministic)


def remove_files_if_exist(file_paths: Iterable[str]) -> None:
    for path in file_paths:
        if os.path.isfile(path):
            os.remove(path)


def save_json(data, filename, save_pretty: bool = False,
              sort_keys: bool = False) -> None:
    with open(filename, "w") as f:
        if save_pretty:
            f.write(json.dumps(data, indent=4, sort_keys=sort_keys))
        else:
            json.dump(data, f)


def load_json(filename):
    with open(filename, "r") as f:
        return json.load(f)


def flat_list_of_lists(list_of_lists):
    """flatten a list of lists [[1,2], [3,4]] to [1,2,3,4]"""
    return [item for sublist in list_of_lists for item in sublist]


def find_files_by_suffix_recursively(root: str, suffix: Union[str, List[str]]):
    """Recursive file search by suffix (glob-style, multi-suffix)."""
    suffixes = [suffix] if isinstance(suffix, str) else suffix
    return flat_list_of_lists(
        [list(Path(root).rglob(f"*{ext}")) for ext in suffixes]
    )


def match_key_and_shape(state_dict1, state_dict2) -> None:
    """Print key/shape diffs between two flat state dicts (debug helper)."""
    keys1, keys2 = set(state_dict1), set(state_dict2)
    print(f"keys1 - keys2: {keys1 - keys2}")
    print(f"keys2 - keys1: {keys2 - keys1}")
    mismatch = 0
    for key in keys1 & keys2:
        shape1 = tuple(state_dict1[key].shape)
        shape2 = tuple(state_dict2[key].shape)
        if shape1 != shape2:
            print(f"k={key}, state_dict1[k].shape={shape1}, "
                  f"state_dict2[k].shape={shape2}")
            mismatch += 1
    print(f"mismatch {mismatch}")


def merge_dicts(list_dicts):
    merged = dict(list_dicts[0])
    for extra in list_dicts[1:]:
        merged.update(extra)
    return merged
