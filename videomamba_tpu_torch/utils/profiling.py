"""Tracing and step timing: port of videomamba_tpu/utils/profiling.py.

* :func:`trace` — a ``torch.profiler`` capture (CPU and, where there is a
  card, CUDA activities) of the enclosed steps, written to ``log_dir`` as a
  Chrome trace (``chrome://tracing``, Perfetto) on exit.
* :class:`StepTimer` — host step timing that is honest under asynchronous
  launches: it synchronises the card before reading the clock when the
  step's outputs live there.
* :func:`device_memory_summary` — each visible card's memory counters in
  MB, under the JAX module's keys.
* :func:`annotate` — a named range in the trace, free without a profiler.

Tracing a serving session or a train step: run the calls under
:func:`trace`, ``with trace("prof"): session.process(chunk)``, and open
``prof.trace_path`` in Perfetto. The port marks its own phases with
:func:`annotate` ranges, on the same timeline as the card's kernels and
copies; each is a ``record_function`` range while a profiler records, and
one shared do-nothing context (under a microsecond) otherwise, so they stay
in the code at no cost. Names start with ``vmt.`` (never ``vmt_``, the prefix of
the kernel library's C entries):

* ``vmt.session.process``: one ``runtime.StreamingSession.process`` call;
* ``vmt.train.step``: one step of ``parallel.make_train_step``, holding
  ``vmt.train.forward`` (the loss function), ``vmt.train.backward``,
  ``vmt.train.grad_norm`` and ``vmt.train.optimizer`` (``optimizer.step``);
* ``vmt.train.cast``: one unit's cast of its parameters to the compute
  dtype (each Block and the model: depth + 1 a forward; a checkpointed
  recompute casts again, on autograd's thread);
* ``vmt.model.mask`` (the host mask's checks and visible positions),
  ``vmt.model.positions`` (spatial and temporal positions, with their
  resampling), ``vmt.model.embed`` (patch embedding, positions, CLS and
  the visible-token gather), ``vmt.model.blocks`` (the Blocks),
  ``vmt.model.norm`` (the final norm) and ``vmt.model.pool`` (the pooling
  head): ``PretrainVideoMamba``'s phases; ``HybridMambaLM`` has
  ``vmt.model.embed`` (the token embedding), ``vmt.model.blocks``,
  ``vmt.model.norm`` (the last position's final norm) and
  ``vmt.model.lm_head`` (the tied head);
* ``vmt.model.attention`` (one attention layer's mixer: its projections
  and the attention) and ``vmt.model.mlp`` (one Block's MLP), inside
  ``vmt.model.blocks``;
* ``vmt.kernel.attention``: one call of the attention kernel
  (``ops.kernels.attention``), which holds what that call launched;
* ``vmt.sync.<site>``: a statement that blocks the host until the card has
  run what was queued before it (a copy from pageable host memory, a copy
  to the host): ``mask_to_host``, ``visible_index``, ``temporal_resample``,
  ``pool_frames``, ``pool_counts``, ``resample_1d``, ``resample_2d``. Their
  count is the number of host syncs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed steps: ``with trace("prof") as prof: step()``.

    Yields the ``torch.profiler.profile`` (for ``key_averages()``); on exit
    writes ``log_dir/trace_<pid>_<n>.json``, whose path is then
    ``prof.trace_path``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = sum(1 for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_"))
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(prof.trace_path)


def _on_card(outputs) -> bool:
    """Whether any tensor in ``outputs`` (a tensor, or a dict, list or tuple
    of them, nested) lives on a CUDA card."""
    if isinstance(outputs, torch.Tensor):
        return outputs.device.type == "cuda"
    if isinstance(outputs, dict):
        return any(_on_card(v) for v in outputs.values())
    if isinstance(outputs, (list, tuple)):
        return any(_on_card(v) for v in outputs)
    return False


class StepTimer:
    """Wall-clock step timer that synchronises on outputs.

    Example:
        timer = StepTimer()
        for batch in data:
            out = step(batch)
            timer.tick(out)          # waits for the card, records dt
        print(timer.summary())
    """

    def __init__(self, window: int = 50):
        from videomamba_tpu_torch.utils.basic_utils import SmoothedValue

        self.meter = SmoothedValue(window=window, fmt="{avg:.4f}s")
        self._last = time.perf_counter()

    def tick(self, outputs=None) -> float:
        if outputs is not None and _on_card(outputs):
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.meter.update(dt)
        return dt

    def reset_clock(self) -> None:
        self._last = time.perf_counter()

    def summary(self) -> str:
        return (
            f"steps={self.meter.count} avg={self.meter.global_avg:.4f}s "
            f"p50={self.meter.median:.4f}s max={self.meter.max:.4f}s"
        )


def device_memory_summary() -> Dict[str, Dict[str, float]]:
    """Per-card memory in MB from ``torch.cuda.memory_stats`` and
    ``mem_get_info``: ``mb_in_use`` (allocated now), ``peak_mb_in_use``
    (the allocator's peak) and ``mb_limit`` (the card's total); an empty dict
    without a card."""
    out: Dict[str, Dict[str, float]] = {}
    if not torch.cuda.is_available():
        return out
    mb = 1024.0 * 1024.0
    for i in range(torch.cuda.device_count()):
        raw = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "mb_in_use": raw.get("allocated_bytes.all.current", 0) / mb,
            "peak_mb_in_use": raw.get("allocated_bytes.all.peak", 0) / mb,
            "mb_limit": total / mb,
        }
    return out


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named range in the profile: ``with annotate("vmt.model.blocks"):
    ...``. Without a profiler recording, the shared do-nothing context: no
    ``record_function`` is made."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
