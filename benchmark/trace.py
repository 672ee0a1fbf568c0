"""The traced window: a ``torch.profiler`` capture and its reduction.

In a ``--trace 1`` run the benchmark wraps each C entry point of the port's
kernel library (``_build.library()``) in a ``record_function`` range named
after it, so that the CUDA kernels a kernel wrapper launches are found by
correlation id: the launches inside that range, on its thread, and the
device records that share their ids. The driver's own ranges around the
calls into the program (its ``LABELS``, such as ``copy_in`` or ``step``)
label what the host was doing; an idle gap under none of them is the
harness's own loop ("harness").

Device time is the union of kernel, memcpy and memset intervals inside the
range named ``window`` (one stream: they do not overlap, but the union is
taken all the same).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "window"
BLAS_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")


def instrument(library) -> None:
    """Wrap every C entry of ``library`` (a ``ctypes.CDLL`` with argtypes
    set) in a ``record_function`` range of its own name, once."""
    if library is None or getattr(library, "_bench_ranges", False):
        return
    from videomamba_tpu_torch.ops.kernels import _build

    for name in list(_build.SIGNATURES) + list(_build.SIZE_QUERIES):
        fn = getattr(library, name)

        def ranged(*args, _fn=fn, _name=name):
            with torch.profiler.record_function(_name):
                return _fn(*args)

        setattr(library, name, ranged)
    library._bench_ranges = True


def label(name: str):
    """A benchmark range (a no-op cost without a profiler)."""
    return torch.profiler.record_function(name)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm_profiler(fn: Callable[[], object]) -> None:
    """One discarded profiled call, so that the traced window loses no
    kernel record to the profiler's start."""
    with torch.profiler.profile(activities=_activities()):
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def capture(fn: Callable[[], object], labels: Tuple[str, ...]) -> "Trace":
    """Profile ``fn`` inside the ``window`` range (the card synchronised at
    both ends) and reduce its Chrome trace, written under ``TMPDIR`` and
    removed; ``labels`` are the driver's range names that name idle gaps."""
    with torch.profiler.profile(activities=_activities()) as prof:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with label(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events, labels)


class Trace:
    """The traced window's events (times in microseconds, as the trace has
    them); ``labels``: the range names that name idle gaps."""

    def __init__(self, events: List[dict], labels: Tuple[str, ...] = ()):
        ranges = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
        windows = [e for e in ranges if e.get("name") == WINDOW]
        if not windows:
            raise ValueError("the trace has no window range")
        win = windows[0]
        self.t0, self.t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        self.main_tid = win.get("tid")
        self.labels = tuple(labels)
        self.ranges = ranges
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
                       and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.by_corr: Dict[int, List[dict]] = defaultdict(list)
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                self.by_corr[corr].append(e)
        self.launches: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "args" in e:
                corr = e["args"].get("correlation")
                if corr is not None:
                    self.launches[e.get("tid")].append((float(e["ts"]), corr))
        for v in self.launches.values():
            v.sort()
        self._port = None
        self._own: Dict[str, List[Tuple[float, float]]] = {}

    # ---------------------------------------------------------- window
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((max(float(e["ts"]), self.t0),
                        min(float(e["ts"]) + float(e["dur"]), self.t1)) for e in self.device)
        merged: List[List[float]] = []
        for lo, hi in spans:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged if hi > lo]

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self._intervals()) / 1e6

    def kernel_s(self, names: Optional[Callable[[dict], bool]] = None) -> float:
        """Summed device seconds of the window's kernels (those ``names``
        accepts, when given)."""
        return sum(float(e["dur"]) for e in self.device
                   if e.get("cat") == "kernel" and (names is None or names(e))) / 1e6

    # ------------------------------------------------------ attribution
    def _launched_in(self, rng: dict) -> List[int]:
        lo, hi = float(rng["ts"]), float(rng["ts"]) + float(rng["dur"])
        seq = self.launches.get(rng.get("tid"), [])
        i = bisect.bisect_left(seq, (lo, -1))
        out = []
        while i < len(seq) and seq[i][0] <= hi:
            out.append(seq[i][1])
            i += 1
        return out

    def entry_calls(self, entry: str) -> List[Tuple[float, float]]:
        """Each call of the port's C entry ``entry`` inside the window:
        (its host start in microseconds, the device seconds of what it
        launched)."""
        out = []
        for r in self.ranges:
            if r.get("name") != entry or not self.t0 <= float(r["ts"]) <= self.t1:
                continue
            dev = sum(float(e["dur"]) for c in self._launched_in(r) for e in self.by_corr.get(c, ()))
            out.append((float(r["ts"]), dev / 1e6))
        return out

    def port_correlations(self) -> set:
        """Correlation ids of everything the port's C entries launched."""
        if self._port is None:
            self._port = {c for r in self.ranges if str(r.get("name", "")).startswith("vmt_")
                          for c in self._launched_in(r)}
        return self._port

    def blas_kernel_s(self) -> float:
        """Device seconds of library product kernels (cuBLAS and the like),
        never those the port's own entries launched."""
        port = self.port_correlations()

        def blas(e):
            name = str(e.get("name", "")).lower()
            return (e.get("args", {}).get("correlation") not in port
                    and any(k in name for k in BLAS_NAMES))

        return self.kernel_s(blas)

    def range_index(self, name: str, ts: float) -> Optional[int]:
        """The order, among the main thread's ranges named ``name`` in the
        window, of the one that holds ``ts``."""
        if name not in self._own:
            self._own[name] = sorted(
                (float(r["ts"]), float(r["ts"]) + float(r["dur"])) for r in self.ranges
                if r.get("name") == name and r.get("tid") == self.main_tid
                and self.t0 <= float(r["ts"]) <= self.t1)
        for i, (lo, hi) in enumerate(self._own[name]):
            if lo <= ts <= hi:
                return i
        return None

    # -------------------------------------------------------- breakdown
    def _label_at(self, t: float) -> str:
        best, start = "harness", -1.0
        for r in self.ranges:
            if r.get("tid") != self.main_tid or r.get("name") not in self.labels:
                continue
            lo = float(r["ts"])
            if lo <= t <= lo + float(r["dur"]) and lo > start:
                best, start = r["name"], lo
        return best

    def breakdown(self, top: int = 10) -> dict:
        ops: Dict[str, float] = defaultdict(float)
        for e in self.device:
            ops[str(e.get("name", "?"))[:120]] += float(e["dur"]) / 1e6
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.t0
        for lo, hi in self._intervals() + [(self.t1, self.t1)]:
            if lo > prev:
                gaps.append((self._label_at((prev + lo) / 2), (lo - prev) / 1e6))
            prev = max(prev, hi)
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in device_ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}
