"""The harness: finds a cell's files by name, runs it, prints the result.

Everything that belongs to one configuration, traffic mix, driver, metric
or cell lives in a file of its own under the benchmark's directory, found
by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``  the model's sizes and dtype;
* ``traffic/<mix>.json``     the mix's parameters, with the ``driver`` that runs it;
* ``drivers/<driver>.py``    a ``Driver`` class: set-up, the measured window,
                             the traced window, and the comparison with the reference;
* ``reference/<name>.py``    the configuration's plain reference (``config["reference"]``);
* ``metrics/<metric>.py``    a ``read(ctx)`` that returns the metric or None;
* ``limits/<cell>.json``     the limit of each number the cell compares, and
                             under ``launches`` the launches a call or step
                             of each kernel wrapper on the cell's route.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

from benchmark import program

BLOCKED = ("jax", "jaxlib", "flax", "videomamba_tpu")


def process_age_s() -> float:
    """Seconds since this process started (10 ms ticks, from /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def blocked_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BLOCKED))


def _load(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    name = "benchmark_" + tag + "_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files under ``root/benchmark``."""

    def __init__(self, root):
        self.root = Path(root)
        self.files = self.root / "benchmark"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> dict:
        with open(self.files / kind / f"{name}.json") as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def driver(self, name: str):
        return _load(self.files / "drivers" / f"{name}.py", "driver")

    def reference(self, name: str):
        return _load(self.files / "reference" / f"{name}.py", "reference")

    def reader(self, metric: str):
        return _load(self.files / "metrics" / f"{metric}.py", "metric")

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass
class Window:
    """What a measured (or traced) window did: one record per call or step,
    each with its host ``start`` and ``end`` (perf_counter seconds) and its
    work (``frames``, ``clips``, ``batch``, ``block_tokens``, ``patch_tokens``).
    ``range`` names the driver's range around each call into the program,
    by which a traced kernel is put to its call."""

    kind: str
    t0: float
    records: List[dict]
    range: str

    @property
    def t_end(self) -> float:
        return self.records[-1]["end"] if self.records else self.t0

    @property
    def elapsed(self) -> float:
        return self.t_end - self.t0


class Phases:
    """Seconds of each part of a set-up, for the log (the card synchronised
    at each mark)."""

    def __init__(self):
        self.parts, self.last = [], time.perf_counter()

    def mark(self, name: str) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.last:.2f} s")
        self.last = now

    def log(self) -> None:
        log(f"set-up at {process_age_s():.2f} s of the process: " + ", ".join(self.parts))


@dataclasses.dataclass
class Run:
    """One run's inputs, as a driver sees them."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    trace: bool
    device: object
    reference: object


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    cell: str
    config: dict
    traffic: dict
    window: Window
    setup_s: float
    peak_bytes: Optional[int]
    trace: object = None          # trace.Trace of the traced window
    traced: Optional[Window] = None


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool,
             device, started: float) -> dict:
    """Run one cell; returns the result object (without printing it).
    ``started`` is the process's age when the run began (set-up counts
    from the process's start)."""
    import torch

    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(cell_name)
    run = Run(cell_name, config, traffic, seed, trace, device,
              bench.reference(config["reference"]))
    driver = bench.driver(traffic["driver"]).Driver(run)
    driver.setup()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s() - started
    before, calls_before = program.launch_counts(), driver.calls
    window = driver.measure(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    used = {k: v - before[k] for k, v in program.launch_counts().items() if v > before[k]}
    calls = driver.calls - calls_before
    traced = driver.traced() if trace else None
    attempted, failed = driver.outcome()
    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    log(f"launches in the window and the checked catch-up: {used}; {calls} calls or "
        f"steps, {attempted} in the window")
    log(f"reference check {time.perf_counter() - t_check:.1f} s")
    ctx = Context(cell_name, config, traffic, window, setup_s, peak,
                  trace=traced[0] if traced else None, traced=traced[1] if traced else None)
    metrics = {}
    for m in bench.metrics(cell_name, trace):
        value = bench.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    route = limits.pop("launches")
    missing = sorted(set(checks) ^ set(limits))
    if missing:
        raise KeyError(f"checks and limits/{cell_name}.json differ on {missing}")
    compared = {k: (v, limits[k], math.isfinite(v) and v <= limits[k]) for k, v in checks.items()}
    if program.counts_launches(device):
        compared.update(route_checks(route, used, calls))
    ok = all(passed for _, _, passed in compared.values())
    result = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info(device, peak)}
    if traced:
        result["device"].update(busy_s=traced[0].busy_s, window_s=traced[0].window_s)
        result["breakdown"] = traced[0].breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim, _) in compared.items()}
    return result


def route_checks(route: dict, used: dict, calls: int) -> dict:
    """Whether the cell's route ran: each wrapper's launches a call or step
    against the number ``route`` gives, exactly. A wrapper that launched
    nothing (its calls went down another path) reads 0."""
    return {f"launches.{k}": (used.get(k, 0) / calls if calls else 0.0, n,
                              calls > 0 and used.get(k, 0) == n * calls)
            for k, n in route.items()}


def log(line: str) -> None:
    print(f"benchmark: {line}", file=sys.stderr, flush=True)


def device_info(device, peak: Optional[int]) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell on this machine's card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root, started: float) -> int:
    args = parse(argv)
    import torch

    bench = Bench(root)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), started)
    found = blocked_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']:.6g} limit {v['limit']:.6g}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
