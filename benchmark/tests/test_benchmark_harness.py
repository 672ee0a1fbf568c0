"""The harness: BENCHMARK.json against the contract, discovery by name, a
cell added from files alone, whole runs at Tiny size on the CPU (sound and
with the timed path broken underneath), and the refusal without a card."""

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 33 + 12345


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["benchmark"] and s["command"][1] == "benchmark/run.py"
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in s["command"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    cells = s["workloads"]
    assert 1 <= len(cells) <= 24 and 1 <= len(s["configs"]) <= 24
    used = {c["config"] for c in cells}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used and _line(c["source"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"] == []
    pairs = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert _line(w["why"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:  # setup_s, one more end-to-end metric and one per-layer metric each
        bench = harness.Bench(ROOT)
        assert {m["name"] for m in bench.metrics(w["name"], False)} > {"setup_s"}
        assert bench.metrics(w["name"], True)
    assert len(json.dumps(s)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    bench = harness.Bench(ROOT)
    w = bench.cell(cell)
    config, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    assert hasattr(bench.driver(traffic["driver"]), "Driver")
    assert hasattr(bench.reference(config["reference"]), "forward")
    limits = bench.limits(cell)
    assert set(limits) - {"launches"} in ({"pool_err", "state_err"},
                                          {"loss_err", "grad_err", "leaf_grad_err",
                                           "change_err"})
    assert limits["launches"] and all(n == 24 for n in limits["launches"].values())
    for trace in (False, True):
        for m in bench.metrics(cell, trace):
            assert callable(bench.reader(m["name"]).read)


def _digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


RENAMED_DRIVER = """
import importlib.util, os
from benchmark import trace as tracing

_spec = importlib.util.spec_from_file_location(
    "renamed_base", os.path.join(os.path.dirname(__file__), "stream.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)


class Driver(_base.Driver):
    RANGE = "serve_call"
    LABELS = _base.Driver.LABELS + ("serve_call",)

    def _call(self, video, k):
        with tracing.label("serve_call"):
            return super()._call(video, k)
"""


def test_a_cell_is_added_from_new_files_alone(tiny_root):
    """A new configuration, mix, driver, metric and cell: new files and new
    entries in BENCHMARK.json only; no file already there changes. The new
    driver names its own range, and the traced run puts its calls by it."""
    files = os.path.join(tiny_root, "benchmark")
    before = _digest(files)
    with open(os.path.join(files, "configs", "base.json")) as f:
        cfg = json.load(f)
    cfg.update(name="wide", embed_dim=48)
    with open(os.path.join(files, "configs", "wide.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(files, "traffic", "stream64.json")) as f:
        mix = json.load(f)
    mix.update(streams=3, video_chunks=2, checked_chunks=1, driver="stream_renamed")
    with open(os.path.join(files, "traffic", "stream_three.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(files, "drivers", "stream_renamed.py"), "w") as f:
        f.write(RENAMED_DRIVER)
    with open(os.path.join(files, "metrics", "calls_per_s.py"), "w") as f:
        f.write("def read(ctx):\n    w = ctx.window\n"
                "    return len(w.records) / w.elapsed if w.records else None\n")
    with open(os.path.join(files, "metrics", "traced_calls.py"), "w") as f:
        f.write("def read(ctx):\n    if ctx.trace is None:\n        return None\n"
                "    ts = [r['ts'] for r in ctx.trace.ranges if r.get('name') == 'process']\n"
                "    return sum(ctx.trace.range_index(ctx.traced.range, t) is not None"
                " for t in ts)\n")
    with open(os.path.join(files, "limits", "wide.stream_three.json"), "w") as f:
        json.dump({"pool_err": 0.05, "state_err": 0.05, "launches": {"block_fused": 24}}, f)
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["configs"].append({"name": "wide", "source": "https://example.org", "reduced": [],
                         "file": "benchmark/configs/wide.json", "why": "a test"})
    s["workloads"].append({"name": "wide.stream_three", "config": "wide",
                           "traffic": "stream_three", "chips": 1, "why": "a test"})
    s["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["wide.stream_three"]})
    s["per_layer"].append({"name": "traced_calls", "unit": "calls", "better": "higher",
                           "source": "program_span", "layer": "entry: a test",
                           "moves": "calls_per_s", "workloads": ["wide.stream_three"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    try:
        bench = harness.Bench(tiny_root)
        result = harness.run_cell(bench, "wide.stream_three", SEED, 0.3, False, "cpu",
                                  harness.process_age_s())
        after = _digest(files)
        assert {k: v for k, v in after.items() if k in before} == before
        assert set(result["metrics"]) == {"calls_per_s", "setup_s"}
        assert result["correct"] and result["attempted"] > 0
        traced = harness.run_cell(bench, "wide.stream_three", SEED, 0.3, True, "cpu",
                                  harness.process_age_s())
        # every traced call's "process" range lies inside the driver's own range
        assert traced["correct"]
        assert traced["metrics"]["traced_calls"]["value"] == mix["traced_chunks"]
    finally:
        s["configs"].pop(), s["workloads"].pop(), s["end_to_end"].pop(), s["per_layer"].pop()
        with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
            json.dump(s, f)


def _run(root, cell, trace=False, seed=SEED):
    return harness.run_cell(harness.Bench(root), cell, seed, 0.3, trace, "cpu",
                            harness.process_age_s())


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_sound_tiny_runs_come_out_correct(tiny_root, cell):
    result = _run(tiny_root, cell, trace=True)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in harness.Bench(tiny_root).metrics(cell, True)}
    assert set(result["metrics"]) <= names
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _stream_state_unchanged(monkeypatch):
    from videomamba_tpu_torch.runtime import StreamingSession

    orig = StreamingSession.process

    def process(self, chunk, *a, **k):
        state = self.state
        out = orig(self, chunk, *a, **k)
        self.state = state
        return out

    monkeypatch.setattr(StreamingSession, "process", process)


def _stream_answer_altered(monkeypatch):
    from videomamba_tpu_torch.runtime import StreamingSession

    orig = StreamingSession.process

    def process(self, chunk, *a, **k):
        x_vis, x_pool = orig(self, chunk, *a, **k)
        x_pool = x_pool.clone()
        x_pool[-1, 0, 0] += 0.5
        return x_vis, x_pool

    monkeypatch.setattr(StreamingSession, "process", process)


def _train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)


def _train_half_batch(monkeypatch):
    from videomamba_tpu_torch.parallel import train_step

    def loss_fn(model, batch, generator=None):
        out = model(batch["video"], mask=batch.get("mask"), generator=generator)
        half = out[0].shape[0] // 2
        loss = (out[0][:half].float() - batch["target"][:half].float()).square().mean()
        return loss, {"loss": loss.detach()}

    monkeypatch.setattr(train_step, "default_loss_fn", loss_fn)


def _train_loss_altered(monkeypatch):
    from videomamba_tpu_torch.parallel import train_step

    orig = train_step.default_loss_fn

    def loss_fn(model, batch, generator=None):
        loss, metrics = orig(model, batch, generator)
        return loss, {"loss": metrics["loss"] * 1.05}

    monkeypatch.setattr(train_step, "default_loss_fn", loss_fn)


def _gradient_zeroed(monkeypatch, leaf):
    from benchmark import program

    orig = program.build_model

    def build(*a, **k):
        model = orig(*a, **k)
        for name, p in model.named_parameters():
            if name.endswith("mixer." + leaf):
                p.register_hook(torch.zeros_like)
        return model

    monkeypatch.setattr(program, "build_model", build)


def _train_a_log_gradient_zeroed(monkeypatch):
    _gradient_zeroed(monkeypatch, "A_log")


def _train_d_gradient_zeroed(monkeypatch):
    _gradient_zeroed(monkeypatch, "D")


FAULTS = [(cell, fault) for cell in ("base.stream64", "base_m2.stream64")
          for fault in (_stream_state_unchanged, _stream_answer_altered)] + \
         [(cell, fault) for cell in ("base.pretrain", "base_m2.pretrain")
          for fault in (_train_state_unchanged, _train_half_batch, _train_loss_altered,
                        _train_d_gradient_zeroed)] + \
         [("base_m2.pretrain", _train_a_log_gradient_zeroed)]  # K13's own dA_log


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_comes_out_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = _run(tiny_root, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("per_call,correct", [(24, True), (0, False), (48, False)],
                         ids=["on_route", "plain_route", "double"])
def test_a_cell_off_its_route_comes_out_not_correct(tiny_root, monkeypatch, per_call, correct):
    """Where the kernels count their launches (on the card), a call that
    leaves the cell's route, or launches the kernel twice over, makes the
    run not correct; launches counted here by a stand-in counter."""
    from videomamba_tpu_torch.runtime import StreamingSession

    from benchmark import program

    counts = {"block_fused": 0}
    orig = StreamingSession.process

    def process(self, *a, **k):
        counts["block_fused"] += per_call
        return orig(self, *a, **k)

    monkeypatch.setattr(StreamingSession, "process", process)
    monkeypatch.setattr(program, "launch_counts", lambda: dict(counts))
    monkeypatch.setattr(program, "counts_launches", lambda device: True)
    result = _run(tiny_root, "base.stream64")
    assert result["correct"] == correct, result["checks"]
    assert result["checks"]["launches.block_fused"] == {"value": float(per_call), "limit": 24}


def test_comparisons_name_the_worst_leaf_and_answer():
    from benchmark import compare

    assert compare.rel_err(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 4.0])) == 0.5
    assert compare.rel_err(torch.tensor([float("nan")]), torch.tensor([1.0])) == float("inf")
    want = {"a": 1.0, "b": 2.0, "c": 3.0}
    assert compare.worst_leaf_gap({"a": 1.0, "b": 2.0, "c": 3.0}, want) == 0.0
    assert compare.worst_leaf_gap({"a": 0.5, "b": 2.0, "c": 3.0}, want) == 0.25  # median 2
    assert compare.worst_leaf_gap({"b": 2.0, "c": 3.0}, want) == 0.5
    assert compare.worst_leaf_gap({"a": 0.5, "b": 2.0, "c": 3.0}, want, own=True) == 0.5
    assert compare.worst_leaf_gap({"a": 0.0, "b": 2.0, "c": 3.0}, want, own=True) == 1.0
    assert compare.moved_leaves({"a": 1e-9, "b": 1.0, "c": 2.0}) == {"b", "c"}


def test_seeds_wider_than_32_bits_give_distinct_fixed_draws():
    from benchmark import seeds

    a = seeds.derive(2 ** 31 + 7, "weights")
    assert a == seeds.derive(2 ** 31 + 7, "weights") != seeds.derive(2 ** 31 + 8, "weights")
    assert seeds.derive(2 ** 40, "mask", 3) != seeds.derive(2 ** 40, "mask", 4)
    x = seeds.numpy_rng(2 ** 35, "mask", 1).integers(1 << 30, size=4)
    assert np.array_equal(x, seeds.numpy_rng(2 ** 35, "mask", 1).integers(1 << 30, size=4))


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "base.stream64",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    alone = tmp_path / "alone"
    alone.mkdir()
    subprocess.run(["cp", "-r", os.path.join(ROOT, "benchmark"), os.path.join(ROOT, "BENCHMARK.json"),
                    str(alone)], check=True)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "base.stream64",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=alone,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "base.stream64",
                           "--seed", str(SEED), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
