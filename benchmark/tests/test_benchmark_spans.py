"""The readers of the program's spans (``benchmark/spans.py`` and the six
metrics on it): their values on a synthetic trace, None on a trace without
the program's spans (an older program), and their readings in Tiny traced
runs on the CPU."""

from types import SimpleNamespace

import pytest

from conftest import ROOT

from benchmark import harness, spans
from benchmark.trace import Trace

SEED = 2 ** 33 + 777
MAIN, OTHER = 1, 2
TRAIN_READERS = ("host_syncs_per_step.train", "step_issue_ms", "program_idle_pct.train")
SERVE_READERS = ("host_syncs_per_call.serve", "process_issue_ms", "program_idle_pct.serve")


def _range(name, ts, end, tid=MAIN):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts, "tid": tid}


def _kernel(ts, end):
    return {"cat": "kernel", "name": "k", "ts": ts, "dur": end - ts, "tid": 7}


def events(outer):
    """A 1000 µs window: two ``outer`` spans (100-400, 500-800), a phase
    inside the first, four syncs (one on another thread) and four kernels;
    the card is idle over 120-200, 380-450, 560-650 and 900-1000."""
    return [
        _range("window", 0, 1000),
        _range(outer, 100, 400), _range("vmt.train.forward", 100, 250),
        _range("vmt.sync.a", 150, 200),
        _range(outer, 500, 800), _range("vmt.sync.a", 520, 530),
        _range("vmt.sync.b", 600, 640), _range("vmt.sync.a", 700, 710, tid=OTHER),
        _kernel(0, 120), _kernel(200, 380), _kernel(450, 560), _kernel(650, 900),
    ]


def ctx(kind, evs):
    return SimpleNamespace(trace=Trace(evs), window=SimpleNamespace(kind=kind))


def read(name, c):
    return harness.Bench(ROOT).reader(name).read(c)


@pytest.mark.parametrize("kind,names,outer", [("train", TRAIN_READERS, spans.STEP),
                                              ("stream", SERVE_READERS, spans.PROCESS)])
def test_readers_on_a_synthetic_trace(kind, names, outer):
    c = ctx(kind, events(outer))
    syncs, issue, idle = (read(n, c) for n in names)
    assert syncs == 2.0  # 1 and 3 (one on another thread)
    assert issue == pytest.approx(0.245)  # median of 300 - 50 and 300 - 60 µs
    assert idle == pytest.approx(19.0)  # 80 + 20 + 90 of 1000 µs
    other = "stream" if kind == "train" else "train"
    assert all(read(n, ctx(other, events(outer))) is None for n in names)


@pytest.mark.parametrize("names", [TRAIN_READERS, SERVE_READERS])
def test_readers_read_nothing_without_the_programs_spans(names):
    """The parent program's trace: the benchmark's own ranges and kernels only."""
    evs = [e for e in events("step") if not str(e["name"]).startswith("vmt.")]
    kind = "train" if names is TRAIN_READERS else "stream"
    assert all(read(n, ctx(kind, evs)) is None for n in names)
    assert all(read(n, SimpleNamespace(trace=None, window=SimpleNamespace(kind=kind))) is None
               for n in names)


def test_idle_by_span_puts_each_idle_stretch_to_the_innermost_span():
    got = spans.idle_by_span(Trace(events(spans.STEP)))
    want = {"vmt.train.forward": 30, "vmt.sync.a": 50, "vmt.sync.b": 40,
            spans.STEP: 20 + 40 + 10, "outside": 50 + 100}
    assert got == pytest.approx({k: v / 1e6 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(0.34e-3)  # every idle µs once


def test_program_idle_reads_nothing_without_device_records():
    evs = [e for e in events(spans.STEP) if e["cat"] != "kernel"]
    assert read("program_idle_pct.train", ctx("train", evs)) is None
    assert read("host_syncs_per_step.train", ctx("train", evs)) == 2.0


@pytest.mark.parametrize("cell,syncs", [("base.pretrain", 1.0), ("base_m2.pretrain", 1.0),
                                        ("base.stream64", 2 / 3), ("base_m2.stream64", 2 / 3)])
def test_tiny_traced_runs_read_the_programs_spans(tiny_root, cell, syncs):
    """A traced step's one sync is the visible-token gather's index; of three
    traced chunk calls from a reset (4-frame chunks, a 4-frame horizon) the
    last two resample the temporal positions. The idle shares are device
    metrics: nothing on the CPU."""
    result = harness.run_cell(harness.Bench(tiny_root), cell, SEED, 0.3, True, "cpu",
                              harness.process_age_s())
    assert result["correct"], result["checks"]
    m = result["metrics"]
    kind = "train" if cell.endswith("pretrain") else "serve"
    count = f"host_syncs_per_step.{kind}" if kind == "train" else f"host_syncs_per_call.{kind}"
    assert m[count]["value"] == pytest.approx(syncs)
    issue = "step_issue_ms" if kind == "train" else "process_issue_ms"
    assert m[issue]["value"] > 0
    assert f"program_idle_pct.{kind}" not in m
