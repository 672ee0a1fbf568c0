"""The port's spans (``utils.profiling.annotate``): which a train step, a
streaming session and a forward emit, how they nest, and the host syncs
they count; ``annotate`` without a profiler; and, on the card, the sync
spans against torch's sync debug mode and the device trace's clock.

The ``cuda`` test skips without a card. On the GPU machine (this file
imports no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import collections
import json
import re
import traceback
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
from videomamba_tpu_torch.ops.resample import resample_linear_1d
from videomamba_tpu_torch.parallel.train_step import make_train_step
from videomamba_tpu_torch.runtime import StreamingSession
from videomamba_tpu_torch.utils import profiling

PACKAGE = Path(profiling.__file__).resolve().parents[1]
DEPTH = 2
GEOM = dict(img_size=16, patch_size=8, depth=DEPTH, embed_dim=64, num_frames=4,
            pool_type="avg")
SYNC = "vmt.sync."


def tiny_model(device="cpu"):
    return PretrainVideoMamba(**GEOM, device=device, generator=torch.Generator().manual_seed(0))


def tube_mask(batch=2, frames=4, per_frame=4, hidden=2):
    """True = hidden: the same ``hidden`` patches of every frame, CLS visible."""
    out = np.zeros((batch, 1 + frames * per_frame), dtype=bool)
    for b in range(batch):
        frame = np.zeros(per_frame, dtype=bool)
        frame[np.random.default_rng(b).permutation(per_frame)[:hidden]] = True
        out[b, 1:] = np.tile(frame, frames)
    return out


def train_batch(device="cpu"):
    mask = tube_mask()
    visible = int((~mask[0, 1:]).sum())
    g = torch.Generator().manual_seed(1)
    return {"video": torch.randn(2, 3, 4, 16, 16, generator=g).to(device), "mask": mask,
            "target": torch.randn(2, visible, 64, generator=g).to(device)}


def traced(tmp_path, fn):
    """The ``vmt.`` ranges of ``fn`` run under ``profiling.trace``, read back
    from its Chrome trace: (name, start, end, thread), by start."""
    with profiling.trace(str(tmp_path / "prof")) as prof:
        fn()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
           for e in events if e.get("cat") == "user_annotation"
           and str(e.get("name", "")).startswith("vmt.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_masked_train_step_emits_each_phase_once_nested(tmp_path):
    model = tiny_model()
    step = make_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3),
                           compute_dtype=torch.bfloat16)
    batch = train_batch()
    spans = traced(tmp_path, lambda: step(batch))
    counts = collections.Counter(s[0] for s in spans)
    phases = ["vmt.train.forward", "vmt.train.backward", "vmt.train.grad_norm",
              "vmt.train.optimizer"]
    model_phases = ["vmt.model.mask", "vmt.model.positions", "vmt.model.embed",
                    "vmt.model.blocks", "vmt.model.norm", "vmt.model.pool"]
    assert counts == collections.Counter(
        {"vmt.train.step": 1, "vmt.train.cast": DEPTH + 1, "vmt.sync.visible_index": 1,
         **{n: 1 for n in phases + model_phases}})
    (step_span,) = named(spans, "vmt.train.step")
    train = [named(spans, n)[0] for n in phases]
    assert all(inside(s, step_span) for s in train)
    assert all(a[2] <= b[1] for a, b in zip(train, train[1:]))  # in this order
    forward = train[0]
    assert all(inside(named(spans, n)[0], forward) for n in model_phases)
    assert inside(named(spans, "vmt.sync.visible_index")[0], named(spans, "vmt.model.embed")[0])
    casts = named(spans, "vmt.train.cast")
    blocks = named(spans, "vmt.model.blocks")[0]
    assert all(inside(c, forward) for c in casts)
    assert sum(inside(c, blocks) for c in casts) == DEPTH  # one a Block, one for the model


def test_a_streaming_session_counts_a_resample_sync_past_the_horizon(tmp_path):
    model = tiny_model().eval()
    session = StreamingSession(model, batch_size=2)
    g = torch.Generator().manual_seed(2)
    chunks = [torch.randn(2, 3, 4, 16, 16, generator=g) for _ in range(3)]
    spans = traced(tmp_path, lambda: [session.process(c) for c in chunks])
    calls = named(spans, "vmt.session.process")
    assert len(calls) == 3
    # The horizon is num_frames = 4 temporal tokens: chunk 0 lies inside it.
    per_call = [[s[0] for s in spans if s[0].startswith(SYNC) and inside(s, c)] for c in calls]
    assert per_call == [[], ["vmt.sync.temporal_resample"], ["vmt.sync.temporal_resample"]]
    assert len([s for s in spans if s[0].startswith(SYNC)]) == 2


def test_every_other_sync_site_emits_its_span_inside_its_phase(tmp_path):
    """A tensor mask, a spatial re-grid, frames past the horizon and the
    masked per-frame pool: each sync site once (the re-grid twice, one
    matrix per axis), inside the phase that holds it."""
    model = tiny_model().eval()
    x = torch.randn(2, 3, 8, 24, 24, generator=torch.Generator().manual_seed(3))
    mask = torch.from_numpy(tube_mask(frames=8, per_frame=9, hidden=4))

    def forward():
        with torch.no_grad():
            model(x, mask=mask, keep_temporal=True)
        resample_linear_1d(torch.randn(1, 4, 8), 6)

    spans = traced(tmp_path, forward)
    syncs = collections.Counter(s[0][len(SYNC):] for s in spans if s[0].startswith(SYNC))
    assert syncs == {"mask_to_host": 1, "resample_2d": 2, "temporal_resample": 1,
                     "visible_index": 1, "pool_frames": 1, "pool_counts": 1, "resample_1d": 1}
    home = {"resample_2d": "vmt.model.positions", "temporal_resample": "vmt.model.positions",
            "visible_index": "vmt.model.embed", "pool_frames": "vmt.model.pool",
            "pool_counts": "vmt.model.pool"}
    for site, phase in home.items():
        (outer,) = named(spans, phase)
        assert all(inside(s, outer) for s in named(spans, SYNC + site)), site


def test_annotate_makes_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.annotate("vmt.a") is profiling.annotate("vmt.b")
    model = tiny_model()
    step = make_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3),
                           compute_dtype=torch.bfloat16)
    step(train_batch())
    session = StreamingSession(model.eval(), batch_size=2)
    for _ in range(2):
        session.process(torch.randn(2, 3, 4, 16, 16))


SPANS = {"vmt.session.process", "vmt.train.step", "vmt.train.forward", "vmt.train.backward",
         "vmt.train.grad_norm", "vmt.train.optimizer", "vmt.train.cast",
         "vmt.model.mask", "vmt.model.positions", "vmt.model.embed", "vmt.model.blocks",
         "vmt.model.norm", "vmt.model.pool", "vmt.model.lm_head", "vmt.model.attention",
         "vmt.model.mlp", "vmt.kernel.attention"} | {
    SYNC + site for site in ("mask_to_host", "visible_index", "temporal_resample",
                             "pool_frames", "pool_counts", "resample_1d", "resample_2d")}


def test_span_names_are_documented_and_never_the_kernel_entries_prefix():
    """The package's ``annotate`` names are these, each starting with
    ``vmt.`` (never ``vmt_``, the C entries' ranges in the benchmark's
    trace) and listed in ``utils.profiling``'s docstring."""
    found = set()
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        found.update(re.findall(r'annotate\("([^"]+)"\)', text))
        found.update(SYNC + site for site in re.findall(r'^ .*_matrix\(.*, "([a-z0-9_]+)"\)$',
                                                        text, flags=re.M))
    assert found == SPANS
    doc = profiling.__doc__
    for name in found:
        assert name.startswith("vmt.") and not name.startswith("vmt_"), name
        assert f"``{name}``" in doc or f"``{name[len(SYNC):]}``" in doc, name


# ------------------------------------------------------------------ card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_work(dev):
    """One Tiny bf16 masked train step and three bf16 chunk calls (the last
    two past the horizon), as the benchmark's cells run them."""
    from videomamba_tpu_torch.utils.precision import cast_module_for_compute

    model = tiny_model(dev)
    step = make_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3),
                           compute_dtype=torch.bfloat16)
    batch = train_batch(dev)
    server = cast_module_for_compute(tiny_model(dev).eval(), torch.bfloat16)
    session = StreamingSession(server, batch_size=2)
    g = torch.Generator().manual_seed(2)
    chunks = [torch.randn(2, 3, 4, 16, 16, generator=g).to(dev) for _ in range(3)]

    def run():
        step(batch)
        for c in chunks:
            session.process(c)
        session.reset()

    return run


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.mark.cuda
def test_sync_spans_match_torch_sync_debug_and_share_the_device_clock(dev, tmp_path):
    """Every synchronising operation torch's sync debug mode reports from
    inside the port (the port's frames on the stack) in a masked step and
    three chunk calls has a ``vmt.sync.`` span (one a step, one a chunk
    call past the horizon); and the wait inside each span ends within 50
    µs after the last device operation launched before the span's end, so
    the spans and the device records share one clock."""
    run = _card_work(dev)
    run()  # warm-up: kernel library, allocator, optimizer state
    torch.cuda.synchronize()
    caught = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            frames = [Path(f.filename).resolve() for f in traceback.extract_stack()]
            caught.append((f"{filename}:{lineno}",
                           any(f.is_relative_to(PACKAGE) for f in frames)))

    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(previous)
    ours = [site for site, in_port in caught if in_port]
    print("sync debug warnings raised inside the port:", dict(collections.Counter(ours)),
          "outside it:", dict(collections.Counter(site for site, p in caught if not p)))

    with profiling.trace(str(tmp_path / "prof")) as prof:
        run()
        torch.cuda.synchronize()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SYNC)]
    print("sync spans:", dict(collections.Counter(e["name"] for e in spans)))
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [(launched[e["args"]["correlation"]], float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
              and e.get("args", {}).get("correlation") in launched]
    waits = [(e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaStreamSynchronize"]
    lags = []
    for s in spans:
        lo, end = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        done = max(d for launch, d in device if launch <= end)
        (wait_end,) = [hi for tid, a, hi in waits if tid == s.get("tid") and lo <= a and hi <= end]
        lags.append((wait_end - done, end - done))
    print("(the span's wait, the span) end less the last launched device operation's end, us:",
          lags)

    assert len(ours) == len(spans) == 3
    assert sorted(e["name"] for e in spans) == [SYNC + "temporal_resample"] * 2 + [
        SYNC + "visible_index"]
    # The wait inside the span (its one cudaStreamSynchronize, on the span's
    # thread and clock) returns 8-12 µs after the device finishes; the span
    # itself closes after the profiler's exits of the copy's nested ops,
    # 20-70 µs, and a preempted host thread up to 160 µs later (H100 host).
    assert all(0.0 <= wait <= 50.0 and wait <= span <= 1000.0 for wait, span in lags), lags
