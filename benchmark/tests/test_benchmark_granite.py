"""The hybrid language model's cell (``granite_h_micro.doc128k``: driver
``lm_stream``, the plain reference ``granite_hybrid``, ``flops/hybrid.py``,
two readers) and ``base.clip64``, at small sizes on the CPU: found from
their files alone, the reference against the port, sound runs correct, a
broken timed path not correct, the counts against hand counts."""

import json
import os
import shutil

import pytest
import torch

from conftest import ROOT, TINY_SSM

from benchmark import harness, lm, program

SEED = 2 ** 33 + 777
LM_CELL, CLIP_CELL = "granite_h_micro.doc128k", "base.clip64"
SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=4,
             layer_types=["mamba", "attention", "mamba", "mamba"], intermediate_size=128,
             shared_intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
             mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=16,
             max_position_embeddings=96, dtype="float32")
FP32_LIMIT = 2e-5  # the port's fp32 bar of 1e-5 (ROADMAP), doubled for the sums' order


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """The benchmark with both cells at small sizes: the hybrid model at
    hidden 64, 4 layers (attention at 1), fp32, 2 streams of 3 chunks of 24
    tokens (no multiple of the SSD's chunk of 16); Base at Tiny widths, 3
    clips of 4 32 x 32 frames."""
    root = str(tmp_path_factory.mktemp("granite"))
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    files = os.path.join(root, "benchmark")

    def rewrite(kind, name, **over):
        path = os.path.join(files, kind, f"{name}.json")
        with open(path) as f:
            data = json.load(f)
        data.update(over)
        with open(path, "w") as f:
            json.dump(data, f)
        return data

    cfg = rewrite("configs", "granite_h_micro", **SMALL)
    rewrite("configs", "granite_h_micro", parameters=lm.count(cfg))
    rewrite("traffic", "doc128k", streams=2, chunk_tokens=24, document_chunks=3,
            traced_chunks=3)
    rewrite("limits", LM_CELL, logit_err=FP32_LIMIT, state_err=FP32_LIMIT, kv_err=FP32_LIMIT,
            attn_err=FP32_LIMIT)
    rewrite("configs", "base", img_size=32, patch_size=16, embed_dim=32, depth=2,
            num_frames=4, ssm_cfg=TINY_SSM["base"])
    rewrite("traffic", "clip64", streams=3, chunk_frames=4, height=32, width=32,
            checked_cycles=2, traced_chunks=3)
    rewrite("limits", CLIP_CELL, pool_err=0.03, state_err=0.03)
    return root


def run(root, cell, trace=False, seed=SEED):
    return harness.run_cell(harness.Bench(root), cell, seed, 0.3, trace, "cpu",
                            harness.process_age_s())


@pytest.mark.parametrize("cell", [LM_CELL, CLIP_CELL])
def test_the_new_cells_find_their_files_by_name(cell):
    bench = harness.Bench(ROOT)
    w = bench.cell(cell)
    config, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    assert hasattr(bench.driver(traffic["driver"]), "Driver")
    assert hasattr(bench.reference(config["reference"]), "forward")
    assert set(bench.limits(cell)["launches"]) <= set(program.launch_counts())
    for trace in (False, True):
        for m in bench.metrics(cell, trace):
            assert callable(bench.reader(m["name"]).read)


def test_the_configuration_holds_the_published_sizes():
    bench = harness.Bench(ROOT)
    cfg = bench.config("granite_h_micro")
    assert cfg["parameters"] == lm.count(cfg) == 3_191_396_096
    assert cfg["reduced"] == [] and cfg["num_hidden_layers"] == len(cfg["layer_types"]) == 40
    assert [i for i, k in enumerate(cfg["layer_types"]) if k == "attention"] == [5, 15, 25, 35]
    assert bench.limits(LM_CELL)["launches"] == {"ssd_mixer": 36, "attention": 4,
                                                 "fused_add_norm": 81}


def test_the_reference_holds_the_port_at_fp32(small_root):
    """The benchmark's weights loaded into the port, streamed in two chunks,
    against the reference over the whole sequence."""
    from videomamba_tpu_torch.runtime import StreamingSession

    bench = harness.Bench(small_root)
    cfg = bench.config("granite_h_micro")
    ref = bench.reference("granite_hybrid")
    w = lm.make(cfg, SEED, "cpu")
    model = lm.build_model(cfg, {k: v.clone() for k, v in w.items()}).eval()
    ids = torch.randint(0, cfg["vocab_size"], (2, 40), generator=torch.Generator().manual_seed(0))
    session = StreamingSession(model, batch_size=2, max_len=48)
    with torch.no_grad():
        got = [session.process(ids[:, :17]), session.process(ids[:, 17:])]
        want, states = ref.forward(w, cfg, ids, logits_at=[16, 39])
    for k in range(2):
        assert (got[k] - want[:, k]).abs().max() <= 1e-5 * want[:, k].abs().max()
    kv = session.state[1]
    assert torch.allclose(kv.key[:, :, :40], states[1][0], atol=1e-6)


@pytest.mark.parametrize("cell", [LM_CELL, CLIP_CELL])
def test_sound_small_runs_come_out_correct(small_root, cell):
    result = run(small_root, cell, trace=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in harness.Bench(small_root).metrics(cell, True)}
    assert set(result["metrics"]) <= names
    if cell == LM_CELL:
        # the CPU runs the plain attention: no kernel range to read
        assert {"step_mfu_pct.prefill", "chunk_p50_ms"} <= set(result["metrics"])
        assert "attention_roofline" not in result["metrics"]
    untraced = run(small_root, cell)
    assert "chunk_p95_ms" in untraced["metrics"] and "setup_s" in untraced["metrics"]


def _state_unchanged(monkeypatch):
    from videomamba_tpu_torch.runtime import StreamingSession

    orig = StreamingSession.process

    def process(self, chunk, *a, **k):
        state = self.state
        out = orig(self, chunk, *a, **k)
        self.state = state
        return out

    monkeypatch.setattr(StreamingSession, "process", process)


def _rows_swapped(monkeypatch):
    from videomamba_tpu_torch.runtime import StreamingSession

    orig = StreamingSession.process

    def process(self, chunk, *a, **k):
        return orig(self, chunk, *a, **k).flip(0)

    monkeypatch.setattr(StreamingSession, "process", process)


def _cache_not_carried(monkeypatch):
    from videomamba_tpu_torch.models.attention import Attention

    orig = Attention.forward

    def forward(self, x, state=None, return_state=False):
        out = orig(self, x)
        return (out, state._replace(length=state.length + x.shape[1])) if return_state else out

    monkeypatch.setattr(Attention, "forward", forward)


def _scale_of_one_over_sqrt_d(monkeypatch):
    from videomamba_tpu_torch.models import attention

    orig = attention.attention
    monkeypatch.setattr(attention, "attention",
                        lambda q, k, v, scale: orig(q, k, v, q.shape[-1] ** -0.5))


def _multiplier_dropped(monkeypatch):
    from benchmark import lm as bench_lm

    orig = bench_lm.build_model

    def build(config, weights):
        model = orig(config, weights)
        for layer in model.layers:
            layer.residual_multiplier = 1.0
        return model

    monkeypatch.setattr(bench_lm, "build_model", build)


FAULTS = [_rows_swapped, _cache_not_carried, _scale_of_one_over_sqrt_d, _multiplier_dropped]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_comes_out_not_correct(small_root, monkeypatch, fault):
    fault(monkeypatch)
    result = run(small_root, LM_CELL)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [_cache_not_carried, _scale_of_one_over_sqrt_d],
                         ids=["cache_not_carried", "scale_of_one_over_sqrt_d"])
def test_an_attention_fault_shows_in_the_attention_outputs(small_root, monkeypatch, fault):
    fault(monkeypatch)
    checks = run(small_root, LM_CELL)["checks"]
    assert checks["attn_err"]["value"] > checks["attn_err"]["limit"], checks


def test_the_driver_reduces_as_the_harness_compares():
    from benchmark import compare
    from benchmark.drivers import lm_stream

    gen = torch.Generator().manual_seed(7)
    want = torch.randn(3, 40, 8, generator=gen)
    nan = want.clone()
    nan[0, 0, 0] = float("nan")
    cases = [(want.bfloat16(), want), (want * 1.5, want), (want[:2], want), (nan, want),
             (torch.zeros(4), torch.zeros(4)), (torch.ones(4), torch.zeros(4))]
    for got, ref in cases:
        assert lm_stream.rel_err(got, ref) == compare.rel_err(got, ref)


def test_the_reference_attention_in_query_blocks_is_one_softmax():
    """Blocks of 3 queries (a budget of 3 rows of scores), against the
    whole causal softmax with each key head repeated over its queries."""
    bench = harness.Bench(ROOT)
    ref = bench.reference("granite_hybrid")
    cfg = dict(SMALL, attention_multiplier=0.125)
    gen = torch.Generator().manual_seed(5)
    d, hq, hk, L = cfg["hidden_size"], 4, 2, 11
    hd = d // hq
    w = {f"m.{n}_proj.weight": torch.randn(rows, d, generator=gen) * 0.3
         for n, rows in (("q", hq * hd), ("k", hk * hd), ("v", hk * hd))}
    w["m.o_proj.weight"] = torch.randn(d, hq * hd, generator=gen) * 0.1
    x = torch.randn(2, L, d, generator=gen)
    out, (k, v) = ref.attention_mixer(w, "m.", x, cfg, ref.Products(), budget=3 * 2 * hq * L)
    q = (x @ w["m.q_proj.weight"].t()).view(2, L, hq, hd).transpose(1, 2)
    kk, vv = (t.repeat_interleave(hq // hk, dim=1) for t in (k, v))
    scores = (q @ kk.transpose(-1, -2)) * 0.125
    scores = scores.masked_fill(torch.ones(L, L, dtype=torch.bool).triu(1), float("-inf"))
    y = (torch.softmax(scores, -1) @ vv).transpose(1, 2).reshape(2, L, hq * hd)
    torch.testing.assert_close(out, y @ w["m.o_proj.weight"].t(), rtol=1e-5, atol=1e-6)


def test_a_state_left_unchanged_stops_the_run(small_root, monkeypatch):
    """The session's offset runs on while its KV caches stay empty: the
    model refuses the next chunk (a run that raises prints no result)."""
    _state_unchanged(monkeypatch)
    with pytest.raises(ValueError, match="KV cache does not hold"):
        run(small_root, LM_CELL)


def test_the_control_fails_the_small_cell(small_root):
    bench = harness.Bench(small_root)
    cell = bench.cell(LM_CELL)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    r = harness.Run(LM_CELL, config, traffic, SEED, False, "cpu",
                    bench.reference(config["reference"]))
    driver = bench.driver(traffic["driver"]).Driver(r)
    driver.make_inputs()
    got = driver.control()
    limits = bench.limits(LM_CELL)
    assert all(got[k] > limits[k] for k in ("logit_err", "state_err", "kv_err", "attn_err")), got


def test_the_full_size_cell_refuses_the_cpu_at_once():
    bench = harness.Bench(ROOT)
    cell = bench.cell(LM_CELL)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    r = harness.Run(LM_CELL, config, traffic, SEED, False, "cpu", None)
    with pytest.raises(ValueError, match="on the card only"):
        bench.driver(traffic["driver"]).Driver(r).setup()


def test_hybrid_counts_match_hand_counts():
    from benchmark.flops import hybrid

    cfg = harness.Bench(ROOT).config("granite_h_micro")
    d, di, v = 2048, 4096, 100352
    mamba = d * (2 * di + 2 * 128 + 64) + di * d
    attention = d * 2048 * 2 + d * 512 * 2
    mlp = d * 16384 + 8192 * d
    assert hybrid.product_flops_per_token(cfg) == 2 * (36 * mamba + 4 * attention + 40 * mlp)
    assert hybrid.ssd_flops_per_token(cfg) == 36 * (256 * (128 + 4096) + 4 * 64 * 64 * 128)
    # a call of 3 tokens over 2 cached: queries see 3, 4 and 5 keys
    assert hybrid.attention_keys(3, 2) == 12
    assert hybrid.attention_flops(cfg, 2, 3, 2) == 4 * 2 * 32 * 64 * 12
    assert hybrid.attention_bytes(cfg, 2, 3, 2) == 2 * (2 * 2 * 32 * 3 * 64
                                                        + 2 * 2 * 8 * 5 * 64)
    last = hybrid.call_flops(cfg, 4, 8192, 15 * 8192)
    assert last == pytest.approx(4 * 8192 * (hybrid.product_flops_per_token(cfg)
                                             + hybrid.ssd_flops_per_token(cfg))
                                 + 4 * hybrid.attention_flops(cfg, 4, 8192, 15 * 8192)
                                 + 2 * 4 * v * d)
    assert 330e12 < last < 340e12  # 196 TFLOP of products and 136 of attention


def test_the_readers_read_a_window_and_a_trace():
    """step_mfu_pct.prefill over records, and attention_roofline over a
    trace whose kernel range holds a launch of known device time."""
    from benchmark import trace as tracing
    from benchmark.flops import hybrid, kernels

    bench = harness.Bench(ROOT)
    cfg = bench.config("granite_h_micro")
    recs = [dict(start=0.0, end=0.5, batch=4, chunk_tokens=8192, position=p)
            for p in (0, 8192)]
    window = harness.Window("stream", 0.0, recs, "process")
    ctx = harness.Context(LM_CELL, cfg, {}, window, 1.0, None)
    want = sum(hybrid.call_flops(cfg, 4, 8192, p) for p in (0, 8192)) / 0.5 / 989e12 * 100
    assert bench.reader("step_mfu_pct.prefill").read(ctx) == pytest.approx(want)
    events = [
        {"cat": "user_annotation", "name": "window", "ts": 0, "dur": 200000, "tid": 1},
        {"cat": "user_annotation", "name": "process", "ts": 10, "dur": 500, "tid": 1},
        {"cat": "user_annotation", "name": "vmt.kernel.attention", "ts": 20, "dur": 5, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 21, "dur": 1, "tid": 1,
         "args": {"correlation": 7}},
        {"cat": "kernel", "name": "flash_fwd", "ts": 30, "dur": 100000, "tid": 9,
         "args": {"correlation": 7}},
    ]
    ctx.trace = tracing.Trace(events, ("process",))
    ctx.traced = harness.Window("stream", 0.0, recs[1:], "process")
    args = (cfg, 4, 8192, 8192)
    least = kernels.bound(hybrid.attention_bytes(*args),
                          {"bf16": hybrid.attention_flops(*args)})["bound_ms"] / 1e3
    assert bench.reader("attention_roofline").read(ctx) == pytest.approx(100 * least / 0.1)
    assert bench.reader("attention_roofline").read(
        harness.Context(LM_CELL, cfg, {}, window, 1.0, None)) is None
