"""The plain reference against the port's plain path at Tiny sizes (fp32,
both mixers, streaming with carried state and a masked training step), its
blocked scans against step-by-step loops, and the control (the reference
at fp8 products) against the bf16 program."""

import os

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark import compare, harness, program, weights

REF = harness.Bench(ROOT).reference("videomamba")
SMALL = {
    "base": {"layer": "Mamba", "d_state": 8, "d_conv": 4, "expand": 2, "dt_rank": 4},
    "base_m2": {"layer": "Mamba2", "d_state": 16, "d_conv": 4, "expand": 2, "headdim": 16,
                "ngroups": 1, "chunk_size": 8, "norm_epsilon": 1e-5},
}


def small_config(name, dtype="float32"):
    cfg = harness.Bench(ROOT).config(name)
    cfg.update(img_size=32, patch_size=16, embed_dim=32, depth=2, num_frames=4,
               ssm_cfg=SMALL[name], dtype=dtype)
    return cfg


def test_blocked_selective_scan_matches_the_step_loop():
    g = torch.Generator().manual_seed(0)
    b, L, d, n = 2, 37, 6, 4
    u, Bm, Cm = (torch.randn(s, generator=g) for s in ((b, L, d), (b, L, n), (b, L, n)))
    delta = torch.rand((b, L, d), generator=g) * 0.5
    A, h0 = -torch.rand((d, n), generator=g) * 3, torch.randn((b, d, n), generator=g)
    y, h = REF.selective_scan(u, delta, A, Bm, Cm, h0)
    state, ys = h0, []
    for t in range(L):
        state = torch.exp(delta[:, t, :, None] * A) * state + \
            (delta[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append((state * Cm[:, t, None, :]).sum(-1))
    assert torch.allclose(y, torch.stack(ys, 1), atol=1e-5) and torch.allclose(h, state, atol=1e-5)


def test_chunked_ssd_matches_the_step_loop():
    g = torch.Generator().manual_seed(1)
    b, L, h, p, gr, n = 2, 37, 4, 3, 2, 5
    x = torch.randn((b, L, h, p), generator=g)
    dt = torch.rand((b, L, h), generator=g) * 0.5
    A = -torch.rand(h, generator=g) * 3
    Bm, Cm = torch.randn((b, L, gr, n), generator=g), torch.randn((b, L, gr, n), generator=g)
    h0 = torch.randn((b, h, p, n), generator=g)
    y, last = REF.ssd(x, dt, A, Bm, Cm, h0, chunk=8)
    Bh, Ch = Bm.repeat_interleave(h // gr, 2), Cm.repeat_interleave(h // gr, 2)
    state, ys = h0, []
    for t in range(L):
        state = torch.exp(dt[:, t] * A)[..., None, None] * state + \
            (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    assert torch.allclose(y, torch.stack(ys, 1), atol=1e-5) and torch.allclose(last, state, atol=1e-5)


@pytest.mark.parametrize("name", ["base", "base_m2"])
def test_streaming_reference_matches_the_port(name):
    from videomamba_tpu_torch.runtime import StreamingSession

    cfg = small_config(name)
    w = weights.make(cfg, 11, "cpu")
    net = program.build_model(cfg, weights.make(cfg, 11, "cpu")).eval()
    session = StreamingSession(net, batch_size=2, dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    state = REF.zero_state(w, cfg, 2, "cpu")
    for k in range(3):
        x = torch.randn((2, 3, 4, 32, 32), generator=g)
        _, pooled = session.process(x)
        _, want, state = REF.forward(w, cfg, x, state, offset=4 * k)
        assert compare.rel_err(pooled, want) < 1e-5
    for (c, s), (wc, ws) in zip(session.state, state):
        assert compare.rel_err(c, wc) < 1e-5 and compare.rel_err(s, ws) < 1e-5


@pytest.mark.parametrize("name", ["base", "base_m2"])
def test_masked_training_reference_matches_the_port(name):
    from videomamba_tpu_torch.parallel.train_step import make_train_step

    cfg = small_config(name)
    w = weights.make(cfg, 12, "cpu")
    net = program.build_model(cfg, weights.make(cfg, 12, "cpu"))
    recipe = dict(lr=1e-3, weight_decay=0.05, betas=(0.9, 0.999), eps=1e-8)
    opt = torch.optim.AdamW(net.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_train_step(net, opt)
    rng = np.random.default_rng(5)
    g = torch.Generator().manual_seed(6)
    batches = []
    for _ in range(2):
        mask = np.zeros((4, 1 + 4 * 4), dtype=bool)
        for b in range(4):
            frame = np.zeros(4, dtype=bool)
            frame[rng.permutation(4)[:2]] = True
            mask[b, 1:] = np.tile(frame, 4)
        batches.append((torch.randn((4, 3, 4, 32, 32), generator=g), mask,
                        torch.randn((4, 8, 32), generator=g)))
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    losses, first = [], None
    for video, mask, target in batches:
        losses.append(float(step({"video": video, "mask": mask, "target": target})["loss"]))
        if first is None:
            first = {n: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"].double())) / 0.1
                     for n, p in net.named_parameters() if p in opt.state}
    change = {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
              for n, p in net.named_parameters() if p in opt.state}
    want_losses, want_first, want_change = REF.train(w, cfg, batches, recipe, rows=2)
    assert max(abs(a - b) / b for a, b in zip(losses, want_losses)) < 1e-5
    assert compare.worst_leaf_gap(first, want_first) < 1e-4
    assert compare.worst_leaf_gap(change, want_change, compare.moved_leaves(want_first)) < 1e-3


def _program_readings(root, cell, seed):
    return harness.run_cell(harness.Bench(root), cell, seed, 0.2, False, "cpu",
                            harness.process_age_s())["checks"]


def _control_readings(root, cell, seed):
    bench = harness.Bench(root)
    w = bench.cell(cell)
    cfg, mix = bench.config(w["config"]), bench.traffic(w["traffic"])
    run = harness.Run(cell, cfg, mix, seed, False, "cpu", bench.reference(cfg["reference"]))
    driver = bench.driver(mix["driver"]).Driver(run)
    driver.make_inputs()
    return driver.control()


CONTROL = [("base.stream64", "state_err"), ("base_m2.stream64", "state_err"),
           ("base.pretrain", "grad_err"), ("base_m2.pretrain", "grad_err")]


@pytest.mark.parametrize("cell,number", CONTROL + [("base.pretrain", "leaf_grad_err"),
                                                   ("base_m2.pretrain", "leaf_grad_err")])
def test_the_control_reads_far_above_the_program(tiny_root, cell, number):
    """At Tiny size, on three seeds, the fp8 control's reading of the number
    that separates them is at least twice the bf16 program's."""
    for seed in (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3):
        program_value = _program_readings(tiny_root, cell, seed)[number]["value"]
        control_value = _control_readings(tiny_root, cell, seed)[number]
        assert control_value >= 2 * program_value, (seed, program_value, control_value)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c, _ in CONTROL])
def test_the_control_fails_the_limits_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "benchmark/control.py", "--workload", cell,
                           "--seeds", "1", "2", "3"], cwd=ROOT, capture_output=True,
                          text=True, timeout=1800)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "harness.Bench(%r).reference('videomamba')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('videomamba_tpu_torch', 'videomamba_tpu', 'jax')]\n"
            "assert not bad, bad\n") % (ROOT, ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env=dict(os.environ, PYTHONPATH=""))
