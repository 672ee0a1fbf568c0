"""Serving times of one checkout of the port, for same-card comparisons.

    python3 scripts/compare_m2_serving.py [--model m2|m2bwd|pmixer_bwd|m1|m1bwd|scan|decode|
                                                   norm|conv]
                                          [--root DIR]
                                          [--label NAME] [--out FILE] [--walk-blocks N]
                                          [--bwd-chunk N]

Imports ``videomamba_tpu_torch`` from DIR (default: the checkout holding
this script), builds its kernels and measures, on one CUDA card, with random
inputs and weights from fixed seeds.

``--model m2`` (the default), at VideoMamba-Base-m2 shapes (B = 1, L = 1569,
P = N = 64, chunk 128):

* K12 (``ssd_mixer``) and K14's forward (``ssd_pmixer``), fp32 and bf16: the
  mean CUDA-event time of one call over 50 back-to-back calls, taken 5
  times (median and range), and under ``torch.profiler`` each of their
  launches' device time a call; K14's launches also split, in the order they
  run, into in_proj (the first product tile launch), the span (K12's
  launches) and out_proj (the second), and torch's own ops (the dt columns);
* ``torch.matmul`` (TF32 off) at K14's two product shapes, fp32 and bf16,
  event ms and TFLOP/s: the yardstick for K14's product tiles;
* the full Base-m2 clip (1, 3, 8, 224, 224), fp32 and cast for bf16 serving,
  under ``torch.inference_mode``: the median host time of 20 synchronised
  calls, then the device kernel time, idle share and top kernels under the
  profiler, then the host time again (a profiler session can slow a
  process's later host-bound calls).

``--model m2bwd``, K13 (``ssd_mixer_bwd``) at VideoMamba-Base-m2 shapes, fp32
and bf16, B = 1 and 4, nonzero h0, conv state and every cotangent (the
gated rows' and h_last's), checkpoints from K12's training forward: event
times and each launch's device time a call, as above, the launches also
summed into the parts of the span (conv recompute, epilogue, C B^T tiles,
dh_in, reverse pass, k-side tiles, q-side tiles, group sum, dsilu, conv
backward, torch ops and memsets).

``--model pmixer_bwd``, K14's backward (``ssd_pmixer_bwd``) at
VideoMamba-Base-m2 shapes, fp32 and bf16, B = 1 and 4, nonzero h0, conv
state and every cotangent (the output's and h_last's), checkpoints from K14's
training forward: event times and each launch's device time a call, as
above, the launches also summed, in the order they run, into the parts of
the call (in_proj recompute, gate, dWout, dgated, K13's span, dhidden, dWin,
split-K sums, memsets, torch ops; each product averaged over the launches
the profiler saw) with each product's TFLOP/s; then
``torch.matmul`` at the five product shapes and layouts, fp32 (TF32 off)
and bf16, B = 1 and 4: the yardstick.

``--model m1``, at VideoMamba-Base shapes (B = 1, L = 1569, Di = 1536,
N = 16, R = 48; Small for K4 at fp32):

* K3 (``mixer_fused``) at fp32 and K4 (``block_fused``) at bf16 (Base) and
  fp32 (Small), nonzero h0 and conv state: event times and each launch's
  device time, as above;
* the Mamba-1 Base clip, fp32 and cast for bf16 serving, as above, and the
  first 4-frame chunk of a ``StreamingSession`` under the profiler (device
  ms, idle share, top kernels).

``--model m1bwd``, the Mamba-1 backward kernels at VideoMamba-Base shapes
(L = 1569, Di = 1536, N = 16, R = 48; Small for K7 at fp32), B = 1 and 4,
nonzero h0, conv state and every cotangent, checkpoints from the matching
forward kernel: K6 (``mixer_bwd``) at fp32 and bf16 and K7 (``block_bwd``)
at bf16 (Base) and fp32 (Small, and Base at B = 1): event times and each
launch's device time a call, as above, the launches also summed into the
parts of the span (reverse walk, product tiles, conv backward, ordered
sums, norm and recompute).

``--model scan``, the selective scan K1 (``selective_scan``, with
checkpoints, as the composite training route calls it) and its backward K5
(``selective_scan_bwd``, from those checkpoints, with every cotangent) at
VideoMamba-Base shapes (L = 1569, Di = 1536, N = 16, with D, the gate and
the delta bias), fp32 and bf16, B = 1 and 4: event times and each launch's
device time a call, as above, the launches also summed into the parts of
the walk (chunk states or cotangents, pass, output walk, ordered sums; a
walk over all of time on a checkout from before the split).

``--model decode``, token decode at VideoMamba-Base and Base-m2 widths
(depth 24, seeded weights), fp32 and cast for bf16 serving, at B = 1, 8 and
80: K9 (``decode_stack``) and K15 (``decode_stack_m2``) event ms a token
(100 back-to-back tokens, taken 3 times: median and range), each launch
kind's device time a token under the profiler (in, x_proj, state, out; a
one-launch stack reports its phases when its module offers
``phase_ms``), the host time to submit one token's launches (the call
returning, no synchronise), and a ``DecodeSession.step``'s synchronised host
ms and its profiled device ms and idle share; where the module has
``MMA_MIN_BATCH``, K9 bf16 at B = 4 to 80 with and without its tensor-core
products.

``--model norm``, the add-norm backward K8 (``fused_add_norm_bwd``, rms
prenorm with an fp32 residual unless named) at VideoMamba-Base widths: D =
768 at B = 1 and 4 (M = 1569, 6276) fp32, B = 1 with a bf16 x, B = 1
layer norm, and D = 3200 at M = 1569; then K2 (``fused_add_norm``) at
Base B = 1 fp32, K7 (``block_bwd``, whose last launch is K8's row pass)
bf16 and fp32 at B = 1 and 4, and K3 fp32, K4 bf16 and K6 fp32 at Base B
= 1 (kernels this change does not touch, as controls): event times and
each launch's device time a call, as above, and for K8 and K2 the byte
bound (each input read once, each output written once, at 3.35 TB/s) and
its share of the device time, back to back (inputs that fit partly stay in
the 50 MB L2) and with the L2 flushed before each call (a 256 MB read, not
counted). ``--model conv``, the causal conv K10
(``causal_conv``, width 4, SiLU and bias, nonzero window) at (B, 1569,
1536), B = 1 and 4, fp32 and bf16, the same way, then K10 without its SiLU
and with a zero window beside ``F.conv1d(groups=D)`` on the channels-first
copy, event ms of each.

``--walk-blocks N`` sets the least grid of the split forward walk (K1's,
K3's and K4's, ``ops/kernels/scan.py WALK_MIN_BLOCKS``) on a checkout that has
one, to compare chunk lengths. ``--bwd-chunk N`` fixes the chunk of the
split reverse walk (K5's, K6's and K7's, ``ops/kernels/scan.py walk_bwd_chunk``)
at N steps on a checkout that has one.

Only entry points that every version of the port since Mamba-2 serving has
(``DecodeSession`` and both decode wrappers for ``--model decode``)
(and, for ``--model m1``, since Mamba-1 bf16 serving) are used, so a
parent and a change can be compared: run the script once per
checkout, each in its own process, alternating (parent, change, change,
parent) in one call to the card. It prints the card's name and power limit
first and one JSON object of the numbers last, and writes that object to
``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

BASE_M2 = dict(batch=1, seqlen=1569, embed=768, nheads=24, hdim=64, ngroups=1, d_state=64,
               chunk=128, width=4)
BASE = dict(batch=1, seqlen=1569, embed=768, d_inner=1536, d_state=16, dt_rank=48, width=4)
SMALL = dict(BASE, embed=384, d_inner=768, dt_rank=24)


def event_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_ms(fn, repeats: int = 20) -> float:
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_by_name(fn, iters: int):
    """(wall ms, {kernel name: device ms}) a call under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    return wall, {name: ms / iters for name, ms in by_name.items()}


def profile(fn, iters: int, top: int):
    """(wall ms, device kernel ms, {kernel: ms}) a call under torch.profiler."""
    wall, by_name = device_by_name(fn, iters)
    kernels = {name[:80]: ms for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}
    return wall, sum(by_name.values()), kernels


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def cold_device_ms(fn, iters: int = 10) -> float:
    """Device ms of fn's own kernels a call with a cold L2: a 256 MB buffer
    is read (summed) before each call, its kernels left out of the sum, so
    fn's inputs come from device memory and the L2 holds only clean lines
    (a written buffer would leave dirty lines whose write-back fn would
    pay for). 0.0 when the profiler recorded none of fn's kernels."""
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    _, reads = device_by_name(lambda: flush.sum(), iters=2)

    def call():
        flush.sum()
        fn()

    _, by_name = device_by_name(call, iters)
    del flush
    return sum(ms for name, ms in by_name.items() if name not in reads)


def ssd_inputs(device, dtype, seed=13, cfg=None):
    """K12's and K14's keyword operands at Base-m2 shapes (or ``cfg``'s;
    nonzero h0 and conv window), activations and weights in ``dtype``."""
    c = cfg or BASE_M2
    g = torch.Generator().manual_seed(seed)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    b, L, e, h, p, gr, n, w = (c[k] for k in ("batch", "seqlen", "embed", "nheads", "hdim",
                                             "ngroups", "d_state", "width"))
    di, cd = h * p, h * p + 2 * gr * n
    common = dict(A=-torch.exp(rnd((h,), 0.5)), conv_weight=rnd((cd, w), 0.5).to(dtype),
                  conv_bias=rnd((cd,), 0.2).to(dtype), D=rnd((h,)),
                  dt_bias=torch.linspace(-6.9, -2.3, h).to(device).to(dtype),
                  initial_state=rnd((b, h, p, n), 0.3), conv_state=rnd((b, cd, w)),
                  norm_weight=1 + rnd((di,), 0.1), norm_eps=1e-5, chunk_size=c["chunk"],
                  nheads=h, hdim=p, ngroups=gr, d_state=n)
    mixer = dict(common, zxbcdt=rnd((b, L, di + cd + h)).to(dtype))
    pmixer = dict(common, hidden=rnd((b, L, e)).to(dtype),
                  in_proj_w=rnd((di + cd + h, e), e ** -0.5).to(dtype),
                  out_proj_w=rnd((e, di), di ** -0.5).to(dtype))
    return mixer, pmixer


def m1_inputs(cfg, device, seed=3):
    """K3's operands (fp32) and K4's (weights in the caller's dtype) at the
    shapes a Base (or Small) Block gives them: nonzero h0 and conv state."""
    g = torch.Generator().manual_seed(seed)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    b, L, e, di, n, r, w = (cfg[k] for k in ("batch", "seqlen", "embed", "d_inner", "d_state",
                                             "dt_rank", "width"))
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n).contiguous().to(device)
    common = dict(conv_w=rnd((di, w), 0.5), conv_b=rnd((di,), 0.5),
                  x_proj_w=rnd((r + 2 * n, di), di ** -0.5), dt_proj_w=rnd((di, r), r ** -0.5),
                  dt_bias=torch.linspace(-6.9, -2.3, di).to(device), A=a,
                  D=torch.ones(di, device=device), h0=rnd((b, di, n), 0.1),
                  conv_state=rnd((b, di, w)))
    xz = rnd((b, L, 2 * di))
    mixer = dict(common, x=xz[..., :di], z=xz[..., di:])
    block = dict(common, hidden=rnd((b, L, e)), residual=rnd((b, L, e)),
                 norm_w=1 + rnd((e,), 0.1), norm_b=None,
                 in_proj_w=rnd((2 * di, e), e ** -0.5), out_proj_w=rnd((e, di), di ** -0.5))
    return mixer, block


def time_kernel(result, label, name, fn, kw):
    """Event ms (median and range of 5) and each launch's device ms a call."""
    call = lambda: fn(**kw)  # noqa: E731
    reps = [event_ms(call) for _ in range(5)]
    _, dev, launches = profile(call, iters=10, top=24)
    result["kernels"][name] = {"ms": statistics.median(reps), "ms_min": min(reps),
                               "ms_max": max(reps), "device_ms": dev, "launches_ms": launches}
    print(f"{label} {name}: {statistics.median(reps):.4f} ms "
          f"({min(reps):.4f}-{max(reps):.4f}); device {dev:.4f} ms")
    for k, v in launches.items():
        print(f"    {v:.4f} ms  {k}")


def time_serving(result, label, tag, calls):
    """Host ms, then the profiler's wall, device ms, idle share and top
    kernels, then host ms again, of each (what, call)."""
    for what, call in calls:
        for _ in range(3):
            call()
        before = host_ms(call)
        wall, dev, top = profile(call, iters=5, top=10)
        after = host_ms(call)
        result["clip" if what == "clip" else what][tag] = {
            "host_ms": before, "profiled_wall_ms": wall, "device_ms": dev,
            "idle": (wall - dev) / wall, "host_ms_after_profiler": after,
            "top_kernels_ms": top}
        print(f"{label} {tag} {what}: host {before:.3f} ms; profiler wall {wall:.3f} "
              f"ms, device {dev:.3f} ms, idle {100 * (wall - dev) / wall:.1f} %; host "
              f"after the profiler {after:.3f} ms")
        for k, v in top.items():
            print(f"    {v:.4f} ms  {k}")


def launch_sequence(fn, iters: int = 10):
    """[(kernel name, device ms a call)] of one call's CUDA activities in the
    order they run, each position averaged over ``iters`` calls under the
    profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    n = len(evts) // iters
    assert n * iters == len(evts), "calls ran different launches"
    seq = [[evts[i].name, 0.0] for i in range(n)]
    for j, e in enumerate(evts):
        seq[j % n][1] += e.time_range.elapsed_us() / 1e3 / iters
    return seq


# K14's own product tile kernels (any version of the port): the first launch
# of one in a call is in_proj, the second out_proj.
PRODUCT_TILES = ("gemm_nt_kernel", "gemm_nt_bf16_kernel", "gemm_nt_wide_kernel",
                 "product_kernel")


def pmixer_split(seq) -> dict:
    """K14's launches as in_proj, span (K12's launches), out_proj and torch's
    own ops (the dt columns' product and the decay cumsum)."""
    parts, products = {}, 0
    for name, ms in seq:
        if any(t in name for t in PRODUCT_TILES):
            part = ("in_proj", "out_proj")[min(products, 1)]
            products += 1
        elif "ssd_" in name or "conv_silu" in name:
            part = "span"
        else:
            part = "torch ops"
        parts[part] = parts.get(part, 0.0) + ms
    return parts


def matmul_yardstick(result, label, device):
    """torch.matmul (TF32 off) at K14's two product shapes, B = 1: event ms
    (median of 5 x 50) and TFLOP/s."""
    c = BASE_M2
    rows = c["batch"] * c["seqlen"]
    di = c["nheads"] * c["hdim"]
    zx = 2 * di + 2 * c["ngroups"] * c["d_state"]
    g = torch.Generator().manual_seed(5)
    result["matmul"] = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for name, (m, k, n) in (("in_proj", (rows, c["embed"], zx)),
                                ("out_proj", (rows, di, c["embed"]))):
            a = torch.randn((m, k), generator=g).to(device).to(dtype)
            w = torch.randn((n, k), generator=g).to(device).to(dtype)
            ms = statistics.median(event_ms(lambda: torch.matmul(a, w.t())) for _ in range(5))
            tf = 2 * m * n * k / ms / 1e9
            result["matmul"][f"{name} {tag}"] = {"ms": ms, "tflops": tf, "mnk": [m, n, k]}
            print(f"{label} torch.matmul {name} {tag} ({m} x {k} by {k} x {n}): {ms:.4f} ms, "
                  f"{tf:.1f} TFLOP/s")


def measure_m2(result, label, device):
    from videomamba_tpu_torch.models.presets import videomamba_base_m2
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14
    from videomamba_tpu_torch.utils.precision import cast_module_for_compute

    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        mixer, pmixer = ssd_inputs(device, dtype)
        time_kernel(result, label, f"ssd_mixer {tag}", k12.ssd_mixer, mixer)
        name = f"ssd_pmixer {tag}"
        time_kernel(result, label, name, k14.ssd_pmixer, pmixer)
        seq = launch_sequence(lambda: k14.ssd_pmixer(**pmixer))
        entry = result["kernels"][name]
        entry["parts_ms"] = pmixer_split(seq)
        entry["sequence_ms"] = [[n[:60], ms] for n, ms in seq]
        print("    parts: " + ", ".join(f"{k} {v:.4f}" for k, v in entry["parts_ms"].items()))
        del mixer, pmixer
    matmul_yardstick(result, label, device)

    g = torch.Generator().manual_seed(0)
    m2 = videomamba_base_m2(pool_type="avg", device=device, generator=g).eval()
    clip = torch.randn((1, 3, 8, 224, 224), generator=torch.Generator().manual_seed(2)).to(device)
    for tag in ("fp32", "bf16"):
        model = m2 if tag == "fp32" else cast_module_for_compute(m2, torch.bfloat16)
        time_serving(result, f"{label} m2", tag, [("clip", lambda: model(clip))])


def measure_m1(result, label, device):
    from videomamba_tpu_torch.models.presets import videomamba_base
    from videomamba_tpu_torch.ops.kernels import block_fused as k4
    from videomamba_tpu_torch.ops.kernels import mixer_fused as k3
    from videomamba_tpu_torch.runtime import StreamingSession
    from videomamba_tpu_torch.utils.precision import cast_module_for_compute

    mixer, block = m1_inputs(BASE, device)
    time_kernel(result, label, "mixer_fused fp32", k3.mixer_fused, mixer)
    bf16 = {k: v.bfloat16() if k in ("hidden", "in_proj_w", "out_proj_w", "conv_w", "conv_b",
                                      "x_proj_w", "dt_proj_w") else v for k, v in block.items()}
    time_kernel(result, label, "block_fused bf16", k4.block_fused, bf16)
    del mixer, block, bf16
    _, small = m1_inputs(SMALL, device)
    time_kernel(result, label, "block_fused fp32 Small", k4.block_fused, small)
    del small

    g = torch.Generator().manual_seed(0)
    m1 = videomamba_base(pool_type="avg", device=device, generator=g).eval()
    clip = torch.randn((1, 3, 8, 224, 224), generator=torch.Generator().manual_seed(2)).to(device)
    result["first_chunk"] = {}
    for tag in ("fp32", "bf16"):
        model = m1 if tag == "fp32" else cast_module_for_compute(m1, torch.bfloat16)
        time_serving(result, f"{label} m1", tag, [
            ("clip", lambda: model(clip)),
            ("first_chunk",
             lambda: StreamingSession(model, batch_size=1).process(clip[:, :, :4]))])


# Parts of K13's span, by kernel-name fragment (first match wins).
K13_PARTS = (("conv_silu", "conv recompute"), ("epilogue_bwd", "epilogue"),
             ("ssd_cb", "C B^T tiles"), ("dhin", "dh_in"), ("state_pass", "reverse pass"),
             ("kside", "k-side tiles"), ("qside", "q-side tiles"),
             ("group_sum", "group sum"), ("dsilu", "dsilu"), ("conv_", "conv backward"))


def measure_m2bwd(result, label, device):
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13
    from videomamba_tpu_torch.ops.ssd import _prepare_dt

    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for bsz in (1, 4):
            cfg = dict(BASE_M2, batch=bsz)
            mixer, _ = ssd_inputs(device, dtype, cfg=cfg)
            h, p, gr, n = cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"]
            di, cd = h * p, h * p + 2 * gr * n
            zx = mixer["zxbcdt"]
            shape = dict(chunk_size=cfg["chunk"], nheads=h, hdim=p, ngroups=gr, d_state=n)
            core = dict(zx=zx, dt_p=_prepare_dt(zx[..., di + cd:], mixer["dt_bias"], True),
                        A=mixer["A"], conv_weight=mixer["conv_weight"],
                        conv_bias=mixer["conv_bias"], D=mixer["D"],
                        initial_state=mixer["initial_state"], conv_state=mixer["conv_state"],
                        norm_weight=mixer["norm_weight"], norm_eps=1e-5, **shape)
            *_, hins, yd = k12.ssd_mixer_core(**core, checkpoints=True)
            g = torch.Generator().manual_seed(29)
            kw = dict(core, hins=hins, yd=yd,
                      dout=torch.randn((bsz, cfg["seqlen"], di), generator=g).to(device)
                      .to(dtype),
                      dhlast=0.5 * torch.randn((bsz, h, p, n), generator=g).to(device))
            del kw["initial_state"]
            name = f"ssd_mixer_bwd {tag} B={bsz}"
            time_kernel(result, label, name, k13.ssd_mixer_bwd, kw)
            entry = result["kernels"][name]
            parts = {}
            for lname, ms in entry["launches_ms"].items():
                part = next((pt for frag, pt in K13_PARTS if frag in lname),
                            "torch ops and memsets")
                parts[part] = parts.get(part, 0.0) + ms
            entry["parts_ms"] = parts
            print("    parts: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
            del mixer, core, kw, hins, yd
            torch.cuda.empty_cache()


# K14's backward: its product launches (any version of the port) in the
# order they run, and the kernels that sum a product's contraction slices.
PMIXER_BWD_PRODUCTS = ("product_kernel", "gemm_nt_wide_kernel", "gemm_nt_bf16_kernel",
                       "gemm_nt_kernel", "gemm_tn_kernel", "gemm_nn_kernel")
PMIXER_BWD_ORDER = ("in_proj recompute", "dWout", "dgated", "dhidden", "dWin")
SPLIT_SUMS = ("sum_slices", "sum_splits")


def pmixer_bwd_shapes(cfg) -> dict:
    """(M, N, K) and layout of K14's backward products."""
    rows = cfg["batch"] * cfg["seqlen"]
    e, di = cfg["embed"], cfg["nheads"] * cfg["hdim"]
    zx = 2 * di + 2 * cfg["ngroups"] * cfg["d_state"]
    return {"in_proj recompute": ((rows, zx, e), "nt"), "dWout": ((e, di, rows), "tn"),
            "dgated": ((rows, di, e), "nn"), "dhidden": ((rows, e, zx), "nn"),
            "dWin": ((zx, e, rows), "tn")}


def pmixer_bwd_parts(fn, iters: int = 10) -> dict:
    """K14's backward's launches, device ms a call under the profiler, by
    part: in_proj's recompute (the product before the gate), dWout and
    dgated (the products after it), K13's span, dhidden and dWin (the
    products after the span), the ordered sums of split contractions,
    memsets and torch's own ops. The profiler can lose a launch's record, so
    each product is averaged over the launches it saw."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    ms, seen = {}, {}
    pos = 0  # the next product's place in PMIXER_BWD_ORDER
    for e in evts:
        name = e.name
        if any(t in name for t in PMIXER_BWD_PRODUCTS):
            pos = 0 if pos > 4 else pos  # past dWin: the next call
            part = PMIXER_BWD_ORDER[pos]
            pos += 1
        elif "ssd_gate" in name:
            part, pos = "gate", 1
        elif "memset" in name.lower():
            part = "memsets"
        elif any(t in name for t in SPLIT_SUMS):
            part = "split-K sums"
        elif "ssd_" in name or "conv_" in name or "dsilu" in name:
            part, pos = "K13's span", 3
        else:
            part = "torch ops"
        ms[part] = ms.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
        seen[part] = seen.get(part, 0) + 1
    return {p: v / (seen[p] if p in PMIXER_BWD_ORDER else iters) for p, v in ms.items()}


def measure_pmixer_bwd(result, label, device):
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for bsz in (1, 4):
            cfg = dict(BASE_M2, batch=bsz)
            _, pm = ssd_inputs(device, dtype, cfg=cfg)
            h, p, gr, n = cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"]
            shape = (cfg["chunk"], h, p, gr, n)
            dt_p = k14.dt_projection(pm["hidden"], pm["in_proj_w"], h, pm["dt_bias"])
            ws = {k: pm[k] for k in ("A", "in_proj_w", "out_proj_w", "conv_weight",
                                     "conv_bias", "D")}
            *_, hins, yd = k14.ssd_pmixer_core(pm["hidden"], dt_p, *ws.values(),
                                               pm["initial_state"], pm["conv_state"],
                                               pm["norm_weight"], 1e-5, *shape,
                                               checkpoints=True)
            g = torch.Generator().manual_seed(29)
            kw = dict(hidden=pm["hidden"], dt_p=dt_p, **ws, conv_state=pm["conv_state"],
                      norm_weight=pm["norm_weight"], norm_eps=1e-5, hins=hins, yd=yd,
                      dout=torch.randn((bsz, cfg["seqlen"], cfg["embed"]), generator=g)
                      .to(device).to(dtype),
                      dhlast=0.5 * torch.randn((bsz, h, p, n), generator=g).to(device),
                      chunk_size=cfg["chunk"], nheads=h, hdim=p, ngroups=gr, d_state=n)
            name = f"ssd_pmixer_bwd {tag} B={bsz}"
            time_kernel(result, label, name, k14.ssd_pmixer_bwd, kw)
            parts = pmixer_bwd_parts(lambda: k14.ssd_pmixer_bwd(**kw))
            entry = result["kernels"][name]
            entry["parts_ms"] = parts
            entry["tflops"] = {part: 2 * m * nn * k / parts[part] / 1e9
                               for part, ((m, nn, k), _) in pmixer_bwd_shapes(cfg).items()
                               if parts.get(part)}
            print("    parts: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
            print("    TFLOP/s: " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in entry["tflops"].items()))
            del pm, kw, hins, yd, dt_p
            torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(5)
    result["matmul"] = {}
    for bsz in (1, 4):
        for (part, ((m, n, k), layout)) in pmixer_bwd_shapes(dict(BASE_M2, batch=bsz)).items():
            for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
                a = torch.randn((k, m) if layout == "tn" else (m, k), generator=g)
                b = torch.randn((n, k) if layout == "nt" else (k, n), generator=g)
                a, b = a.to(device).to(dtype), b.to(device).to(dtype)
                x, y = (a.t() if layout == "tn" else a), (b.t() if layout == "nt" else b)
                ms = statistics.median(event_ms(lambda: torch.matmul(x, y), iters=20)
                                       for _ in range(3))
                tf = 2 * m * n * k / ms / 1e9
                result["matmul"][f"{part} {tag} B={bsz}"] = {"ms": ms, "tflops": tf,
                                                            "mnk": [m, n, k]}
                print(f"{label} torch.matmul {part} {tag} B={bsz} ({layout}, M {m} N {n} "
                      f"K {k}): {ms:.4f} ms, {tf:.1f} TFLOP/s")


# Parts of K6's and K7's span, by kernel-name fragment (first match wins).
BWD_PARTS = (("split_bwd", "reverse walk"), ("scan_bwd", "reverse walk"),
             ("gemm_nn", "product tiles"), ("gemm_tn", "product tiles"),
             ("mma_nn", "product tiles"), ("mma_tn", "product tiles"),
             ("gemm_nt", "recompute tiles"), ("conv_silu", "recompute tiles"),
             ("conv_", "conv backward"), ("reduce_", "ordered sums"),
             ("sum_slices", "ordered sums"), ("add_norm", "norm and its backward"))


def bwd_parts(launches: dict) -> dict:
    parts = {}
    for name, ms in launches.items():
        part = next((p for frag, p in BWD_PARTS if frag in name), "other")
        parts[part] = parts.get(part, 0.0) + ms
    return parts


# Launch parts of K1 and K5, by kernel name, first match wins.
SCAN_PARTS = (("split_chunk_states", "chunk states"), ("split_bwd_chunk", "chunk cotangents"),
              ("split_bwd_pass", "pass"), ("split_pass", "pass"),
              ("split_bwd_output", "output walk"), ("split_output", "output walk"),
              ("scan_walk_kernel", "walk over all of time"),
              ("scan_bwd_kernel", "walk over all of time"), ("reduce_", "ordered sums"))


def measure_scan(result, label, device):
    from videomamba_tpu_torch.ops.kernels import scan as k1

    cfg = BASE
    for bsz in (1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(9)

            def rnd(shape, scale=1.0):
                return (torch.randn(shape, generator=g) * scale).to(device)

            L, di, n, r = cfg["seqlen"], cfg["d_inner"], cfg["d_state"], cfg["dt_rank"]
            xz, xdbl = rnd((bsz, L, 2 * di)), rnd((bsz, L, r + 2 * n))
            act = dict(u=rnd((bsz, L, di)), delta=rnd((bsz, L, di), 0.5), z=xz[..., di:],
                       B=xdbl[..., r:r + n], C=xdbl[..., r + n:])
            fwd = dict({k: v.to(dtype) for k, v in act.items()},
                       A=-torch.arange(1, n + 1, dtype=torch.float32).expand(di, n)
                       .contiguous().to(device),
                       D=torch.ones(di, device=device),
                       delta_bias=torch.linspace(-6.9, -2.3, di).to(device),
                       h0=rnd((bsz, di, n), 0.1), checkpoints=True)
            *_, ckpt = k1.selective_scan(**fwd)
            bwd = dict({k: v for k, v in fwd.items() if k not in ("h0", "checkpoints")},
                       ckpt=ckpt, g_out=rnd((bsz, L, di)).to(dtype),
                       g_hlast=rnd((bsz, di, n), 0.3))
            tag = f"{'fp32' if dtype == torch.float32 else 'bf16'} B={bsz}"
            for name, fn, kw in ((f"selective_scan {tag}", k1.selective_scan, fwd),
                                 (f"selective_scan_bwd {tag}", k1.selective_scan_bwd, bwd)):
                time_kernel(result, label, name, fn, kw)
                entry = result["kernels"][name]
                parts = {}
                for kname, ms in entry["launches_ms"].items():
                    part = next((p for frag, p in SCAN_PARTS if frag in kname), "other")
                    parts[part] = parts.get(part, 0.0) + ms
                entry["parts_ms"] = parts
                print("    parts: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
            del fwd, bwd, ckpt
            torch.cuda.empty_cache()


def measure_m1bwd(result, label, device):
    from videomamba_tpu_torch.ops.kernels import block_bwd as k7
    from videomamba_tpu_torch.ops.kernels import block_fused as k4
    from videomamba_tpu_torch.ops.kernels import mixer_bwd as k6
    from videomamba_tpu_torch.ops.kernels import mixer_fused as k3

    bf16 = torch.bfloat16
    cases = [("mixer_bwd", torch.float32, BASE, 1), ("mixer_bwd", bf16, BASE, 1),
             ("mixer_bwd", torch.float32, BASE, 4), ("mixer_bwd", bf16, BASE, 4),
             ("block_bwd", bf16, BASE, 1), ("block_bwd", torch.float32, BASE, 1),
             ("block_bwd", torch.float32, SMALL, 1), ("block_bwd", bf16, BASE, 4)]
    for kind, dtype, cfg, bsz in cases:
        cfg = dict(cfg, batch=bsz)
        mixer, block = m1_inputs(cfg, device, seed=7)
        g = torch.Generator().manual_seed(8)
        tag = f"{'fp32' if dtype == torch.float32 else 'bf16'}"
        tag += f"{' Small' if cfg['embed'] != BASE['embed'] else ''} B={bsz}"
        if kind == "mixer_bwd":
            kw = {k: v.to(dtype) if k in ("x", "z", "conv_w", "conv_b", "x_proj_w",
                                          "dt_proj_w", "conv_state") else v
                  for k, v in mixer.items()}
            *_, ckpt = k3.mixer_fused(**kw, checkpoints=True)
            kw = dict(kw, ckpt=ckpt, g_y=torch.randn(kw["x"].shape, generator=g).to(device)
                      .to(dtype), g_hlast=0.3 * torch.randn(kw["h0"].shape, generator=g)
                      .to(device))
            del kw["h0"]
            fn = k6.mixer_bwd
        else:
            kw = {k: v.to(dtype) if k in ("hidden", "in_proj_w", "out_proj_w", "conv_w",
                                          "conv_b", "x_proj_w", "dt_proj_w") else v
                  for k, v in block.items()}
            *_, ckpt = k4.block_fused(**kw, checkpoints=True)
            names = ("norm_w", "norm_b", "in_proj_w", "out_proj_w", "conv_w", "conv_b",
                     "x_proj_w", "dt_proj_w", "dt_bias", "A", "D", "conv_state")
            shape = kw["hidden"].shape
            kw = dict(res_out=kw["hidden"].float() + kw["residual"].float(),
                      **{k: kw[k] for k in names}, ckpt=ckpt,
                      g_out=torch.randn(shape, generator=g).to(device).to(dtype),
                      g_res=0.3 * torch.randn(shape, generator=g).to(device),
                      g_hlast=0.3 * torch.randn(block["h0"].shape, generator=g).to(device))
            fn = k7.block_bwd
        name = f"{kind} {tag}"
        time_kernel(result, label, name, fn, kw)
        entry = result["kernels"][name]
        entry["parts_ms"] = bwd_parts(entry["launches_ms"])
        print("    parts: " + ", ".join(f"{k} {v:.4f}" for k, v in entry["parts_ms"].items()))
        del mixer, block, kw, ckpt
        torch.cuda.empty_cache()


HBM_BYTES_PER_S = 3.35e12


def byte_bound_ms(*tensors) -> float:
    """Each tensor given read or written once, at the card's memory rate."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor)) / HBM_BYTES_PER_S * 1e3


def time_bound(result, label, name, fn, kw, tensors):
    """time_kernel, then the byte bound and its share of the device time,
    back to back (the inputs partly in L2 where they fit) and with a cold
    L2 (:func:`cold_device_ms`)."""
    time_kernel(result, label, name, fn, kw)
    entry = result["kernels"][name]
    entry["bound_ms"] = byte_bound_ms(*tensors)
    entry["device_ms_cold"] = cold_device_ms(lambda: fn(**kw))
    # A profiler session can lose a call's records: such a share is None.
    for key, ms in (("share_of_bound", "device_ms"), ("share_of_bound_cold", "device_ms_cold")):
        entry[key] = entry["bound_ms"] / entry[ms] if entry[ms] else None
    shares = [f"{100 * entry[k]:.1f} %" if entry[k] else "not measured (no records)"
              for k in ("share_of_bound", "share_of_bound_cold")]
    print(f"    bound {entry['bound_ms']:.4f} ms: {shares[0]} of it on the device; cold L2 "
          f"{entry['device_ms_cold']:.4f} ms, {shares[1]}")


def measure_norm(result, label, device):
    from videomamba_tpu_torch.ops.kernels import block_bwd as k7
    from videomamba_tpu_torch.ops.kernels import block_fused as k4
    from videomamba_tpu_torch.ops.kernels import fused_add_norm as k2
    from videomamba_tpu_torch.ops.kernels import mixer_bwd as k6
    from videomamba_tpu_torch.ops.kernels import mixer_fused as k3

    bf16 = torch.bfloat16
    for tag, m, d, x_dtype, norm_type in (("fp32 B=1", 1569, 768, torch.float32, "rms"),
                                          ("fp32 B=4", 6276, 768, torch.float32, "rms"),
                                          ("bf16 x B=1", 1569, 768, bf16, "rms"),
                                          ("fp32 layer B=1", 1569, 768, torch.float32, "layer"),
                                          ("fp32 D=3200", 1569, 3200, torch.float32, "rms")):
        g = torch.Generator().manual_seed(21)

        def rnd(shape, scale=1.0):
            return (torch.randn(shape, generator=g) * scale).to(device)

        kw = dict(x=rnd((1, m, d)).to(x_dtype), weight=1 + rnd((d,), 0.1),
                  residual=rnd((1, m, d)), g_out=rnd((1, m, d)).to(x_dtype),
                  g_resout=rnd((1, m, d)), prenorm=True, norm_type=norm_type)
        out = k2.fused_add_norm_bwd(**kw)
        time_bound(result, label, f"fused_add_norm_bwd {tag}", k2.fused_add_norm_bwd, kw,
                   [*kw.values(), *out])
        if tag == "fp32 B=1":
            fkw = dict(x=kw["x"], weight=kw["weight"], bias=None, residual=kw["residual"],
                       prenorm=True, residual_in_fp32=True, norm_type="rms")
            fout = k2.fused_add_norm(**fkw)
            time_bound(result, label, "fused_add_norm fp32 B=1", k2.fused_add_norm, fkw,
                       [*fkw.values(), *fout])
        del kw, out
    for dtype, bsz in ((bf16, 1), (torch.float32, 1), (bf16, 4), (torch.float32, 4)):
        cfg = dict(BASE, batch=bsz)
        _, block = m1_inputs(cfg, device, seed=7)
        g = torch.Generator().manual_seed(8)
        kw = {k: v.to(dtype) if k in ("hidden", "in_proj_w", "out_proj_w", "conv_w",
                                      "conv_b", "x_proj_w", "dt_proj_w") else v
              for k, v in block.items()}
        *_, ckpt = k4.block_fused(**kw, checkpoints=True)
        names = ("norm_w", "norm_b", "in_proj_w", "out_proj_w", "conv_w", "conv_b",
                 "x_proj_w", "dt_proj_w", "dt_bias", "A", "D", "conv_state")
        shape = kw["hidden"].shape
        kw = dict(res_out=kw["hidden"].float() + kw["residual"].float(),
                  **{k: kw[k] for k in names}, ckpt=ckpt,
                  g_out=torch.randn(shape, generator=g).to(device).to(dtype),
                  g_res=0.3 * torch.randn(shape, generator=g).to(device),
                  g_hlast=0.3 * torch.randn(block["h0"].shape, generator=g).to(device))
        name = f"block_bwd {'fp32' if dtype == torch.float32 else 'bf16'} B={bsz}"
        time_kernel(result, label, name, k7.block_bwd, kw)
        del block, kw, ckpt
        torch.cuda.empty_cache()
    mixer, block = m1_inputs(BASE, device, seed=3)
    time_kernel(result, label, "mixer_fused fp32 B=1", k3.mixer_fused, mixer)
    bkw = {k: v.to(bf16) if k in ("hidden", "in_proj_w", "out_proj_w", "conv_w", "conv_b",
                                  "x_proj_w", "dt_proj_w") else v for k, v in block.items()}
    time_kernel(result, label, "block_fused bf16 B=1", k4.block_fused, bkw)
    *_, ckpt = k3.mixer_fused(**mixer, checkpoints=True)
    g = torch.Generator().manual_seed(8)
    mkw = dict({k: v for k, v in mixer.items() if k != "h0"}, ckpt=ckpt,
               g_y=torch.randn(mixer["x"].shape, generator=g).to(device),
               g_hlast=0.3 * torch.randn(mixer["h0"].shape, generator=g).to(device))
    time_kernel(result, label, "mixer_bwd fp32 B=1", k6.mixer_bwd, mkw)


def measure_conv(result, label, device):
    from videomamba_tpu_torch.ops.kernels import causal_conv as k10

    F = torch.nn.functional
    L, di, w = BASE["seqlen"], BASE["d_inner"], BASE["width"]
    for bsz in (1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(13 + bsz)

            def rnd(shape, scale=1.0):
                return (torch.randn(shape, generator=g) * scale).to(device)

            kw = dict(x=rnd((bsz, L, di)).to(dtype), weight=rnd((w, di), 0.5),
                      bias=rnd((di,), 0.1), conv_state=rnd((bsz, di, w)).to(dtype))
            tag = f"{'fp32' if dtype == torch.float32 else 'bf16'} B={bsz}"
            y = k10.causal_conv(**kw)
            time_bound(result, label, f"causal_conv {tag}", k10.causal_conv, kw,
                       [*kw.values(), y])
            if dtype == torch.float32:
                zero = dict(kw, conv_state=torch.zeros_like(kw["conv_state"]), activation=None)
                xt = kw["x"].transpose(1, 2).contiguous()
                wt = kw["weight"].t().contiguous().unsqueeze(1)
                lib = lambda: F.conv1d(xt, wt, kw["bias"], padding=w - 1, groups=di)  # noqa: E731
                ms = statistics.median(event_ms(lambda: k10.causal_conv(**zero)) for _ in range(5))
                lib_ms = statistics.median(event_ms(lib) for _ in range(5))
                result["kernels"][f"causal_conv no SiLU zero window {tag}"] = {
                    "ms": ms, "conv1d_ms": lib_ms}
                print(f"{label} causal_conv no SiLU, zero window {tag}: {ms:.4f} ms; "
                      f"F.conv1d(groups={di}) {lib_ms:.4f} ms")


# Launch kinds of the decode stacks, by kernel name (the per-layer launches of
# a multi-launch stack; x_proj and out_proj share K9's GEMV kernel and come
# in that order within a layer).
DECODE_KINDS = (("decode_in", "in"), ("decode_m2_state", "state"), ("decode_state", "state"),
                ("decode_m2_out", "out"))


def decode_split(fn, iters: int):
    """(wall ms, device ms, {launch kind: device ms}) a token under the
    profiler, the kinds told apart by kernel name and order."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    kinds, gemvs = {}, 0
    for e in evts:
        kind = next((k for pat, k in DECODE_KINDS if pat in e.name), None)
        if kind is None and "decode_gemv" in e.name:
            kind, gemvs = ("x_proj", "out")[gemvs % 2], gemvs + 1
        kind = kind or e.name[:60]
        kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return wall, sum(kinds.values()), kinds


def submit_ms(fn, repeats: int = 50) -> float:
    """Median host ms for ``fn`` to return, the queue drained before each."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def measure_decode(result, label, device):
    from videomamba_tpu_torch.models.presets import videomamba_base, videomamba_base_m2
    from videomamba_tpu_torch.ops.kernels import decode_step as k9
    from videomamba_tpu_torch.runtime import DecodeSession
    from videomamba_tpu_torch.utils.precision import cast_module_for_compute

    result["decode"] = {}
    for family, preset in (("m1", videomamba_base), ("m2", videomamba_base_m2)):
        model = preset(pool_type="avg", device=device,
                       generator=torch.Generator().manual_seed(0)).eval()
        for tag in ("fp32", "bf16"):
            if tag == "bf16":
                model = cast_module_for_compute(model, torch.bfloat16)
            for bsz in (1, 8, 80):
                sess = DecodeSession(model, batch_size=bsz)
                assert sess.use_kernel, f"{family} {tag} B={bsz}: no decode kernel"
                kernel = k9.decode_stack_m2 if sess.is_m2 else k9.decode_stack
                tok = torch.randn((bsz, model.embed_dim),
                                  generator=torch.Generator().manual_seed(bsz)).to(device)
                kw = dict(sess.stacked, **sess.kernel_kw, conv_states=sess.conv_states,
                          ssm_states=sess.ssm_states)
                call = lambda: kernel(tok, **kw)  # noqa: E731
                reps = [event_ms(call, iters=100, warmup=5) for _ in range(3)]
                _, dev, kinds = decode_split(call, iters=20)
                if hasattr(k9, "phase_ms"):
                    kinds.update({f"phase {k}": v for k, v in
                                  k9.phase_ms(kernel, tok, kw).items()})
                sub = submit_ms(call)
                step = lambda: sess.step(tok)  # noqa: E731
                step_ms = host_ms(step, repeats=50)
                wall, step_dev, _ = decode_split(step, iters=50)
                key = f"{family} {tag} B={bsz}"
                result["decode"][key] = {
                    "ms": statistics.median(reps), "ms_min": min(reps), "ms_max": max(reps),
                    "device_ms": dev, "kinds_ms": kinds, "submit_ms": sub,
                    "step_host_ms": step_ms, "step_profiled_wall_ms": wall,
                    "step_device_ms": step_dev, "step_idle": (wall - step_dev) / wall}
                print(f"{label} decode {key}: {statistics.median(reps):.4f} ms a token "
                      f"({min(reps):.4f}-{max(reps):.4f}), device {dev:.4f}; submit "
                      f"{sub:.4f} ms; session step host {step_ms:.4f} ms, profiled wall "
                      f"{wall:.4f}, device {step_dev:.4f}, idle "
                      f"{100 * (wall - step_dev) / wall:.1f} %")
                for k, v in kinds.items():
                    print(f"    {v:.4f} ms  {k}")
                del sess, kw
            if family == "m1" and tag == "bf16" and hasattr(k9, "MMA_MIN_BATCH"):
                mma_crossover(result, label, model, k9)
        del model
        torch.cuda.empty_cache()


def mma_crossover(result, label, model, k9, batches=(4, 8, 16, 32, 80)):
    """K9 bf16 event ms a token with the tensor-core products (the plan's
    default from k9.MMA_MIN_BATCH on) against FMA tiles only, by batch: the
    batch from which mma.sync pays."""
    from videomamba_tpu_torch.runtime import DecodeSession

    default = k9.MMA_MIN_BATCH
    rows = {}
    for bsz in batches:
        sess = DecodeSession(model, batch_size=bsz)
        tok = torch.randn((bsz, model.embed_dim),
                          generator=torch.Generator().manual_seed(bsz)).to(model.norm.weight.device)
        kw = dict(sess.stacked, **sess.kernel_kw, conv_states=sess.conv_states,
                  ssm_states=sess.ssm_states)
        times = {}
        for mode, least in (("mma", 1), ("fma", 1 << 30)):
            k9.MMA_MIN_BATCH = least
            times[mode] = statistics.median(
                event_ms(lambda: k9.decode_stack(tok, **kw), iters=50) for _ in range(3))
        k9.MMA_MIN_BATCH = default
        rows[bsz] = times
        print(f"{label} decode m1 bf16 B={bsz}: mma {times['mma']:.4f} ms, fma "
              f"{times['fma']:.4f} ms a token")
        del sess, kw
    result["decode"]["m1 bf16 mma_vs_fma"] = rows


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("m2", "m2bwd", "pmixer_bwd", "m1", "m1bwd", "scan",
                                        "decode", "norm", "conv"),
                    default="m2")
    ap.add_argument("--root", default=here, help="checkout to import the port from")
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None, help="file for the JSON object")
    ap.add_argument("--walk-blocks", type=int, default=None,
                    help="least grid of the split forward walk (a checkout that has one)")
    ap.add_argument("--bwd-chunk", type=int, default=None,
                    help="chunk of the split reverse walk (a checkout that has one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_m2_serving: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from videomamba_tpu_torch.ops.kernels import _build
    from videomamba_tpu_torch.ops.kernels import scan

    import videomamba_tpu_torch
    assert os.path.abspath(videomamba_tpu_torch.__file__).startswith(os.path.abspath(args.root))
    if args.walk_blocks is not None:
        if not hasattr(scan, "WALK_MIN_BLOCKS"):
            print(f"compare_m2_serving: {args.root} has no split walk", file=sys.stderr)
            return 1
        scan.WALK_MIN_BLOCKS = args.walk_blocks
    if args.bwd_chunk is not None:
        if not hasattr(scan, "walk_bwd_chunk"):
            print(f"compare_m2_serving: {args.root} has no split reverse walk", file=sys.stderr)
            return 1
        scan.walk_bwd_chunk = lambda *_: args.bwd_chunk
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no card line")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    result = {"label": args.label, "root": args.root, "model": args.model,
              "walk_blocks": args.walk_blocks, "bwd_chunk": args.bwd_chunk,
              "build_s": round(time.perf_counter() - t0, 1), "kernels": {}, "clip": {}}

    with torch.inference_mode():
        measure = {"m1": measure_m1, "m1bwd": measure_m1bwd, "m2": measure_m2,
                   "m2bwd": measure_m2bwd, "pmixer_bwd": measure_pmixer_bwd,
                   "scan": measure_scan, "norm": measure_norm, "conv": measure_conv,
                   "decode": measure_decode}[args.model]
        measure(result, args.label, device)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
