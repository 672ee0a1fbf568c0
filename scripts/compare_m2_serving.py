"""Mamba-2 serving times of one checkout of the port, for same-card comparisons.

    python3 scripts/compare_m2_serving.py [--root DIR] [--label NAME] [--out FILE]

Imports ``videomamba_tpu_torch`` from DIR (default: the checkout holding
this script), builds its kernels and measures, on one CUDA card, at
VideoMamba-Base-m2 shapes (B = 1, L = 1569, P = N = 64, chunk 128) with
random inputs and weights from fixed seeds:

* K12 (``ssd_mixer``) and K14's forward (``ssd_pmixer``), fp32 and bf16: the
  mean CUDA-event time of one call over 50 back-to-back calls, taken 5
  times (median and range), and under ``torch.profiler`` each of their
  launches' device time a call;
* the full Base-m2 clip (1, 3, 8, 224, 224), fp32 and cast for bf16 serving,
  under ``torch.inference_mode``: the median host time of 20 synchronised
  calls, then the device kernel time, idle share and top kernels under the
  profiler, then the host time again (a profiler session can slow a
  process's later host-bound calls).

Only entry points that every version of the port since Mamba-2 serving has
are used, so a parent and a change can be compared: run the script once per
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


def profile(fn, iters: int, top: int):
    """(wall ms, device kernel ms, {kernel: ms}) a call under torch.profiler."""
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
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    kernels = {name[:80]: us / 1e3 / iters
               for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}
    return wall, sum(by_name.values()) / 1e3 / iters, kernels


def ssd_inputs(device, dtype, seed=13):
    """K12's and K14's keyword operands at Base-m2 shapes (nonzero h0 and
    conv window), activations and weights in ``dtype``."""
    c = BASE_M2
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


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here, help="checkout to import the port from")
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None, help="file for the JSON object")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_m2_serving: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from videomamba_tpu_torch.models.presets import videomamba_base_m2
    from videomamba_tpu_torch.ops.kernels import _build
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14
    from videomamba_tpu_torch.utils.precision import cast_module_for_compute

    import videomamba_tpu_torch
    assert os.path.abspath(videomamba_tpu_torch.__file__).startswith(os.path.abspath(args.root))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no card line")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    result = {"label": args.label, "root": args.root,
              "build_s": round(time.perf_counter() - t0, 1), "kernels": {}, "clip": {}}

    with torch.inference_mode():
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            mixer, pmixer = ssd_inputs(device, dtype)
            for name, fn, kw in (("ssd_mixer", k12.ssd_mixer, mixer),
                                 ("ssd_pmixer", k14.ssd_pmixer, pmixer)):
                call = lambda: fn(**kw)  # noqa: E731
                reps = [event_ms(call) for _ in range(5)]
                _, dev, launches = profile(call, iters=10, top=8)
                result["kernels"][f"{name} {tag}"] = {
                    "ms": statistics.median(reps), "ms_min": min(reps), "ms_max": max(reps),
                    "device_ms": dev, "launches_ms": launches}
                print(f"{args.label} {name} {tag}: {statistics.median(reps):.4f} ms "
                      f"({min(reps):.4f}-{max(reps):.4f}); device {dev:.4f} ms")
                for k, v in launches.items():
                    print(f"    {v:.4f} ms  {k}")
            del mixer, pmixer

        g = torch.Generator().manual_seed(0)
        m2 = videomamba_base_m2(pool_type="avg", device=device, generator=g).eval()
        clip = torch.randn((1, 3, 8, 224, 224),
                           generator=torch.Generator().manual_seed(2)).to(device)
        for tag in ("fp32", "bf16"):
            model = m2 if tag == "fp32" else cast_module_for_compute(m2, torch.bfloat16)
            call = lambda: model(clip)  # noqa: E731
            for _ in range(3):
                call()
            before = host_ms(call)
            wall, dev, top = profile(call, iters=5, top=10)
            after = host_ms(call)
            result["clip"][tag] = {"host_ms": before, "profiled_wall_ms": wall,
                                   "device_ms": dev, "idle": (wall - dev) / wall,
                                   "host_ms_after_profiler": after, "top_kernels_ms": top}
            print(f"{args.label} m2 {tag} clip: host {before:.3f} ms; profiler wall {wall:.3f} "
                  f"ms, device {dev:.3f} ms, idle {100 * (wall - dev) / wall:.1f} %; host "
                  f"after the profiler {after:.3f} ms")
            for k, v in top.items():
                print(f"    {v:.4f} ms  {k}")
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
