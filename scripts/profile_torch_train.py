"""Device-time breakdown of the PyTorch port's train step on one CUDA card.

    python3 scripts/profile_torch_train.py [--batch 4] [--dtype fp32|bf16|both]
        [--model m1|m2|both] [--root DIR]

Builds VideoMamba-Base (Mamba-1, ``m1``) or VideoMamba-Base-m2 (Mamba-2,
``m2``; its layers on the default "mixer" train route: ``torch.matmul``
projections around K12 with checkpoints and K13), depth 24, random weights
from a seeded generator; takes two warm steps of ``make_train_step`` (AdamW
lr 1e-4, weight decay 0.05, zero target: the bench.py recipe; bf16 is
``compute_dtype``), times five more (the median host ms of a synchronised
step), then profiles one step with ``torch.profiler`` and prints, for each
model and dtype, the step's host wall time, the device time summed by
kernel group and the top kernels by name. The device's idle share is the
wall time not covered by kernel time (one stream: kernels do not overlap).
``--root`` imports the port from another checkout (default: the one holding
this script), so two checkouts can be compared in one call to the card,
each in its own process. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

# Kernel-name fragments -> group, first match wins.
GROUPS = (
    ("ssd_bwd_kside", "SSD reverse walk, input-row tiles (K13 / K11)"),
    ("ssd_bwd_qside", "SSD reverse walk, output-row tiles (K13 / K11)"),
    ("ssd_bwd_", "SSD reverse walk, chunk dh, pass, group sums (K13 / K11)"),
    ("ssd_epilogue_bwd", "SSD gate and norm backward (K13)"),
    ("ssd_cb_kernel", "SSD C B^T tiles, once a group (K12 / K13)"),
    ("ssd_chunk_out", "SSD chunk outputs (K12)"),
    ("ssd_chunk_state", "SSD chunk states and pass (K12)"),
    ("ssd_state_pass", "SSD chunk states and pass (K12)"),
    ("ssd_gate", "SSD gate and norm (K12)"),
    ("dsilu_kernel", "conv kernels (K3/K6, K12/K13)"),
    ("split_bwd", "reverse walk, split over time (K5 / K6 / K7)"),
    ("scan_bwd_kernel", "reverse walk over all of time (K5 before the split)"),
    ("split_", "forward walk, split over time (K1 / K3 / K4)"),
    ("scan_walk_kernel", "forward walk over all of time (K1 before the split)"),
    ("product_kernel", "K14 backward product tiles (TMA + wgmma)"),
    ("sum_splits", "K14 backward ordered split-K sums"),
    ("gemm_nt_wide", "K14 fp32 product tiles"),
    ("gemm_nt", "K3/K6 recompute product tiles"),
    ("gemm_nn", "K6/K7 cotangent product tiles"),
    ("mma_nn", "K6/K7 cotangent product tiles"),
    ("gemm_tn", "K6/K7 weight-gradient tiles"),
    ("mma_tn", "K6/K7 weight-gradient tiles"),
    ("conv_", "conv kernels (K3/K6, K12/K13)"),
    ("reduce_bc_kernel", "K5/K6 ordered reductions"),
    ("reduce_batch_kernel", "K5/K6 ordered reductions"),
    ("sum_slices", "K5/K6 ordered reductions"),
    ("add_norm", "add + norm (K2, K8)"),
    ("gemm", "cuBLAS products (in_proj, out_proj, patch embed)"),
    ("xmma", "cuBLAS products (in_proj, out_proj, patch embed)"),
    ("cutlass", "cuBLAS products (in_proj, out_proj, patch embed)"),
    ("nvjet", "cuBLAS products (in_proj, out_proj, patch embed)"),
    ("multi_tensor", "optimizer (AdamW)"),
    ("reduce_kernel", "torch reductions"),
)


def group_of(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other torch kernels (elementwise, casts, copies)"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def profile_step(model_key: str, dtype: torch.dtype, batch: int, device) -> None:
    from videomamba_tpu_torch.models.presets import videomamba_base, videomamba_base_m2
    from videomamba_tpu_torch.parallel.train_step import make_train_step

    title, preset = {"m1": ("Mamba-1 Base", videomamba_base),
                     "m2": ("Mamba-2 Base", videomamba_base_m2)}[model_key]
    model = preset(pool_type="avg", device=device, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05)
    step = make_train_step(model, opt,
                           compute_dtype=None if dtype == torch.float32 else dtype)
    g = torch.Generator().manual_seed(2)
    data = {"video": torch.randn((batch, 3, 8, 224, 224), generator=g).to(device),
            "target": torch.zeros((batch, 8 * 196, 768), device=device)}
    for _ in range(2):
        step(data)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(float)  # device kernels only, not the ops launching them
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    total = sum(by_name.values())
    by_group = defaultdict(float)
    for name, ms in by_name.items():
        by_group[group_of(name)] += ms
    label = "fp32" if dtype == torch.float32 else "bf16"
    print(f"\n{title} {label} train step, B={batch}: host {statistics.median(times):.3f} ms "
          f"(median of 5, {min(times):.3f}-{max(times):.3f}); profiled: wall {wall_ms:.3f} ms, "
          f"kernel time "
          f"{total:.3f} ms, device idle {wall_ms - total:.3f} ms "
          f"({100 * (wall_ms - total) / wall_ms:.1f} %)")
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {100 * ms / total:5.1f} %  {group}")
    print("  top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.3f} ms  {name[:110]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--dtype", choices=("fp32", "bf16", "both"), default="both")
    parser.add_argument("--model", choices=("m1", "m2", "both"), default="both")
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import videomamba_tpu_torch

    assert os.path.abspath(videomamba_tpu_torch.__file__).startswith(os.path.abspath(args.root))
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    device = torch.device("cuda")
    dtypes = {"fp32": [torch.float32], "bf16": [torch.bfloat16],
              "both": [torch.float32, torch.bfloat16]}[args.dtype]
    models = ["m1", "m2"] if args.model == "both" else [args.model]
    for model_key in models:
        for dtype in dtypes:
            profile_step(model_key, dtype, args.batch, device)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
