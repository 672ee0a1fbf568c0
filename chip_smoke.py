"""Drive the PyTorch port's serving path once on one CUDA card and check it.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; it builds the hand-written kernels from
``videomamba_tpu_torch/csrc`` first. Phases, each of which raises on
failure, so the script exits nonzero:

1. kernels: K1 (selective scan), K2 (fused add + RMSNorm) and K3 (fused
   mixer) against their plain PyTorch versions on the card at
   VideoMamba-Base shapes (B=1, L=1569, E=768, Di=1536, N=16, R=48), fp32,
   rel_err <= 1e-5; each timed beside its plain version.
2. forward: VideoMamba-Base fp32 (depth 24, pool 'avg', weights from a
   seeded torch.Generator), full clip (1, 3, 8, 224, 224), kernels on,
   against the plain path on the card (rel_err <= 1e-4: 24 layers of
   reordered fp32 sums); K2 runs 25 times and K3 24 times per forward.
3. stream: StreamingSession over two 4-frame chunks; stitched patch tokens
   against the full clip, rel_err <= 1e-4.
4. unfused: one Base-width Mamba layer with conv_bias=False (the mixer's
   unfused branch) runs K1, against the plain path, rel_err <= 1e-5.

The launch counters are zeroed just before phases 2-4 (the main path) and
read just after. TF32 is off for matmuls and cuDNN throughout. Times are
CUDA-event times per launch (kernels) or host time around a synchronised
call (forward, chunk), medians over repeats, on the card named in the
output. The last stdout line is the contract JSON; the line before it lists
the kernels.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from videomamba_tpu_torch.checkpoint import load_state_dict  # noqa: E402
from videomamba_tpu_torch.models.mamba import Mamba  # noqa: E402
from videomamba_tpu_torch.models.presets import videomamba_base  # noqa: E402
from videomamba_tpu_torch.ops.kernels import _build  # noqa: E402
from videomamba_tpu_torch.ops.kernels import fused_add_norm as k2  # noqa: E402
from videomamba_tpu_torch.ops.kernels import mixer_fused as k3  # noqa: E402
from videomamba_tpu_torch.ops.kernels import scan as k1  # noqa: E402
from videomamba_tpu_torch.runtime import StreamingSession  # noqa: E402

BASE = dict(batch=1, seqlen=1569, embed=768, d_inner=1536, d_state=16, dt_rank=48, width=4)
KERNEL_TOL = 1e-5
MODEL_TOL = 1e-4
WRAPPERS = {"selective_scan": k1.selective_scan,
            "fused_add_norm": k2.fused_add_norm,
            "mixer_fused": k3.mixer_fused}
SOURCES = {
    "selective_scan": ("videomamba_tpu_torch/csrc/selective_scan.cu",
                       "videomamba_tpu/ops/pallas/scan.py:181"),
    "fused_add_norm": ("videomamba_tpu_torch/csrc/fused_add_norm.cu",
                       "videomamba_tpu/ops/pallas/fused_add_norm.py:59"),
    "mixer_fused": ("videomamba_tpu_torch/csrc/mixer_fused.cu",
                    "videomamba_tpu/ops/pallas/mixer_fused.py:324"),
}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-8))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = rel_err(got, want)
    print(f"{name}: rel_err {err:.3e} (tol {tol:g})")
    check(err <= tol, f"{name}: rel_err {err:.3e} > {tol:g}")
    return float((got.double() - want.double()).abs().max())


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of one call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_ms(fn, repeats: int) -> float:
    """Median host time of a synchronised call."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def randn(shape, g, device, scale=1.0):
    return (scale * torch.randn(shape, generator=g)).to(device)


def kernel_inputs(cfg, device, seed=0):
    """Random inputs at the shapes the main path gives each kernel."""
    g = torch.Generator().manual_seed(seed)
    b, L, e, di = cfg["batch"], cfg["seqlen"], cfg["embed"], cfg["d_inner"]
    n, r, w = cfg["d_state"], cfg["dt_rank"], cfg["width"]
    xz = randn((b, L, 2 * di), g, device)
    xdbl = randn((b, L, r + 2 * n), g, device)
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n).contiguous().to(device)
    dt_bias = torch.linspace(-6.9, -2.3, di).to(device)  # softplus^-1 of [1e-3, 0.1]
    scan = dict(u=randn((b, L, di), g, device), delta=randn((b, L, di), g, device, 0.5),
                A=a, B=xdbl[..., r:r + n], C=xdbl[..., r + n:], D=torch.ones(di, device=device),
                z=xz[..., di:], delta_bias=dt_bias, h0=randn((b, di, n), g, device, 0.1))
    norm = dict(x=randn((b, L, e), g, device), weight=1 + randn((e,), g, device, 0.1),
                bias=None, residual=randn((b, L, e), g, device), prenorm=True,
                residual_in_fp32=True, norm_type="rms")
    mixer = dict(x=xz[..., :di], z=xz[..., di:], conv_w=randn((di, w), g, device, 0.5),
                 conv_b=randn((di,), g, device, 0.5), x_proj_w=randn((r + 2 * n, di), g, device, 0.02),
                 dt_proj_w=randn((di, r), g, device, 0.02), dt_bias=dt_bias, A=a,
                 D=torch.ones(di, device=device), h0=randn((b, di, n), g, device, 0.1),
                 conv_state=randn((b, di, w), g, device))
    return {"selective_scan": scan, "fused_add_norm": norm, "mixer_fused": mixer}


def phase_kernels(cfg, device, iters=20, plain_iters=3):
    """Each kernel against its plain version on the same inputs, and timed."""
    plains = {"selective_scan": k1.selective_scan_plain,
              "fused_add_norm": k2.fused_add_norm_plain,
              "mixer_fused": k3.mixer_fused_plain}
    results = {}
    for name, kw in kernel_inputs(cfg, device).items():
        out = WRAPPERS[name](**kw)
        torch.cuda.synchronize()
        ref = plains[name](**kw)
        errs = [check_close(f"kernel {name}[{i}]", o, p, KERNEL_TOL)
                for i, (o, p) in enumerate(zip(out, ref))]
        ms = event_ms(lambda: WRAPPERS[name](**kw), iters)
        plain_ms = event_ms(lambda: plains[name](**kw), plain_iters, warmup=1)
        print(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results[name] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}
    return results


def build_models(device, **overrides):
    """Base fp32 with kernels on, and the same weights on the plain path."""
    g = torch.Generator().manual_seed(0)
    fast = videomamba_base(pool_type="avg", device=device, generator=g, **overrides).eval()
    plain = videomamba_base(pool_type="avg", device=device, fused_add_norm=False,
                            ssm_cfg={"use_fast_path": False}, **overrides).eval()
    load_state_dict(plain, fast.state_dict())
    return fast, plain


def launches():
    return {name: w.launches for name, w in WRAPPERS.items()}


def delta(after, before):
    return {k: after[k] - before[k] for k in after}


def phase_forward(fast, plain, clip, depth):
    before = launches()
    x_vis, x_pool = fast(clip)
    torch.cuda.synchronize()
    used = delta(launches(), before)
    print(f"forward launches: {used}")
    check(used["fused_add_norm"] == depth + 1 and used["mixer_fused"] == depth,
          f"forward: expected K2={depth + 1}, K3={depth} launches, got {used}")
    t_tokens = clip.shape[2] // fast.patch_embed.tubelet_size
    tokens = t_tokens * fast.patch_embed.num_patches
    check(x_vis.shape == (clip.shape[0], tokens, fast.embed_dim), f"x_vis shape {tuple(x_vis.shape)}")
    check(x_pool.shape == (clip.shape[0], 1, fast.embed_dim), f"x_pool shape {tuple(x_pool.shape)}")
    p_vis, p_pool = plain(clip)
    check_close("forward x_vis vs plain", x_vis, p_vis, MODEL_TOL)
    check_close("forward x_pool vs plain", x_pool, p_pool, MODEL_TOL)
    return x_vis


def phase_stream(fast, clip, full_vis, chunk_frames):
    session = StreamingSession(fast, batch_size=clip.shape[0])
    outs = []
    for t0 in range(0, clip.shape[2], chunk_frames):
        x_vis, x_pool = session.process(clip[:, :, t0:t0 + chunk_frames])
        check(bool(torch.isfinite(x_pool).all()), "stream: non-finite x_pool")
        outs.append(x_vis)
    torch.cuda.synchronize()
    check_close("stream stitched vs full clip", torch.cat(outs, dim=1), full_vis, MODEL_TOL)


def phase_unfused(cfg, device):
    g = torch.Generator().manual_seed(1)
    layer = Mamba(cfg["embed"], conv_bias=False, device=device, generator=g).eval()
    plain = Mamba(cfg["embed"], conv_bias=False, use_fast_path=False, device=device).eval()
    plain.load_state_dict(layer.state_dict())
    check(not layer._use_fused_mixer(), "unfused: the layer took the fused branch")
    x = randn((cfg["batch"], cfg["seqlen"], cfg["embed"]), g, device)
    before = launches()["selective_scan"]
    y = layer(x)
    torch.cuda.synchronize()
    check(launches()["selective_scan"] > before, "unfused: K1 was not launched")
    check_close("unfused mixer vs plain", y, plain(x), KERNEL_TOL)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing was run", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())  # name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off (matmul and cuDNN)")

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    with torch.inference_mode():
        kernels = phase_kernels(BASE, device)

        fast, plain = build_models(device)
        clip = torch.randn((1, 3, 8, 224, 224), generator=torch.Generator().manual_seed(2)).to(device)
        depth = fast.depth

        for w in WRAPPERS.values():
            w.launches = 0
        full_vis = phase_forward(fast, plain, clip, depth)
        phase_stream(fast, clip, full_vis, chunk_frames=4)
        phase_unfused(BASE, device)
        counts = launches()
        print(f"main path launches: {counts}")
        for name, n in counts.items():
            check(n > 0, f"{name} was not launched on the main path")

        fwd_ms = host_ms(lambda: fast(clip), repeats=5)
        plain_fwd_ms = host_ms(lambda: plain(clip), repeats=1)
        chunk0, chunk1 = [], []
        for _ in range(5):
            session = StreamingSession(fast, batch_size=1)
            chunk0.append(host_ms(lambda: session.process(clip[:, :, :4]), repeats=1))
            chunk1.append(host_ms(lambda: session.process(clip[:, :, 4:]), repeats=1))
        print(f"full-clip forward (1,3,8,224,224): {fwd_ms:.3f} ms; plain path {plain_fwd_ms:.3f} ms")
        print(f"streaming chunk (4 frames): first {statistics.median(chunk0):.3f} ms, "
              f"continuation {statistics.median(chunk1):.3f} ms")

    rows = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": counts[name], **kernels[name]}
        for name in WRAPPERS
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
