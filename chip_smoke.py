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
5. kernels at bf16: K4 (whole Block) against its plain version at Base
   shapes in bf16 with nonzero h0 and conv_state (rel_err <= 1e-2) and at
   Small shapes in fp32, the fp32 whole-block route (<= 1e-5); K2 with a
   bf16 x and an fp32 residual (<= 1e-2); each timed beside its plain version.
6. bf16 forward: the Base weights of phase 2 cast for bf16 serving
   (utils/precision.py), full clip, kernels on: 24 K4, 1 K2 and 0 K3
   launches per forward; against the same Blocks' plain versions on the
   captured input tokens, rel_err <= 2e-2 (one-ulp bf16 flips carried
   through 24 layers); the max and mean relative error against phase 2's
   fp32 features are printed.
7. bf16 stream: StreamingSession over two 4-frame chunks; stitched patch
   tokens against the bf16 full clip, rel_err <= 1e-2; states stay fp32.

The launch counters are zeroed just before phases 2-4 (the fp32 main path)
and read just after, and again around phases 6-7 (the bf16 main path).
TF32 is off for matmuls and cuDNN throughout. Times are CUDA-event times per
launch (kernels) or host time around a synchronised call (forward, chunk),
medians over repeats, on the card named in the output. The last stdout line
is the contract JSON; the line before it lists the kernels.
"""

from __future__ import annotations

import copy
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
from videomamba_tpu_torch.ops.kernels import block_fused as k4  # noqa: E402
from videomamba_tpu_torch.ops.kernels import fused_add_norm as k2  # noqa: E402
from videomamba_tpu_torch.ops.kernels import mixer_fused as k3  # noqa: E402
from videomamba_tpu_torch.ops.kernels import scan as k1  # noqa: E402
from videomamba_tpu_torch.runtime import StreamingSession  # noqa: E402
from videomamba_tpu_torch.utils.precision import cast_module_for_compute  # noqa: E402

BASE = dict(batch=1, seqlen=1569, embed=768, d_inner=1536, d_state=16, dt_rank=48, width=4)
SMALL = dict(BASE, embed=384, d_inner=768, dt_rank=24)
KERNEL_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_TOL = 1e-2      # one bf16 ulp is 2^-8 of the largest element
BF16_MODEL_TOL = 2e-2  # such flips carried through 24 layers
WRAPPERS = {"selective_scan": k1.selective_scan,
            "fused_add_norm": k2.fused_add_norm,
            "mixer_fused": k3.mixer_fused,
            "block_fused": k4.block_fused}
SOURCES = {
    "selective_scan": ("videomamba_tpu_torch/csrc/selective_scan.cu",
                       "videomamba_tpu/ops/pallas/scan.py:181"),
    "fused_add_norm": ("videomamba_tpu_torch/csrc/fused_add_norm.cu",
                       "videomamba_tpu/ops/pallas/fused_add_norm.py:59"),
    "mixer_fused": ("videomamba_tpu_torch/csrc/mixer_fused.cu",
                    "videomamba_tpu/ops/pallas/mixer_fused.py:324"),
    "block_fused": ("videomamba_tpu_torch/csrc/block_fused.cu",
                    "videomamba_tpu/ops/pallas/block_fused.py:494"),
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


def time_against_plain(name, fn, plain, kw, tol, iters=20, plain_iters=3):
    """One kernel call against its plain version on the same inputs (every
    output, dtype and values), then both timed; returns the kernels-line
    entries max_abs_err, ms and plain_ms."""
    out = fn(**kw)
    torch.cuda.synchronize()
    ref = plain(**kw)
    errs = []
    for i, (o, p) in enumerate(zip(out, ref)):
        check(o.dtype == p.dtype, f"{name}[{i}]: dtype {o.dtype} != plain {p.dtype}")
        errs.append(check_close(f"kernel {name}[{i}]", o, p, tol))
    ms = event_ms(lambda: fn(**kw), iters)
    plain_ms = event_ms(lambda: plain(**kw), plain_iters, warmup=1)
    print(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def phase_kernels(cfg, device):
    """K1-K3 (fp32) each against its plain version on the same inputs, and timed."""
    plains = {"selective_scan": k1.selective_scan_plain,
              "fused_add_norm": k2.fused_add_norm_plain,
              "mixer_fused": k3.mixer_fused_plain}
    return {name: time_against_plain(name, WRAPPERS[name], plains[name], kw, KERNEL_TOL)
            for name, kw in kernel_inputs(cfg, device).items()}


def block_inputs(cfg, device, dtype, seed=3):
    """K4 operands at the shapes a Block gives it: weights in ``dtype``,
    nonzero h0 and conv_state."""
    g = torch.Generator().manual_seed(seed)
    b, L, e, di = cfg["batch"], cfg["seqlen"], cfg["embed"], cfg["d_inner"]
    n, r, w = cfg["d_state"], cfg["dt_rank"], cfg["width"]
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n).contiguous().to(device)
    return dict(
        hidden=randn((b, L, e), g, device).to(dtype), residual=randn((b, L, e), g, device),
        norm_w=1 + randn((e,), g, device, 0.1), norm_b=None,
        in_proj_w=randn((2 * di, e), g, device, e ** -0.5).to(dtype),
        out_proj_w=randn((e, di), g, device, di ** -0.5).to(dtype),
        conv_w=randn((di, w), g, device, 0.5).to(dtype),
        conv_b=randn((di,), g, device, 0.5).to(dtype),
        x_proj_w=randn((r + 2 * n, di), g, device, di ** -0.5).to(dtype),
        dt_proj_w=randn((di, r), g, device, r ** -0.5).to(dtype),
        dt_bias=torch.linspace(-6.9, -2.3, di).to(device), A=a,
        D=torch.ones(di, device=device), h0=randn((b, di, n), g, device, 0.1),
        conv_state=randn((b, di, w), g, device),
    )


def phase_bf16_kernels(device):
    """K4 at bf16 (Base) and fp32 (Small), K2 at bf16, against plain."""
    result = time_against_plain(
        "block_fused bf16 Base", k4.block_fused, k4.block_fused_plain,
        block_inputs(BASE, device, torch.bfloat16), BF16_TOL)
    time_against_plain("block_fused fp32 Small", k4.block_fused, k4.block_fused_plain,
                       block_inputs(SMALL, device, torch.float32), KERNEL_TOL)
    norm = kernel_inputs(BASE, device)["fused_add_norm"]
    time_against_plain("fused_add_norm bf16 x, fp32 residual", k2.fused_add_norm,
                       k2.fused_add_norm_plain, dict(norm, x=norm["x"].bfloat16()), BF16_TOL)
    return result


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
    check(used["fused_add_norm"] == depth + 1 and used["mixer_fused"] == depth
          and used["block_fused"] == 0,
          f"forward: expected K2={depth + 1}, K3={depth}, K4=0 launches, got {used}")
    t_tokens = clip.shape[2] // fast.patch_embed.tubelet_size
    tokens = t_tokens * fast.patch_embed.num_patches
    check(x_vis.shape == (clip.shape[0], tokens, fast.embed_dim), f"x_vis shape {tuple(x_vis.shape)}")
    check(x_pool.shape == (clip.shape[0], 1, fast.embed_dim), f"x_pool shape {tuple(x_pool.shape)}")
    p_vis, p_pool = plain(clip)
    check_close("forward x_vis vs plain", x_vis, p_vis, MODEL_TOL)
    check_close("forward x_pool vs plain", x_pool, p_pool, MODEL_TOL)
    return x_vis


def phase_stream(fast, clip, full_vis, chunk_frames, tol=MODEL_TOL):
    session = StreamingSession(fast, batch_size=clip.shape[0])
    outs = []
    for t0 in range(0, clip.shape[2], chunk_frames):
        x_vis, x_pool = session.process(clip[:, :, t0:t0 + chunk_frames])
        check(bool(torch.isfinite(x_pool).all()), "stream: non-finite x_pool")
        for conv, ssm in session.state:
            check(conv.dtype == ssm.dtype == torch.float32,
                  f"stream: states are {conv.dtype}, {ssm.dtype}, not fp32")
        outs.append(x_vis)
    torch.cuda.synchronize()
    check_close(f"stream stitched vs full clip ({full_vis.dtype})", torch.cat(outs, dim=1),
                full_vis, tol)


def plain_blocks(model, tokens):
    """The encoder from the first Block's input tokens on: every Block's
    whole-block plain version, then the final norm's plain version."""
    hidden, residual = tokens, torch.zeros_like(tokens, dtype=torch.float32)
    bsz = tokens.shape[0]
    for layer in model.layers:
        mx = layer.mixer
        zeros = dict(device=tokens.device)
        hidden, residual, _ = k4.block_fused_plain(
            hidden, residual,
            h0=torch.zeros((bsz, mx.d_inner, mx.d_state), dtype=torch.float32, **zeros),
            conv_state=torch.zeros((bsz, mx.d_inner, mx.d_conv), dtype=tokens.dtype, **zeros),
            **layer.block_fused_weights())
    return k2.fused_add_norm_plain(
        hidden, model.norm.weight, model.norm.bias, residual=residual,
        residual_in_fp32=model.residual_in_fp32, eps=model.norm_epsilon,
        norm_type="rms" if model.rms_norm else "layer")


def phase_bf16_forward(model, clip, fp32_vis, depth):
    """bf16 Base full clip, kernels on, against the plain Blocks."""
    seen = {}

    def keep_tokens(module, args):
        seen.setdefault("tokens", args[0])

    hook = model.layers[0].register_forward_pre_hook(keep_tokens)
    before = launches()
    x_vis, x_pool = model(clip)
    torch.cuda.synchronize()
    used = delta(launches(), before)
    hook.remove()
    print(f"bf16 forward launches: {used}")
    check(used == {"selective_scan": 0, "fused_add_norm": 1, "mixer_fused": 0,
                   "block_fused": depth},
          f"bf16 forward: expected K4={depth}, K2=1, K1=K3=0 launches, got {used}")
    check(x_vis.dtype == torch.bfloat16 and x_vis.shape == fp32_vis.shape,
          f"bf16 x_vis {x_vis.dtype} {tuple(x_vis.shape)}")
    check(bool(torch.isfinite(x_pool).all()), "bf16 forward: non-finite x_pool")
    ref = plain_blocks(model, seen["tokens"])[:, 1:]  # CLS leads
    check_close("bf16 forward x_vis vs plain Blocks", x_vis, ref, BF16_MODEL_TOL)
    diff = (x_vis.double() - fp32_vis.double()).abs()
    print(f"bf16 vs fp32 x_vis: max rel {float(diff.max() / fp32_vis.abs().max()):.3e}, "
          f"mean rel {float(diff.mean() / fp32_vis.double().abs().mean()):.3e}")
    return x_vis


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
        fp32_counts = launches()
        print(f"fp32 main path launches: {fp32_counts}")
        for name in ("selective_scan", "fused_add_norm", "mixer_fused"):
            check(fp32_counts[name] > 0, f"{name} was not launched on the fp32 main path")

        kernels["block_fused"] = phase_bf16_kernels(device)

        bf16 = cast_module_for_compute(copy.deepcopy(fast), torch.bfloat16)
        for w in WRAPPERS.values():
            w.launches = 0
        bf16_vis = phase_bf16_forward(bf16, clip, full_vis, depth)
        phase_stream(bf16, clip, bf16_vis, chunk_frames=4, tol=BF16_TOL)
        bf16_counts = launches()
        print(f"bf16 main path launches: {bf16_counts}")
        for name in ("fused_add_norm", "block_fused"):
            check(bf16_counts[name] > 0, f"{name} was not launched on the bf16 main path")
        counts = {name: fp32_counts[name] + bf16_counts[name] for name in WRAPPERS}

        for label, model, plain_model in (("fp32", fast, plain), ("bf16", bf16, None)):
            fwd_ms = host_ms(lambda: model(clip), repeats=5)
            chunk0, chunk1 = [], []
            for _ in range(5):
                session = StreamingSession(model, batch_size=1)
                chunk0.append(host_ms(lambda: session.process(clip[:, :, :4]), repeats=1))
                chunk1.append(host_ms(lambda: session.process(clip[:, :, 4:]), repeats=1))
            plain_note = ""
            if plain_model is not None:
                plain_note = f"; plain path {host_ms(lambda: plain_model(clip), repeats=1):.3f} ms"
            print(f"{label} full-clip forward (1,3,8,224,224): {fwd_ms:.3f} ms{plain_note}")
            print(f"{label} streaming chunk (4 frames): first {statistics.median(chunk0):.3f} ms, "
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
