"""Operation and byte counts of the port's kernels, and the H100's peaks.

A frozen copy of ``chip_smoke.py``'s ``bound``, ``HBM_BYTES_PER_S``,
``PEAK_FLOPS``, ``scan_flops``, ``mixer_flops``, ``block_flops`` (K4's),
``ssd_flops`` (K14's forward) and ``ssd_bwd_flops`` (K13's), cut to what
the metrics read, with the dtype given as "bf16" or "fp32" instead of a
torch dtype, plus the bytes each kernel must move: each input read once
and each output written once. A kernel's own intermediates
(the forward walks' checkpoints that a backward kernel reads back, scratch)
are not counted, so a count is never above what the work needs and a share
of the roofline never reads above 100 % for a correct time.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
_BYTES = {"bf16": 2, "fp32": 4}


def bound(nbytes_moved: int, flops: dict) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    mem_ms = nbytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(f / PEAK_FLOPS[kind] for kind, f in flops.items()) * 1e3
    return {"bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations"}


def scan_flops(b, L, d, n, per_step=6):
    return {"fp32": per_step * b * L * n * d}


def mixer_flops(b, L, di, n, r, w, wdtype, backward=False):
    """Conv, x_proj and dt_proj (each three times in the backward: the
    recompute, the cotangent product, the weight gradient) and the walk."""
    p = r + 2 * n
    times = 3 if backward else 1
    products = times * 2 * b * L * (di * p + r * di)
    kind = "bf16" if wdtype == "bf16" else "fp32"
    fp32 = times * 2 * w * b * L * di + scan_flops(b, L, di, n, 26 if backward else 6)["fp32"]
    return {"fp32": fp32 + (products if kind == "fp32" else 0),
            **({"bf16": products} if kind == "bf16" else {})}


def block_flops(cfg, dtype):
    """K4's operations: the mixer's, in_proj and out_proj (three products
    of b L e d_inner), and the norm."""
    b, L, e, di = cfg["batch"], cfg["seqlen"], cfg["embed"], cfg["d_inner"]
    n, r, w = cfg["d_state"], cfg["dt_rank"], cfg["width"]
    mixer = mixer_flops(b, L, di, n, r, w, dtype)
    kind = "bf16" if dtype == "bf16" else "fp32"
    mixer[kind] = mixer.get(kind, 0) + 3 * 2 * b * L * e * di
    mixer["fp32"] += 8 * b * L * e
    return mixer


def ssd_flops(cfg, dtype):
    """K14's forward operations: the conv; per row the causal half of
    C B^T and of m x (Q / 2 keys on average); the inter-chunk readout and
    the chunk states (2 P N a head each); D skip, gate and norm; in_proj
    (all its columns) and out_proj."""
    b, L, e = cfg["batch"], cfg["seqlen"], cfg["embed"]
    h, p, gr, n, w, q = (cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"],
                         cfg["width"], cfg["chunk"])
    di = h * p
    cd = di + 2 * gr * n
    kind = "bf16" if dtype == "bf16" else "fp32"
    products = b * L * (q * (gr * n + h * p) + 4 * h * p * n)
    products += 2 * b * L * e * (di + cd + h + di)
    return {kind: products, "fp32": (products if kind == "fp32" else 0)
            + b * L * (2 * w * cd + 12 * di)}


def ssd_bwd_flops(cfg, dtype):
    """The least operations of K13: per row the causal half of C B^T, dM,
    M^T dy and the two dcb products (Q / 2 keys on average), per row and
    head the four (P, N) state products, and the conv backward and the
    epilogue."""
    b, L = cfg["batch"], cfg["seqlen"]
    h, p, gr, n, w, q = (cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"],
                         cfg["width"], cfg["chunk"])
    di = h * p
    cd = di + 2 * gr * n
    tag = "bf16" if dtype == "bf16" else "fp32"
    products = 2 * b * L * ((q // 2) * (gr * n + 2 * h * (p + n)) + 4 * h * p * n)
    fp32 = b * L * (4 * w * cd + 20 * di)
    return {tag: products, "fp32": (products if tag == "fp32" else 0) + fp32}


# ------------------------------------------------------------------ bytes

def block_fused_bytes(cfg, dtype):
    """K4 at serving: reads hidden (activation dtype), the fp32 residual,
    every weight once, h0 and the fp32 conv window; writes the mixer
    output, the fp32 residual and h_last."""
    b, L, e, di = cfg["batch"], cfg["seqlen"], cfg["embed"], cfg["d_inner"]
    n, r, w = cfg["d_state"], cfg["dt_rank"], cfg["width"]
    a = _BYTES[dtype]
    weights = a * (2 * di * e + e * di + di * w + di + (r + 2 * n) * di + di * r)
    fp32_params = 4 * (e + di + di * n + di)  # norm, dt_bias, A, D
    rows = b * L * e
    states = 4 * (b * di * n + b * di * w)
    return rows * (a + 4) + weights + fp32_params + states + rows * (a + 4) + 4 * b * di * n


def ssd_pmixer_bytes(cfg, dtype):
    """K14's forward: reads hidden, in_proj (all its columns), out_proj, the
    conv taps and the per-head and norm parameters, h0 and the fp32 conv
    window; writes the output and h_last."""
    b, L, e = cfg["batch"], cfg["seqlen"], cfg["embed"]
    h, p, gr, n, w = cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"], cfg["width"]
    di = h * p
    cd = di + 2 * gr * n
    a = _BYTES[dtype]
    weights = a * ((di + cd + h) * e + e * di + cd * w + cd) + 4 * (3 * h + di)
    states = 4 * (b * h * p * n + b * cd * w)
    return 2 * a * b * L * e + weights + states + 4 * b * h * p * n


def mixer_bwd_bytes(cfg, dtype):
    """K6: reads x, z and the output cotangent (activation dtype), the conv
    window, the weights and h_last's cotangent; writes dx, dz (activation
    dtype) and the fp32 weight, h0 and window gradients. The forward walk's
    checkpoints it reads back are not counted."""
    b, L, di = cfg["batch"], cfg["seqlen"], cfg["d_inner"]
    n, r, w = cfg["d_state"], cfg["dt_rank"], cfg["width"]
    a = _BYTES[dtype]
    acts = b * L * di
    weights = a * (di * w + di + (r + 2 * n) * di + di * r) + 4 * (di + di * n + di)
    grads = 4 * (di * w + di + (r + 2 * n) * di + di * r + di + di * n + di)
    states = 4 * (b * di * w + b * di * n)
    return 3 * a * acts + weights + states + 2 * a * acts + grads + states


def ssd_mixer_bwd_bytes(cfg, dtype):
    """K13: reads in_proj's output rows (z, x B C, dt columns), the gated
    output's cotangent, fp32 dt, the conv window, the per-head and norm
    parameters and h_last's cotangent; writes their cotangents rows, fp32
    ddt and the fp32 parameter, h0 and window gradients. The checkpoints
    of the forward chunk walk are not counted."""
    b, L = cfg["batch"], cfg["seqlen"]
    h, p, gr, n, w = cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"], cfg["width"]
    di = h * p
    cd = di + 2 * gr * n
    a = _BYTES[dtype]
    cols = di + cd + h
    params = 4 * (cd * w + cd + 2 * h + di)
    states = 4 * (b * cd * w + b * h * p * n)
    reads = a * b * L * (cols + di) + 4 * b * L * h + params + states
    writes = a * b * L * cols + 4 * b * L * h + params + states
    return reads + writes
