"""The time-split forward walk of K1, K3 and K4 (csrc/scan_walk_split.cuh), on the CPU.

The kernel's three passes are written here in numpy at fp32, with the chunk
length and scratch shapes the wrappers pass (``walk_scratch``): (a) each
chunk but the last walked from a zero state, keeping its end state and the
sum of its dt; (b) a pass over the chunks, h <- exp(A * sum dt) * h + end,
from h0, giving each chunk's start state; (c) each chunk walked again from
its start, writing y, the 16-step checkpoints and h_last. They are held
against the port's sequential ``selective_scan_plain`` and the JAX package's
sequential oracle, ``selective_scan_bld(..., method="ref")``, within 1e-6
(rel_err = max|a - b| / max|b|): splitting only reassociates the recurrence,
a few fp32 ulps. K1's contract also takes no gate (z None), a raw dt
(softplus off), no D skip and no delta bias: the walk's kZ and kSoftplus
template arguments and a null D or bias, held here the same way. The
geometry rule is held to two blocks per SM of an H100 at VideoMamba-Base,
batch 1, and K1's scratch at batch 1 and 4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videomamba_tpu.ops.selective_scan import selective_scan_bld
from videomamba_tpu_torch.ops.kernels import scan as k1

TOL = 1e-6
F32 = np.float32


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def scan_inputs(seed, b, L, d, n):
    rng = np.random.default_rng(seed)
    return dict(
        u=rng.standard_normal((b, L, d)).astype(F32),
        delta=(0.5 * rng.standard_normal((b, L, d))).astype(F32),
        A=-np.tile(np.arange(1, n + 1, dtype=F32), (d, 1)) * np.exp(
            0.2 * rng.standard_normal((d, n))).astype(F32),
        B=rng.standard_normal((b, L, n)).astype(F32),
        C=rng.standard_normal((b, L, n)).astype(F32),
        D=rng.standard_normal(d).astype(F32),
        z=rng.standard_normal((b, L, d)).astype(F32),
        delta_bias=np.linspace(-4.0, 0.5, d).astype(F32),
        h0=(0.5 * rng.standard_normal((b, d, n))).astype(F32),
    )


def split_walk(u, delta, A, B, C, D, z, delta_bias, h0, chunk, states, dtsum,
               softplus=True):
    """The kernel's three passes at fp32; ``states`` and ``dtsum`` are the
    wrapper's scratch, written as the kernel writes them. D, z and
    delta_bias may be None (no skip, no gate, a zero bias)."""
    bsz, L, d = u.shape
    dt = delta + delta_bias if delta_bias is not None else delta
    if softplus:
        dt = np.logaddexp(dt, F32(0)).astype(F32)
    du = dt * u
    nchunks = -(-L // chunk)

    def step(h, t):
        return np.exp(dt[:, t, :, None] * A) * h + du[:, t, :, None] * B[:, t, None, :]

    for c in range(nchunks - 1):  # (a) chunk states from zero
        h = np.zeros_like(h0)
        total = np.zeros((bsz, d), F32)
        for t in range(c * chunk, (c + 1) * chunk):
            h = step(h, t)
            total = total + dt[:, t]
        states[:, c], dtsum[:, c] = h, total
    h = h0
    for c in range(nchunks - 1):  # (b) the pass over chunks, in place
        h = np.exp(A * dtsum[:, c, :, None]) * h + states[:, c]
        states[:, c] = h
    y = np.empty_like(u)
    ckpt = []
    for c in range(nchunks):  # (c) the output walk from each chunk's start
        h = h0 if c == 0 else states[:, c - 1]
        for t in range(c * chunk, min(L, (c + 1) * chunk)):
            if t % k1.SEGMENT == 0:
                ckpt.append(h)
            h = step(h, t)
            y[:, t] = (C[:, t, None, :] * h).sum(-1)
            if D is not None:
                y[:, t] += D * u[:, t]
            if z is not None:
                y[:, t] *= z[:, t] / (F32(1) + np.exp(-z[:, t]))
    return y, h, np.stack(ckpt, axis=1)


# name: (batch, L, d, n, the channel count whose chunk the wrapper picks)
CASES = {
    "base_clip": (1, 1569, 32, 16, 1536),      # L of a Base clip: 50 chunks of 32, the last of 1
    "base_first_chunk": (1, 785, 32, 16, 1536),  # a 4-frame chunk with CLS: 50 of 16
    "base_b2": (2, 1569, 16, 8, 1536),         # 25 chunks of 64, the last of 33
    "base_b4": (4, 1569, 16, 8, 1536),         # 13 chunks of 128, the last of 33
    "ragged": (2, 37, 32, 8, 32),              # chunks of 16, a last one of 5
    "one_short_chunk": (2, 10, 32, 16, 32),    # L shorter than one chunk
    "base_ragged_last": (1, 100, 24, 16, 1536),  # chunks of 16, a last one of 4
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_walk_matches_the_sequential_walks(case):
    bsz, L, d, n, d_rule = CASES[case]
    kw = scan_inputs(sorted(CASES).index(case), bsz, L, d, n)
    chunk, states, dtsum = k1.walk_scratch(bsz, L, d_rule, n, "cpu")
    assert chunk == k1.walk_chunk(bsz, L, d_rule)
    stored = -(-L // chunk) - 1
    states = np.zeros((bsz, stored, d, n), F32)
    assert tuple(dtsum.shape) == (bsz, stored, d_rule)
    dtsum = np.zeros((bsz, stored, d), F32)
    y, h_last, ckpt = split_walk(**kw, chunk=chunk, states=states, dtsum=dtsum)

    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    py, ph, pckpt = k1.selective_scan_plain(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["z"], t["delta_bias"], t["h0"],
        softplus_delta=True, checkpoints=True)
    assert ckpt.shape == tuple(pckpt.shape) == (bsz, k1.num_segments(L), d, n)
    assert rel_err(y, py) <= TOL
    assert rel_err(h_last, ph) <= TOL
    assert rel_err(ckpt, pckpt) <= TOL

    j = {k: jnp.asarray(v) for k, v in kw.items()}
    jy, jh = selective_scan_bld(
        j["u"], j["delta"], j["A"], j["B"], j["C"], D=j["D"], z=j["z"],
        delta_bias=j["delta_bias"], delta_softplus=True, initial_state=j["h0"],
        return_last_state=True, method="ref")
    assert rel_err(y, jy) <= TOL
    assert rel_err(h_last, jh) <= TOL


# K1's operand variants: (softplus, with D, with z, with delta_bias), each at
# a K1 geometry (batch, L, d, n, the channel count whose chunk the wrapper picks).
K1_CASES = {
    "no_gate": (True, True, False, True, (2, 37, 32, 8, 32)),
    "raw_dt": (False, True, True, False, (1, 100, 24, 16, 1536)),
    "bare": (False, False, False, False, (4, 1569, 8, 8, 1536)),
    "no_skip_no_bias": (True, False, True, False, (1, 1569, 16, 16, 1536)),
    "bare_b4_short": (False, False, False, False, (4, 10, 32, 16, 32)),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_split_walk_takes_k1_contract(case):
    """The walk without the gate, softplus, D skip or delta bias (K1's
    ``full=False`` contract) against both sequential walks; delta is a
    positive step where softplus is off, as the callers pass it."""
    softplus, with_d, with_z, with_bias, (bsz, L, d, n, d_rule) = K1_CASES[case]
    kw = scan_inputs(40 + sorted(K1_CASES).index(case), bsz, L, d, n)
    if not softplus:
        kw["delta"] = np.logaddexp(kw["delta"] + kw["delta_bias"], F32(0)).astype(F32)
    for key, keep in (("D", with_d), ("z", with_z), ("delta_bias", with_bias)):
        if not keep:
            kw[key] = None
    chunk, states, dtsum = k1.walk_scratch(bsz, L, d_rule, n, "cpu")
    stored = -(-L // chunk) - 1
    y, h_last, ckpt = split_walk(**kw, chunk=chunk, states=np.zeros((bsz, stored, d, n), F32),
                                 dtsum=np.zeros((bsz, stored, d), F32), softplus=softplus)

    t = {k: None if v is None else torch.from_numpy(v) for k, v in kw.items()}
    py, ph, pckpt = k1.selective_scan_plain(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["z"], t["delta_bias"], t["h0"],
        softplus_delta=softplus, checkpoints=True)
    assert rel_err(y, py) <= TOL
    assert rel_err(h_last, ph) <= TOL
    assert rel_err(ckpt, pckpt) <= TOL

    j = {k: None if v is None else jnp.asarray(v) for k, v in kw.items()}
    jy, jh = selective_scan_bld(
        j["u"], j["delta"], j["A"], j["B"], j["C"], D=j["D"], z=j["z"],
        delta_bias=j["delta_bias"], delta_softplus=softplus, initial_state=j["h0"],
        return_last_state=True, method="ref")
    assert rel_err(y, jy) <= TOL
    assert rel_err(h_last, jh) <= TOL


@pytest.mark.parametrize("batch,chunk,stored", [(1, 32, 49), (4, 128, 12), (2, 64, 24)])
def test_k1_scratch_at_base(batch, chunk, stored):
    """K1 at VideoMamba-Base widths (L 1569, Di 1536, N 16) takes the
    mixers' chunk rule: its scratch holds one state row and one dt sum per
    chunk but the last."""
    got, states, dtsum = k1.walk_scratch(batch, 1569, 1536, 16, "cpu")
    assert got == chunk == k1.walk_chunk(batch, 1569, 1536)
    assert tuple(states.shape) == (batch, stored, 1536, 16)
    assert tuple(dtsum.shape) == (batch, stored, 1536)
    assert states.dtype == dtsum.dtype == torch.float32


@pytest.mark.parametrize("seqlen", [1569, 785, 784])
def test_walk_chunk_fills_an_h100_at_base_batch_1(seqlen):
    """Base serving (d_inner 1536): the chunk-state and output launches each
    hold at least 528 blocks, four a streaming multiprocessor of an H100 (the
    least the split needs is two, 264), and a thread walks at most 128 steps
    in series."""
    chunk = k1.walk_chunk(1, seqlen, 1536)
    assert chunk % k1.SEGMENT == 0 and chunk <= 128
    chunks = -(-seqlen // chunk)
    groups = -(-1536 // k1.WALK_CHANNELS)
    assert (chunks - 1) * groups >= 528 and chunks * groups >= 528


@pytest.mark.parametrize("batch,seqlen,d,want", [
    (4, 1569, 1536, 128),  # a Base train step: 13 x 48 blocks at the longest chunk
    (1, 1569, 1536, 32),   # a Base clip: 50 x 12
    (1, 784, 1536, 16),    # a 4-frame continuation chunk: 49 x 12
    (1, 5, 1536, 16),      # shorter than a segment: one chunk of 16
    (1, 1569, 384, 16),    # Tiny: 99 chunks x 3 channel groups
    (1, 20000, 1536, 128),  # a long clip never walks more than 128 steps in series
])
def test_walk_chunk_at_other_shapes(batch, seqlen, d, want):
    assert k1.walk_chunk(batch, seqlen, d) == want
