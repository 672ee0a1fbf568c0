"""The time-split reverse walk of K5, K6 and K7 (csrc/scan_walk_split_bwd.cuh), on the CPU.

The kernel's three passes are written here in numpy at fp32, with the chunk
length the wrappers pass (``walk_bwd_chunk``) and the scratch shapes the
kernel lays out: (a) each chunk but the first walked backwards from a zero
cotangent carry, the cotangent chain alone, keeping its carry-out (carry,
(batch, nchunks - 1, d, n)) and the sum of its dt (dtsum, (batch,
nchunks - 1, d)); (b) a pass over the chunks in reverse from the h_last
cotangent, s <- exp(A * sum dt) * s + carry-out, giving each chunk's
incoming carry; (c) each chunk walked again from its incoming carry,
rebuilding the pre-update states from the 16-step checkpoints, writing du,
ddelta, dz, dB and dC and its own dA, dD and dbias partials ((batch,
nchunks, d[, n]), summed in one fixed order), chunk 0 ending on dh0.

Every gradient is held within 1e-6 (rel_err = max|a - b| / max|b|) of the
port's sequential ``selective_scan_bwd_plain`` and of the JAX package's
gradients (``jax.vjp`` of ``selective_scan_bld(..., method="ref")``):
splitting only reassociates the cotangent recurrence and the sums, a few
fp32 ulps. The yardstick owes nothing to the split: the port's sequential
walk (``scan_bwd_core``) run in float64 on the same inputs. The passes run
in float64 must equal it to 1e-12, so a wrong carry or chunk boundary shows
at any precision, and the fp32 passes must come within 1e-6 of it. A
sequential fp32 reference sums dA over all L steps in fp32, and at L = 1569
that sum alone is up to 1.7e-6 away from exact arithmetic, so each fp32
reference is first held within 2e-6 of the float64 walk, and the split walk
is then held within 1e-6 beyond that reference's own measured distance.
K5's contract also takes no gate, a raw dt (softplus off), no D skip and
no delta bias (the walk's kZ and kSoftplus template arguments, a null D or
bias): those cases are held the same way. The chunk rule is held to eight
blocks per SM of an H100 at VideoMamba-Base, batch 1, and K5's scratch at
batch 1 and 4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.ops.selective_scan import selective_scan_bld
from videomamba_tpu_torch.ops.kernels import scan as k1

TOL = 1e-6
EXACT_TOL = 1e-12  # float64 split walk against the float64 sequential walk
REF_TOL = 2e-6     # an fp32 sequential reference against the float64 walk
F32 = np.float32
NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias", "dh0")


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def scan_inputs(seed, b, L, d, n, with_z, with_hlast, softplus=True, with_d=True,
                with_bias=True):
    """Operands, cotangent g and g_hlast; without softplus delta (and
    delta + delta_bias) is a positive step, as the callers pass it."""
    rng = np.random.default_rng(seed)
    p = dict(
        u=rng.standard_normal((b, L, d)).astype(F32),
        delta=(0.5 * rng.standard_normal((b, L, d))).astype(F32),
        A=-np.tile(np.arange(1, n + 1, dtype=F32), (d, 1)) * np.exp(
            0.2 * rng.standard_normal((d, n))).astype(F32),
        B=rng.standard_normal((b, L, n)).astype(F32),
        C=rng.standard_normal((b, L, n)).astype(F32),
        D=rng.standard_normal(d).astype(F32),
        z=rng.standard_normal((b, L, d)).astype(F32) if with_z else None,
        delta_bias=np.linspace(-4.0, 0.5, d).astype(F32),
        h0=(0.5 * rng.standard_normal((b, d, n))).astype(F32),
    )
    g = rng.standard_normal((b, L, d)).astype(F32)
    g_hlast = (0.3 * rng.standard_normal((b, d, n))).astype(F32) if with_hlast else None
    if not softplus:  # a positive step, and a small positive bias on it
        p["delta"] = np.logaddexp(p["delta"] + p["delta_bias"], F32(0)).astype(F32)
        p["delta_bias"] = np.linspace(0.0, 0.2, d).astype(F32)
    if not with_d:
        p["D"] = None
    if not with_bias:
        p["delta_bias"] = None
    return p, g, g_hlast


def split_walk_bwd(u, delta, A, B, C, D, z, delta_bias, ckpt, g, g_hlast, chunk,
                   softplus=True):
    """The kernel's three passes in the inputs' dtype (fp32, or float64 for
    the exact reference). Returns the gradients in NAMES order (dz None
    without z, dD None without D, dbias None without delta_bias) and the
    chunk scratch (carry, dtsum) as pass (b) leaves it."""
    F32 = u.dtype.type
    bsz, L, d = u.shape
    n = A.shape[1]
    dt = delta + delta_bias if delta_bias is not None else delta
    if softplus:
        dt = np.logaddexp(dt, F32(0)).astype(F32)
    dskip = D if D is not None else F32(0)
    du_t = dt * u
    if z is not None:
        sig = F32(1) / (F32(1) + np.exp(-z))
        g2 = g * (z * sig)
        gz = g * (sig * (F32(1) + z * (F32(1) - sig)))
    else:
        g2, gz = g, None
    nchunks = -(-L // chunk)
    carry = np.zeros((bsz, nchunks - 1, d, n), F32)
    dtsum = np.zeros((bsz, nchunks - 1, d), F32)

    def chunk_steps(c):
        return range(c * chunk, min(L, (c + 1) * chunk))

    for c in range(1, nchunks):  # (a) chunk cotangents from a zero carry
        s = np.zeros((bsz, d, n), F32)
        total = np.zeros((bsz, d), F32)
        for t in reversed(chunk_steps(c)):
            total = total + dt[:, t]
            s = np.exp(dt[:, t, :, None] * A) * (C[:, t, None, :] * g2[:, t, :, None] + s)
        carry[:, c - 1], dtsum[:, c - 1] = s, total
    s = np.zeros((bsz, d, n), F32) if g_hlast is None else g_hlast
    for c in reversed(range(1, nchunks)):  # (b) the pass, in place
        s = np.exp(A * dtsum[:, c - 1, :, None]) * s + carry[:, c - 1]
        carry[:, c - 1] = s

    du, ddelta, pre = (np.empty_like(u) for _ in range(3))
    dB, dC = np.empty_like(B), np.empty_like(C)
    dA_part = np.zeros((bsz, nchunks, d, n), F32)
    dD_part = np.zeros((bsz, nchunks, d), F32)
    db_part = np.zeros((bsz, nchunks, d), F32)
    for c in range(nchunks):  # (c) the output walk from each chunk's carry
        if c == nchunks - 1:
            s = np.zeros((bsz, d, n), F32) if g_hlast is None else g_hlast
        else:
            s = carry[:, c]
        steps = chunk_steps(c)
        for seg in reversed(range(steps.start // k1.SEGMENT, -(-steps.stop // k1.SEGMENT))):
            t0, t1 = seg * k1.SEGMENT, min(L, (seg + 1) * k1.SEGMENT)
            h, hprev = ckpt[:, seg], []
            for t in range(t0, t1):  # rebuild the pre-update states
                hprev.append(h)
                h = np.exp(dt[:, t, :, None] * A) * h + du_t[:, t, :, None] * B[:, t, None, :]
            for t in reversed(range(t0, t1)):
                hp = hprev[t - t0]
                a = np.exp(dt[:, t, :, None] * A)
                hn = a * hp + du_t[:, t, :, None] * B[:, t, None, :]
                dh = C[:, t, None, :] * g2[:, t, :, None] + s
                s = a * dh
                daa = dh * hp * a
                dA_part[:, c] += daa * dt[:, t, :, None]
                sB = (dh * B[:, t, None, :]).sum(-1)
                ddelta[:, t] = (daa * A).sum(-1) + u[:, t] * sB
                if softplus:
                    ddelta[:, t] *= F32(1) - np.exp(-dt[:, t])
                du[:, t] = dt[:, t] * sB + g2[:, t] * dskip
                dB[:, t] = (dh * du_t[:, t, :, None]).sum(1)
                dC[:, t] = (hn * g2[:, t, :, None]).sum(1)
                pre[:, t] = (hn * C[:, t, None, :]).sum(-1) + u[:, t] * dskip
                dD_part[:, c] += g2[:, t] * u[:, t]
                db_part[:, c] += ddelta[:, t]
        if c == 0:
            dh0 = s
    dA, dD, dbias = dA_part[0, 0] * 0, dD_part[0, 0] * 0, db_part[0, 0] * 0
    for b in range(bsz):  # the batch-sum launch: rows (b, chunk) in order
        for c in range(nchunks):
            dA, dD, dbias = dA + dA_part[b, c], dD + dD_part[b, c], dbias + db_part[b, c]
    dz = None if z is None else pre * gz
    dD = None if D is None else dD
    dbias = None if delta_bias is None else dbias
    return (du, ddelta, dA, dB, dC, dD, dz, dbias, dh0), (carry, dtsum)


def sequential64(p, ckpt, g, g_hlast, softplus=True):
    """The port's sequential reverse walk (``scan_bwd_core``) in float64 on
    the same inputs and checkpoints, gradients in NAMES order (dD and dbias
    None where their primal is)."""
    w = {k: None if v is None else torch.from_numpy(v.astype(np.float64))
         for k, v in dict(p, ckpt=ckpt, g=g, g_hlast=g_hlast).items()}
    dt = w["delta"] + w["delta_bias"] if w["delta_bias"] is not None else w["delta"]
    dt = k1.softplus(dt) if softplus else dt
    du, ddelta, dz, dB, dC, dA, dD, dbias, dh0 = k1.scan_bwd_core(
        w["u"], dt, w["A"], w["B"], w["C"], w["D"], w["z"], w["g"], w["ckpt"], w["g_hlast"],
        softplus)
    dD = None if w["D"] is None else dD
    dbias = None if w["delta_bias"] is None else dbias
    got = (du, ddelta, dA, dB, dC, dD, dz, dbias, dh0)
    assert all(v is None or v.dtype == torch.float64 for v in got)
    return dict(zip(NAMES, got))


# name: (batch, L, d, n, the channel count whose chunk the wrapper picks, z, g_hlast)
CASES = {
    "base_clip": (1, 1569, 16, 16, 1536, True, True),     # chunks of 32, the last of 1
    "small_clip": (1, 1569, 16, 8, 768, True, True),      # chunks of 16, the last of 1
    "base_b4": (4, 1569, 8, 8, 1536, True, True),         # chunks of 64, the last of 33
    "small_chunk": (1, 785, 16, 16, 768, True, False),    # chunks of 16, the last of 1
    "ragged_n24": (2, 37, 32, 24, 32, True, True),        # chunks of 16, a last one of 5
    "no_z_no_hlast": (2, 100, 24, 16, 1536, False, False),  # chunks of 16, the last of 4
    "one_short_chunk": (2, 10, 32, 8, 32, True, True),    # L shorter than one chunk
}


def check_split_walk_bwd(p, g, g_hlast, bsz, L, d, n, d_rule, softplus=True):
    """The split reverse walk against the float64 sequential walk, the
    port's plain K5 and jax.vjp of the JAX package's sequential oracle."""
    t = {k: None if v is None else torch.from_numpy(v) for k, v in p.items()}
    _, _, ckpt = k1.selective_scan_plain(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], t["z"], t["delta_bias"], t["h0"],
        softplus_delta=softplus, checkpoints=True)
    chunk = k1.walk_bwd_chunk(bsz, L, d_rule)
    assert chunk % k1.SEGMENT == 0 and chunk <= 64
    operands = [p[k] for k in ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")]
    operands += [ckpt.numpy(), g, g_hlast]
    got, (carry, dtsum) = split_walk_bwd(*operands, chunk, softplus=softplus)
    stored = -(-L // chunk) - 1
    assert carry.shape == (bsz, stored, d, n) and dtsum.shape == (bsz, stored, d)
    exact, _ = split_walk_bwd(*(None if v is None else v.astype(np.float64) for v in operands),
                              chunk, softplus=softplus)
    exact = dict(zip(NAMES, exact))
    mine = dict(zip(NAMES, got))
    seq = sequential64(p, operands[8], g, g_hlast, softplus)
    for name in NAMES:
        assert (exact[name] is None) == (seq[name] is None), name
        if seq[name] is not None:
            err = rel_err(exact[name], seq[name])
            assert err <= EXACT_TOL, (name, err)
            err = rel_err(mine[name], seq[name])
            assert err <= TOL, (name, err)

    def close(name, ref):
        """Within 1e-6 of ``ref`` beyond ref's own distance from the float64
        walk, which is itself held to REF_TOL."""
        err, own = rel_err(mine[name], ref), rel_err(ref, seq[name])
        assert own <= REF_TOL, (name, own)
        assert err <= TOL + own, (name, err, own)

    plain = k1.selective_scan_bwd_plain(
        *(t[k] for k in ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")), ckpt,
        torch.from_numpy(g), None if g_hlast is None else torch.from_numpy(g_hlast), softplus)
    for name, b in zip(NAMES, plain):
        assert (mine[name] is None) == (b is None), name
        if b is not None:
            close(name, b)

    keys = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias", "h0")
    j = {k: jnp.asarray(p[k]) for k in keys if p[k] is not None}

    def fwd(*args):
        kw = dict(zip([k for k in keys if p[k] is not None], args))
        return selective_scan_bld(
            kw["u"], kw["delta"], kw["A"], kw["B"], kw["C"], D=kw.get("D"), z=kw.get("z"),
            delta_bias=kw.get("delta_bias"), delta_softplus=softplus, initial_state=kw["h0"],
            return_last_state=True, method="ref")

    (_, h_last), vjp = jax.vjp(fwd, *j.values())
    jgrads = dict(zip(j, vjp((jnp.asarray(g), jnp.zeros_like(h_last) if g_hlast is None
                              else jnp.asarray(g_hlast)))))
    for name, key in (("du", "u"), ("ddelta", "delta"), ("dA", "A"), ("dB", "B"), ("dC", "C"),
                      ("dD", "D"), ("dz", "z"), ("dbias", "delta_bias"), ("dh0", "h0")):
        if key in jgrads:
            close(name, np.asarray(jgrads[key]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_walk_bwd_matches_the_sequential_walks(case):
    bsz, L, d, n, d_rule, with_z, with_hlast = CASES[case]
    p, g, g_hlast = scan_inputs(sorted(CASES).index(case), bsz, L, d, n, with_z, with_hlast)
    check_split_walk_bwd(p, g, g_hlast, bsz, L, d, n, d_rule)


# K5's operand variants: (softplus, with D, with z, with delta_bias, g_hlast),
# each at a K5 geometry (batch, L, d, n, the channel count whose chunk the
# wrapper picks).
K5_CASES = {
    "raw_dt": (False, True, True, True, True, (2, 100, 24, 16, 1536)),
    "no_skip_no_bias": (True, False, True, False, True, (1, 785, 16, 8, 768)),
    "bare": (False, False, False, False, False, (2, 37, 32, 8, 32)),
    "bare_b4": (False, False, False, False, True, (4, 1569, 8, 8, 1536)),
    "no_gate_no_bias": (True, True, False, False, True, (1, 1569, 16, 16, 1536)),
}


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_split_walk_bwd_takes_k5_contract(case):
    """The reverse walk without the gate, softplus, D skip or delta bias
    (K5's ``full=False`` contract), held as the mixers' case is."""
    softplus, with_d, with_z, with_bias, with_hlast, geom = K5_CASES[case]
    bsz, L, d, n, d_rule = geom
    p, g, g_hlast = scan_inputs(50 + sorted(K5_CASES).index(case), bsz, L, d, n, with_z,
                                with_hlast, softplus=softplus, with_d=with_d,
                                with_bias=with_bias)
    check_split_walk_bwd(p, g, g_hlast, bsz, L, d, n, d_rule, softplus=softplus)


@pytest.mark.parametrize("batch,chunk,nchunks", [(1, 32, 50), (4, 64, 25), (2, 64, 25)])
def test_k5_scratch_at_base(batch, chunk, nchunks):
    """K5 at VideoMamba-Base widths (L 1569, Di 1536, N 16) takes the
    mixer backward's chunk rule: a carry and a dt sum per chunk but the
    first, a dA, dD and dbias partial row per (batch, chunk)."""
    got, carry, dtsum, dA_part, dD_part, db_part = k1.walk_bwd_scratch(batch, 1569, 1536, 16,
                                                                       "cpu")
    assert got == chunk == k1.walk_bwd_chunk(batch, 1569, 1536)
    assert tuple(carry.shape) == (batch, nchunks - 1, 1536, 16)
    assert tuple(dtsum.shape) == (batch, nchunks - 1, 1536)
    assert tuple(dA_part.shape) == (batch, nchunks, 1536, 16)
    assert tuple(dD_part.shape) == tuple(db_part.shape) == (batch, nchunks, 1536)


@pytest.mark.parametrize("seqlen", [1569, 785, 784])
def test_walk_bwd_chunk_fills_an_h100_at_base_batch_1(seqlen):
    """Base training (d_inner 1536, batch 1): the chunk-cotangent launch
    holds at least 1056 blocks, eight a streaming multiprocessor of an H100
    (at least one is the issue's floor, 132), where the serial walk ran 24;
    a thread walks at most 64 steps in series."""
    chunk = k1.walk_bwd_chunk(1, seqlen, 1536)
    assert chunk % k1.SEGMENT == 0 and chunk <= 64
    chunks = -(-seqlen // chunk)
    groups = -(-1536 // k1.WALK_BWD_CHANNELS)
    assert (chunks - 1) * groups >= 1056 and chunks * groups >= 1056


@pytest.mark.parametrize("batch,seqlen,d,want", [
    (4, 1569, 1536, 64),   # a Base train step: 24 x 96 blocks at the longest chunk
    (1, 1569, 1536, 32),   # batch 1: 49 x 24
    (2, 1569, 768, 32),    # Small at batch 2: 49 x 24
    (1, 1569, 768, 16),    # Small at batch 1: 98 x 12
    (1, 5, 1536, 16),      # shorter than a segment: one chunk of 16
    (1, 20000, 1536, 64),  # a long clip never walks more than 64 steps in series
])
def test_walk_bwd_chunk_at_other_shapes(batch, seqlen, d, want):
    assert k1.walk_bwd_chunk(batch, seqlen, d) == want
