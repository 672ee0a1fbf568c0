"""The schedule of the persistent decode stacks (K9, K15) on the CPU.

``decode_plan`` is what the CUDA kernels run: the batch tile, each phase's
row slices over the grid, x_proj's pieces of K, the warps' split of each
product and the shared-memory layout. Here it is checked for every preset
and batch (every row owned once, everything within one block's 227 KB, every
phase on at least 132 blocks at Base B=1), its gate against the JAX
package's, and its reduction order, written out in numpy, against the plain
versions (fp32, 1e-6). Then ``DecodeSession``'s buffers: states loaded in
place, a wrong shape refused at ``load_streaming_state``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from videomamba_tpu.ops.pallas.decode_step import decode_stack_m2_supported as jax_m2_gate
from videomamba_tpu.ops.pallas.decode_step import decode_stack_supported as jax_gate
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
from videomamba_tpu_torch.ops.kernels import decode_step as k9
from videomamba_tpu_torch.runtime import DecodeSession

GRID = k9.REF_SMS
M1_PRESETS = {name: (e, 2 * e, -(-e // 16), 16)
              for name, e in (("tiny", 192), ("small", 384), ("middle", 576), ("base", 768))}
M2_PRESETS = {name: (e, 2 * e, 2 * e // 64, 64)  # headdim 64, d_state 64, one group
              for name, e in (("tiny", 192), ("small", 384), ("middle", 576), ("base", 768))}


def m1_plan(batch, e, di, r, n, w_bytes=4, s_bytes=4, grid=GRID):
    return k9.decode_plan(batch, e, di, w_bytes, grid, dt_rank=r, d_state=n, s_bytes=s_bytes)


def m2_plan(batch, e, di, h, n, w_bytes=4, grid=GRID):
    return k9.decode_plan(batch, e, di, w_bytes, grid, d_proj=2 * di + 2 * n + h, nheads=h,
                          d_state=n)


def assert_covers(units, grid):
    """Every unit owned by exactly one block."""
    owned = np.zeros(units, np.int64)
    for j in range(grid):
        lo, hi = k9.block_span(units, grid, j)
        assert 0 <= lo <= hi <= units
        owned[lo:hi] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("family", ["m1", "m2"])
@pytest.mark.parametrize("preset", ["tiny", "small", "middle", "base"])
@pytest.mark.parametrize("w_bytes", [4, 2])
def test_plan_covers_every_row_and_fits_shared_memory(family, preset, w_bytes):
    """B = 1 .. 256: each phase's units split over the grid once, whole
    slices held (no pieces at preset widths), the layout inside 227 KB and
    16-byte aligned, the batch tile one of the kernel's."""
    for batch in range(1, 257):
        if family == "m1":
            e, di, r, n = M1_PRESETS[preset]
            plan = m1_plan(batch, e, di, r, n, w_bytes)
            rows = {"in": 2 * di, "out": e}
        else:
            e, di, h, n = M2_PRESETS[preset]
            plan = m2_plan(batch, e, di, h, n, w_bytes)
            rows = {"in": 2 * di + 2 * n + h, "out": e}
        assert plan is not None, (batch, preset)
        assert plan["smem"] <= k9.SMEM_BYTES
        assert plan["bt"] in k9.BATCH_TILES and (plan["bt"] >= min(batch, 8) or batch > 16)
        for key in ("wtot", "off_act", "off_red", "off_res", "off_misc", "off_bar"):
            assert plan[key] % 16 == 0, key
        assert plan["off_act"] >= plan["wtot"] and plan["off_bar"] + 8 <= plan["smem"]
        for units in plan["units"].values():
            assert_covers(units, GRID)
        assert plan["units"]["in"] == rows["in"] and plan["units"]["out"] == rows["out"]
        assert plan["in_cap"] == -(-rows["in"] // GRID)
        assert plan["out_cap"] == -(-rows["out"] // GRID)
        assert plan["phases"] == (3 if family == "m2" else 4)
        if family == "m1":
            kp, kw = plan["xp_kp"], plan["xp_kw"]
            assert kw % 8 == 0 and (kp - 1) * kw < di <= kp * kw  # K pieces cover K once
            assert plan["lda"] >= kp * -(-(r + 2 * n) // 4) * 4
        pairs = list(plan["slice_bytes"].values())
        assert plan["wtot"] >= max(a + b for a, b in zip(pairs, pairs[1:] + pairs[:1]))


def test_base_batch_one_runs_every_phase_on_every_sm():
    """At Base B=1 no phase runs on fewer blocks than an H100 has SMs."""
    e, di, r, n = M1_PRESETS["base"]
    for w_bytes in (4, 2):
        units = m1_plan(1, e, di, r, n, w_bytes)["units"]
        assert set(units) == {"in", "x_proj", "state", "out"}
        assert min(units.values()) >= GRID, units
        e2, di2, h, n2 = M2_PRESETS["base"]
        units = m2_plan(1, e2, di2, h, n2, w_bytes)["units"]
        assert set(units) == {"in", "state", "out"}
        assert min(units.values()) >= GRID, units


def test_plan_layout_matches_the_kernel_sources():
    """The C side reads decode_plan's ints into ``struct Plan`` as they
    stand: its fields in PLAN_FIELDS' order, and the pads, batch tiles
    (the launch switches' template cases) and phases a layer the plan
    assumes."""
    csrc = Path(k9.__file__).resolve().parents[2] / "csrc"
    src = (csrc / "decode_step.cu").read_text()
    hdr = (csrc / "decode_persist.cuh").read_text()
    fields = []
    for line in re.search(r"struct Plan \{(.*?)\n\};", src, re.S).group(1).splitlines():
        decl = line.split("//")[0].strip()
        if decl:
            assert decl.startswith("int ") and decl.endswith(";"), decl
            fields += [f.strip() for f in decl[4:-1].split(",")]
    assert tuple(fields) == k9.PLAN_FIELDS

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const(src, "kPlanInts") == len(k9.PLAN_FIELDS)
    assert const(hdr, "kRowPad") == k9.ROW_PAD
    assert const(hdr, "kActPad") == k9.ACT_PAD
    for switch in ("k9_bt", "k15_bt"):
        cases = re.search(switch + r"\(.*?\{(.*?)default:", src, re.S).group(1)
        assert sorted(int(c) for c in re.findall(r"case (\d+):", cases)) == \
            sorted(k9.BATCH_TILES), switch
    phases = [int(p) for p in re.findall(r"constexpr int kPhases = (\d+);", src)]
    assert phases == [k9.PHASES_PER_LAYER, k9.PHASES_PER_LAYER_M2]


WIDTHS = [60, 64, 100, 128, 192, 384, 576, 768, 1000, 1024, 1536, 2048]


def test_gate_takes_every_shape_the_jax_kernel_takes():
    """K9's gate against the JAX package's decode_stack_supported over a grid
    of (d_model, d_inner, dt_rank, d_state): every shape JAX takes the port
    takes too, widths that are not multiples of 8 included (the launch pads
    them to 16-byte rows with zero lanes)."""
    taken = odd = 0
    for e in WIDTHS:
        for di in sorted({e, 2 * e, 4 * e, 1000, 3072}):
            for r in sorted({-(-e // 16), 48, 64}):
                for n in (8, 16, 32):
                    if not jax_gate(e, di, r, n):
                        continue
                    assert k9.decode_stack_supported(e, di, r, n), (e, di, r, n)
                    taken += 1
                    odd += bool(e % 8 or di % 8)
    assert taken > 100 and odd > 10


def test_m2_gate_takes_every_shape_the_jax_kernel_takes():
    """K15's gate against the JAX package's decode_stack_m2_supported over
    (d_model, d_inner, nheads, ngroups, d_state): the same, d_model not a
    multiple of 8 included."""
    taken = odd = 0
    for e in WIDTHS:
        for di in sorted({128, 2 * e, 4 * e, 1152, 3072}):
            for h in (1, 2, 4, 8, 24, 48):
                if di % h:
                    continue
                for g in (1, 2):
                    for n in (16, 64, 128):
                        if not jax_m2_gate(e, di, h, g, n):
                            continue
                        assert k9.decode_stack_m2_supported(e, di, h, g, n), (e, di, h, g, n)
                        taken += 1
                        odd += bool(e % 8)
    assert taken > 50 and odd > 5


# ---------------------------------------------------------------- the order

def rms_or_layer(x, w, b, rms, eps=1e-5):
    if rms:
        inv = 1 / np.sqrt((x * x).mean(-1, keepdims=True) + eps)
        return (x * inv * w).astype(np.float32)
    mean = x.mean(-1, keepdims=True)
    inv = 1 / np.sqrt(((x - mean) ** 2).mean(-1, keepdims=True) + eps)
    return ((x - mean) * inv * w + b).astype(np.float32)


def block_rows(act, w, lo, hi, rb, rw):
    """The kernel's sums for weight rows [lo, hi): K split over 8 / rb
    warps in 4-column groups, each split's partial sum, then the splits
    added in order."""
    k = w.shape[1]
    wk = 8 // rb
    n4 = k // 4
    out = np.zeros((act.shape[0], hi - lo), np.float32)
    for s in range(wk):
        c0, c1 = 4 * (n4 * s // wk), 4 * (n4 * (s + 1) // wk)
        out += act[:, c0:c1] @ w[lo:hi, c0:c1].T
    return out


def product(act, w, plan, rb, rw):
    """A product phase: rows split over the grid, batch tiles of plan['bt']."""
    out = np.zeros((act.shape[0], w.shape[0]), np.float32)
    for b0 in range(0, act.shape[0], plan["bt"]):
        tile = act[b0:b0 + plan["bt"]]
        for j in range(plan["grid"]):
            lo, hi = k9.block_span(w.shape[0], plan["grid"], j)
            if hi > lo:
                out[b0:b0 + plan["bt"], lo:hi] = block_rows(tile, w, lo, hi, rb, rw)
    return out


def conv_step(window, x_raw, cw, cb):
    """The rolling conv and SiLU, taps oldest first, x_raw last; the window rolled."""
    width = cw.shape[1]
    acc = window[..., 1] * cw[:, 0] if width > 1 else x_raw * cw[:, 0]
    for w in range(1, width):
        acc = acc + (x_raw if w == width - 1 else window[..., w + 1]) * cw[:, w]
    c = acc + cb
    return c / (1 + np.exp(-c)), np.concatenate([window[..., 1:], x_raw[..., None]], -1)


def softplus(x):
    return np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))


def k9_in_order(tok, p, conv, ssm, plan, rms):
    """K9 as the kernel orders its sums: R_0 = token, R_{k+1} = out_k + R_k;
    in_proj and out_proj by block_rows, x_proj in xp_kp pieces of K added in
    piece order."""
    depth, two_di, _ = p["in_proj_w"].shape
    di = two_di // 2
    r = p["dt_proj_w"].shape[2]
    n = p["A"].shape[2]
    kw = plan["xp_kw"]
    pieces = [(q * kw, min(di, (q + 1) * kw)) for q in range(plan["xp_kp"])]
    resid, conv, ssm = tok.astype(np.float32), conv.copy(), ssm.copy()
    for k in range(depth):
        normed = rms_or_layer(resid, p["norm_w"][k], None if p["norm_b"] is None
                              else p["norm_b"][k], rms)
        xz = product(normed, p["in_proj_w"][k], plan, plan["in_rb"], plan["in_rw"])
        x, conv[k] = conv_step(conv[k], xz[:, :di], p["conv_w"][k], p["conv_b"][k])
        x_dbl = np.zeros((tok.shape[0], r + 2 * n), np.float32)
        for c0, c1 in pieces:
            x_dbl += x[:, c0:c1] @ p["x_proj_w"][k][:, c0:c1].T
        dt = softplus(x_dbl[:, :r] @ p["dt_proj_w"][k].T + p["dt_bias"][k])
        ssm[k] = (np.exp(dt[..., None] * p["A"][k]) * ssm[k]
                  + (dt * x)[..., None] * x_dbl[:, None, r:r + n])
        z = xz[:, di:]
        y = ((ssm[k] * x_dbl[:, None, r + n:]).sum(-1) + p["D"][k] * x) * (z / (1 + np.exp(-z)))
        out = product(y.astype(np.float32), p["out_proj_w"][k], plan, plan["out_rb"],
                      plan["out_rw"])
        if k == depth - 1:
            return out, resid, conv, ssm
        resid = (out + resid).astype(np.float32)


def k15_in_order(tok, p, conv, ssm, plan, rms, gate_eps=1e-5):
    """K15 as the kernel orders its sums: R_k as for K9, in_proj and out_proj
    by block_rows, the state a row of N at a time."""
    depth, e, di = p["out_proj_w"].shape
    _, b, h, hd, n = ssm.shape
    cd = di + 2 * n
    resid, conv, ssm = tok.astype(np.float32), conv.copy(), ssm.copy()
    for k in range(depth):
        normed = rms_or_layer(resid, p["norm_w"][k], None if p["norm_b"] is None
                              else p["norm_b"][k], rms)
        zxbcdt = product(normed, p["in_proj_w"][k], plan, plan["in_rb"], plan["in_rw"])
        z, dt_raw = zxbcdt[:, :di], zxbcdt[:, di + cd:]
        xbc, conv[k] = conv_step(conv[k], zxbcdt[:, di:di + cd], p["conv_w"][k], p["conv_b"][k])
        x = xbc[:, :di].reshape(b, h, hd)
        bm, cm = xbc[:, di:di + n], xbc[:, di + n:]
        dt = softplus(dt_raw + p["dt_bias"][k])
        ssm[k] = (np.exp(dt * p["A"][k])[:, :, None, None] * ssm[k]
                  + (dt[:, :, None] * x)[..., None] * bm[:, None, None, :])
        y = (ssm[k] * cm[:, None, None, :]).sum(-1) + p["D"][k][:, None] * x
        gated = y.reshape(b, di) * (z / (1 + np.exp(-z)))
        gated = gated / np.sqrt((gated * gated).mean(-1, keepdims=True) + gate_eps) * p["gate_w"][k]
        out = product(gated.astype(np.float32), p["out_proj_w"][k], plan, plan["out_rb"],
                      plan["out_rw"])
        if k == depth - 1:
            return out, resid, conv, ssm
        resid = (out + resid).astype(np.float32)


def k9_operands(rng, depth, b, e, di, r, n, w, rms):
    f = np.float32

    def rn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f)

    p = dict(norm_w=1 + rn(depth, e, scale=0.1), norm_b=None if rms else rn(depth, e, scale=0.1),
             in_proj_w=rn(depth, 2 * di, e, scale=e ** -0.5),
             out_proj_w=rn(depth, e, di, scale=di ** -0.5), conv_w=rn(depth, di, w, scale=0.5),
             conv_b=rn(depth, di, scale=0.1), x_proj_w=rn(depth, r + 2 * n, di, scale=di ** -0.5),
             dt_proj_w=rn(depth, di, r, scale=r ** -0.5),
             dt_bias=np.tile(np.linspace(-4, -1, di, dtype=f), (depth, 1)),
             A=-np.exp(rn(depth, di, n, scale=0.3)), D=rn(depth, di))
    return p, rn(depth, b, di, w), rn(depth, b, di, n, scale=0.3)


@pytest.mark.parametrize("batch", [1, 7, 9, 17])
@pytest.mark.parametrize("rms", [True, False])
def test_k9_reduction_order_matches_plain(batch, rms):
    """Three tokens through the kernel's order (numpy, fp32) and through
    decode_stack_plain from the same states: features, residual and both
    state stacks within 1e-6."""
    rng = np.random.default_rng(batch)
    depth, e, di, r, n, w = 3, 64, 256, 8, 16, 4
    p, conv, ssm = k9_operands(rng, depth, batch, e, di, r, n, w, rms)
    plan = m1_plan(batch, e, di, r, n, grid=16)
    # K split in x_proj (pieces to 16 rows, finer row units above) and
    # within a block's products
    assert (plan["xp_kp"] > 1) == (batch <= 16) and plan["out_rb"] * plan["in_rb"] < 64
    tp = {k: None if v is None else torch.from_numpy(v) for k, v in p.items()}
    tc, ts = torch.from_numpy(conv), torch.from_numpy(ssm)
    for step in range(3):
        tok = rng.standard_normal((batch, e)).astype(np.float32)
        got = k9_in_order(tok, p, conv, ssm, plan, rms)
        want = k9.decode_stack_plain(torch.from_numpy(tok), **tp, conv_states=tc, ssm_states=ts,
                                     norm_type="rms" if rms else "layer")
        for a, ref in zip(got, want):
            ref = ref.numpy()
            assert np.abs(a - ref).max() <= 1e-6 * max(np.abs(ref).max(), 1e-8), step
        _, _, conv, ssm = got
        tc, ts = want[2], want[3]


@pytest.mark.parametrize("batch", [1, 7, 9, 17])
def test_k15_reduction_order_matches_plain(batch):
    """The same for K15 (decode_stack_m2_plain), one B/C group, gated norm."""
    rng = np.random.default_rng(100 + batch)
    f = np.float32
    depth, e, h, hd, n, w = 3, 64, 4, 32, 16, 4
    di = h * hd
    cd = di + 2 * n

    def rn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f)

    p = dict(norm_w=1 + rn(depth, e, scale=0.1), norm_b=None,
             in_proj_w=rn(depth, di + cd + h, e, scale=e ** -0.5),
             out_proj_w=rn(depth, e, di, scale=di ** -0.5), conv_w=rn(depth, cd, w, scale=0.5),
             conv_b=rn(depth, cd, scale=0.1), A=-np.exp(rn(depth, h, scale=0.5)), D=rn(depth, h),
             dt_bias=np.tile(np.linspace(-4, -1, h, dtype=f), (depth, 1)),
             gate_w=1 + rn(depth, di, scale=0.1))
    conv, ssm = rn(depth, batch, cd, w), rn(depth, batch, h, hd, n, scale=0.3)
    plan = m2_plan(batch, e, di, h, n, grid=16)
    tp = {k: None if v is None else torch.from_numpy(v) for k, v in p.items()}
    tc, ts = torch.from_numpy(conv), torch.from_numpy(ssm)
    for step in range(3):
        tok = rng.standard_normal((batch, e)).astype(f)
        got = k15_in_order(tok, p, conv, ssm, plan, rms=True)
        want = k9.decode_stack_m2_plain(torch.from_numpy(tok), **tp, conv_states=tc,
                                        ssm_states=ts)
        for a, ref in zip(got, want):
            ref = ref.numpy()
            assert np.abs(a - ref).max() <= 1e-6 * max(np.abs(ref).max(), 1e-8), step
        _, _, conv, ssm = got
        tc, ts = want[2], want[3]


# ------------------------------------------------------- the session's buffers

def small_model(**kw):
    return PretrainVideoMamba(img_size=16, patch_size=8, depth=2, embed_dim=64, num_frames=4,
                              pool_type="avg", device="cpu",
                              generator=torch.Generator().manual_seed(0), **kw).eval()


@pytest.mark.parametrize("ssm_cfg", [None, {"layer": "Mamba2", "d_state": 16, "headdim": 32,
                                            "chunk_size": 8}])
def test_session_loads_state_in_place_and_refuses_wrong_shapes(ssm_cfg):
    """load_streaming_state copies into the session's own state tensors (the
    buffers a prepared kernel launch holds), so the next step reads the new
    state; another batch size replaces them; any other shape raises there."""
    model = small_model(**({} if ssm_cfg is None else {"ssm_cfg": ssm_cfg}))
    session = DecodeSession(model, batch_size=2)
    assert session.use_kernel
    conv, ssm = session.conv_states, session.ssm_states
    with torch.no_grad():
        _, state = model.forward_features(torch.randn(2, 3, 2, 16, 16,
                                                      generator=torch.Generator().manual_seed(1)),
                                          ssm_state=model.allocate_state(2))
    session.load_streaming_state(state)
    assert session.conv_states is conv and session.ssm_states is ssm
    assert torch.equal(ssm, torch.stack([s[1] for s in state]).to(ssm.dtype))
    fresh = DecodeSession(model, batch_size=2)
    tok = torch.randn(2, 64, generator=torch.Generator().manual_seed(2))
    assert not torch.allclose(session.step(tok), fresh.step(tok))  # the step read the state
    bad = [(c[:, :-1], s) for c, s in state]
    with pytest.raises(ValueError, match="load_streaming_state"):
        session.load_streaming_state(bad)
    with pytest.raises(ValueError, match="load_streaming_state"):
        session.load_streaming_state(state[:1])
    wide = [(torch.cat([c, c, c]), torch.cat([s, s, s])) for c, s in state]
    session.load_streaming_state(wide)
    assert session.batch_size == 6 and session.ssm_states.shape[1] == 6
    assert session.step(torch.randn(6, 64)).shape == (6, 64)
