"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA card. On the GPU machine,
run them without the JAX test harness (this file imports no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Shapes here are deliberately ragged (L not a multiple of the time tile, D
not a multiple of the channel block, strided views), plus the Base shapes
chip_smoke.py checks. TF32 off, rel_err = max|a - b| / max|b|: <= 1e-5 at
fp32 (sums reordered, no TF32), <= 1e-2 at bf16 (a reordered fp32 sum can
flip a bf16 rounding by one ulp, 2^-8 of the largest element).
"""

import pytest
import torch

from videomamba_tpu_torch.ops.kernels import block_fused as k4
from videomamba_tpu_torch.ops.kernels import fused_add_norm as k2
from videomamba_tpu_torch.ops.kernels import mixer_bwd as k6
from videomamba_tpu_torch.ops.kernels import mixer_fused as k3
from videomamba_tpu_torch.ops.kernels import scan as k1

pytestmark = pytest.mark.cuda
TOL = 1e-5
BF16_TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-8))


def randn(*shape, dev, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g)).to(dev)


@pytest.mark.parametrize("n", list(k1.STATE_SIZES))
@pytest.mark.parametrize("full", [True, False])
def test_scan_kernel_matches_plain(dev, n, full):
    """K1 on the time-split walk at every built state size, with and
    without the gate, softplus, D and the delta bias; twice bit-identical."""
    b, L, d = 2, 37, 200
    u = randn(b, L, d, dev=dev, seed=1)
    delta = randn(b, L, d, dev=dev, scale=0.5, seed=2)
    A = -torch.exp(randn(d, n, dev=dev, scale=0.3, seed=3))
    xdbl = randn(b, L, 5 + 2 * n, dev=dev, seed=4)  # B, C as strided views
    Bm, Cm = xdbl[..., 5:5 + n], xdbl[..., 5 + n:]
    D = randn(d, dev=dev, seed=5) if full else None
    z = randn(b, L, 2 * d, dev=dev, seed=6)[..., d:] if full else None
    bias = randn(d, dev=dev, seed=7) if full else None
    h0 = randn(b, d, n, dev=dev, scale=0.2, seed=8)
    before = k1.selective_scan.launches
    y, h = k1.selective_scan(u, delta, A, Bm, Cm, D, z, bias, h0, softplus_delta=full)
    y2, h2 = k1.selective_scan(u, delta, A, Bm, Cm, D, z, bias, h0, softplus_delta=full)
    torch.cuda.synchronize()
    assert k1.selective_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    py, ph = k1.selective_scan_plain(u, delta, A, Bm, Cm, D, z, bias, h0, full)
    assert rel_err(y, py) <= TOL and rel_err(h, ph) <= TOL


def _scan_operands(dev, dtype, b, L, d, n, with_d=True, with_z=True, with_bias=True,
                   softplus=True):
    u = randn(b, L, d, dev=dev, seed=1).to(dtype)
    delta = randn(b, L, d, dev=dev, scale=0.5, seed=2)
    if not softplus:  # a positive step, as the callers pass it
        delta = torch.nn.functional.softplus(delta - 1.0)
    A = -torch.exp(randn(d, n, dev=dev, scale=0.3, seed=3))
    xdbl = randn(b, L, 5 + 2 * n, dev=dev, seed=4).to(dtype)
    return dict(u=u, delta=delta.to(dtype), A=A, B=xdbl[..., 5:5 + n], C=xdbl[..., 5 + n:],
                D=randn(d, dev=dev, seed=5) if with_d else None,
                z=randn(b, L, d, dev=dev, seed=6).to(dtype) if with_z else None,
                delta_bias=randn(d, dev=dev, scale=0.2, seed=7).abs() if with_bias else None,
                h0=randn(b, d, n, dev=dev, scale=0.2, seed=8))


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("full", [True, False])
def test_scan_kernel_at_batch_4_and_each_walk_chunk(dev, monkeypatch, chunk, dtype, full):
    """K1 at batch 4 and L 300 (no multiple of any chunk) with the split
    walk's chunk fixed at each length the rule picks from: y, h_last and the
    checkpoints against the plain version, twice bit-identical."""
    monkeypatch.setattr(k1, "walk_chunk", lambda *_: chunk)
    kw = _scan_operands(dev, dtype, 4, 300, 200, 16, full, full, full, full)
    _same_twice_and_plain(k1.selective_scan, k1.selective_scan_plain,
                          dict(kw, softplus_delta=full, checkpoints=True),
                          TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_at_base_batch_4(dev, dtype):
    """K1 at VideoMamba-Base widths, batch 4 (the split walk's chunks of
    128), with checkpoints, against the plain version; twice bit-identical."""
    kw = _scan_operands(dev, dtype, 4, 1569, 1536, 16)
    _same_twice_and_plain(k1.selective_scan, k1.selective_scan_plain,
                          dict(kw, checkpoints=True), TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("d", [128, 200, 768])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
@pytest.mark.parametrize("prenorm,with_res", [(True, True), (True, False), (False, True)])
def test_fused_add_norm_kernel_matches_plain(dev, d, norm_type, prenorm, with_res):
    x = randn(3, 41, d, dev=dev, seed=1)
    res = randn(3, 41, d, dev=dev, seed=2) if with_res else None
    w = 1 + randn(d, dev=dev, scale=0.1, seed=3)
    bias = randn(d, dev=dev, scale=0.1, seed=4) if norm_type == "layer" else None
    kw = dict(residual=res, prenorm=prenorm, residual_in_fp32=True, norm_type=norm_type)
    out = k2.fused_add_norm(x, w, bias, **kw)
    ref = k2.fused_add_norm_plain(x, w, bias, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out if prenorm else [out], ref if prenorm else [ref]):
        assert rel_err(a, b) <= TOL


def _mixer_inputs(dev, b=2, L=37, di=256, r=12, n=16, w=4):
    xz = randn(b, L, 2 * di, dev=dev, seed=1)
    return dict(
        x=xz[..., :di], z=xz[..., di:],
        conv_w=randn(di, w, dev=dev, scale=0.5, seed=2),
        conv_b=randn(di, dev=dev, scale=0.1, seed=3),
        x_proj_w=randn(r + 2 * n, di, dev=dev, scale=0.05, seed=4),
        dt_proj_w=randn(di, r, dev=dev, scale=0.3, seed=5),
        dt_bias=torch.linspace(-3, 0, di, device=dev),
        A=-torch.exp(randn(di, n, dev=dev, scale=0.3, seed=6)),
        D=randn(di, dev=dev, seed=7),
        h0=randn(b, di, n, dev=dev, scale=0.2, seed=8),
        conv_state=randn(b, di, w, dev=dev, seed=9),
    )


def _same_twice_and_plain(fn, plain, kw, tol):
    """Two kernel calls bit-identical (no atomics in the split walk), and
    every output (y, h_last and, with checkpoints, each segment-start state)
    against the plain version."""
    out = fn(**kw)
    again = fn(**kw)
    torch.cuda.synchronize()
    ref = plain(**kw)
    assert len(out) == len(ref)
    for a, a2, w in zip(out, again, ref):
        assert torch.equal(a, a2)
        assert a.shape == w.shape and a.dtype == w.dtype and rel_err(a, w) <= tol


# The time-split walk (csrc/scan_walk_split.cuh) at every chunk layout: L
# inside one 16-step segment, one segment exactly, one step over, ragged
# multi-chunk L at narrow width (chunks of 16), and the Base shapes where the
# wrapper takes chunks of 32 (L 785, a last chunk of 17) and 64 (L 1569, a
# last chunk of 33).
MIXER_GEOMS = {
    **{f"L{L}": dict(L=L) for L in (1, 3, 15, 16, 17, 37, 300)},
    "base_785": dict(b=1, L=785, di=1536, r=48),
    "base_1569": dict(b=1, L=1569, di=1536, r=48),
}
MIXER_BF16 = ("x", "z", "conv_w", "conv_b", "x_proj_w", "dt_proj_w")


@pytest.mark.parametrize("checkpoints", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", sorted(MIXER_GEOMS))
def test_mixer_fused_kernel_matches_plain(dev, geom, dtype, checkpoints):
    kw = _mixer_inputs(dev, **MIXER_GEOMS[geom])
    kw = {k: v.to(dtype) if k in MIXER_BF16 else v for k, v in kw.items()}
    before = k3.mixer_fused.launches
    _same_twice_and_plain(k3.mixer_fused, k3.mixer_fused_plain,
                          dict(kw, checkpoints=checkpoints),
                          TOL if dtype == torch.float32 else BF16_TOL)
    assert k3.mixer_fused.launches == before + 2


def test_wrappers_raise_on_what_they_do_not_take(dev):
    kw = _mixer_inputs(dev)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        k3.mixer_fused(**dict(kw, x=kw["x"].half()))
    with pytest.raises(ValueError, match="z must be bf16"):
        k3.mixer_fused(**dict(kw, x=kw["x"].bfloat16()))
    with pytest.raises(ValueError, match="contiguous"):
        k3.mixer_fused(**dict(kw, h0=kw["h0"].transpose(0, 1).contiguous().transpose(0, 1)))
    with pytest.raises(ValueError, match="d_state"):
        k3.mixer_fused(**dict(kw, A=kw["A"][:, :12].contiguous()))
    with pytest.raises(RuntimeError, match="no backward"):
        k3.mixer_fused(**dict(kw, D=kw["D"].clone().requires_grad_()))
    x = randn(4, 64, dev=dev)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        k2.fused_add_norm(x.half(), torch.ones(64, device=dev))
    kw = _block_inputs(dev, torch.bfloat16)
    with pytest.raises(ValueError, match="in_proj_w must be bf16"):
        k4.block_fused(**dict(kw, in_proj_w=kw["in_proj_w"].float()))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        k4.block_fused(**dict(kw, hidden=kw["hidden"].half()))
    with pytest.raises(ValueError, match="h0 must be fp32"):
        k4.block_fused(**dict(kw, h0=kw["h0"].bfloat16()))


@pytest.mark.parametrize("norm_type,res_bf16", [("rms", False), ("layer", True)])
def test_fused_add_norm_bf16_kernel_matches_plain(dev, norm_type, res_bf16):
    """x bf16 (a K4 output) with an fp32 residual (residual_in_fp32), or
    both bf16; at Base shapes."""
    x = randn(1, 1569, 768, dev=dev, seed=1).bfloat16()
    res = randn(1, 1569, 768, dev=dev, seed=2)
    res = res.bfloat16() if res_bf16 else res
    w = 1 + randn(768, dev=dev, scale=0.1, seed=3)
    bias = randn(768, dev=dev, scale=0.1, seed=4) if norm_type == "layer" else None
    for prenorm in (True, False):
        kw = dict(residual=res, prenorm=prenorm, residual_in_fp32=not res_bf16,
                  norm_type=norm_type)
        out = k2.fused_add_norm(x, w, bias, **kw)
        ref = k2.fused_add_norm_plain(x, w, bias, **kw)
        torch.cuda.synchronize()
        for a, b in zip(out if prenorm else [out], ref if prenorm else [ref]):
            assert a.dtype == b.dtype and rel_err(a, b) <= BF16_TOL


def _block_inputs(dev, dtype, b=2, L=37, e=200, di=256, n=16, r=12, w=4,
                  residual_fp32=True):
    g = torch.Generator().manual_seed(5)

    def rn(*shape, scale=1.0, cast=True):
        t = (scale * torch.randn(shape, generator=g)).to(dev)
        return t.to(dtype) if cast else t

    return dict(
        hidden=rn(b, L, e), residual=rn(b, L, e, cast=not residual_fp32),
        norm_w=1 + rn(e, scale=0.1, cast=False), norm_b=None,
        in_proj_w=rn(2 * di, e, scale=e ** -0.5), out_proj_w=rn(e, di, scale=di ** -0.5),
        conv_w=rn(di, w, scale=0.5), conv_b=rn(di, scale=0.1),
        x_proj_w=rn(r + 2 * n, di, scale=di ** -0.5), dt_proj_w=rn(di, r, scale=r ** -0.5),
        dt_bias=torch.linspace(-6.9, -2.3, di, device=dev),
        A=-torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(di, n).contiguous(),
        D=torch.ones(di, device=dev), h0=rn(b, di, n, scale=0.1, cast=False),
        conv_state=rn(b, di, w, cast=False), residual_fp32=residual_fp32,
    )


BASE_WIDTHS = dict(b=1, e=768, di=1536, r=48)
BLOCK_CASES = {
    # name: (dtype, geometry, tolerance)
    "bf16_base": (torch.bfloat16, dict(BASE_WIDTHS, L=1569), BF16_TOL),
    "bf16_base_785": (torch.bfloat16, dict(BASE_WIDTHS, L=785), BF16_TOL),
    "fp32_base_785": (torch.float32, dict(BASE_WIDTHS, L=785), TOL),
    "fp32_small": (torch.float32, dict(b=1, L=1569, e=384, di=768, r=24), TOL),
    "bf16_ragged": (torch.bfloat16, dict(), BF16_TOL),
    "fp32_ragged": (torch.float32, dict(), TOL),
    "bf16_bf16_residual": (torch.bfloat16, dict(L=5, residual_fp32=False), BF16_TOL),
    "fp32_L1": (torch.float32, dict(L=1), TOL),
    "bf16_L15": (torch.bfloat16, dict(L=15), BF16_TOL),
    "fp32_L16": (torch.float32, dict(L=16), TOL),
    "bf16_L17": (torch.bfloat16, dict(L=17), BF16_TOL),
    "fp32_L300": (torch.float32, dict(L=300), TOL),
    # a d_model above 3072 (the add-norm rows opt into more shared memory)
    # and conv widths above 8
    "fp32_e3200": (torch.float32, dict(e=3200), TOL),
    "fp32_w9": (torch.float32, dict(w=9), TOL),
    "bf16_w12": (torch.bfloat16, dict(w=12, L=300), BF16_TOL),
}


@pytest.mark.parametrize("checkpoints", [False, True])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_fused_kernel_matches_plain(dev, case, checkpoints):
    dtype, geom, tol = BLOCK_CASES[case]
    kw = _block_inputs(dev, dtype, **geom)
    before = k4.block_fused.launches
    with torch.inference_mode():
        _same_twice_and_plain(k4.block_fused, k4.block_fused_plain,
                              dict(kw, checkpoints=checkpoints), tol)
    assert k4.block_fused.launches == before + 2


def test_block_fused_layer_norm_matches_plain(dev):
    e = 200
    kw = _block_inputs(dev, torch.bfloat16, e=e)
    kw.update(norm_b=randn(e, dev=dev, scale=0.1, seed=9), norm_type="layer")
    with torch.inference_mode():
        out = k4.block_fused(**kw)
        ref = k4.block_fused_plain(**kw)
    for a, b in zip(out, ref):
        assert rel_err(a, b) <= BF16_TOL


def test_model_kernels_match_plain_path(dev):
    """A small fp32 model (two streams) with kernels on against the same
    weights on the plain path, full clip and two chunks, on the card. At
    these widths every Block takes the whole-block route (K4)."""
    from videomamba_tpu_torch.checkpoint import load_state_dict
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.runtime import StreamingSession

    geom = dict(img_size=32, patch_size=8, depth=3, embed_dim=128, num_frames=4,
                pool_type="avg", device=dev)
    fast = PretrainVideoMamba(**geom, generator=torch.Generator().manual_seed(0)).eval()
    plain = PretrainVideoMamba(**geom, fused_add_norm=False,
                               ssm_cfg={"use_fast_path": False}).eval()
    load_state_dict(plain, fast.state_dict())
    clip = randn(2, 3, 4, 32, 32, dev=dev, seed=11)
    with torch.inference_mode():
        before = (k2.fused_add_norm.launches, k3.mixer_fused.launches,
                  k4.block_fused.launches)
        vis, pool = fast(clip)
        assert (k2.fused_add_norm.launches - before[0],
                k3.mixer_fused.launches - before[1],
                k4.block_fused.launches - before[2]) == (1, 0, 3)
        p_vis, p_pool = plain(clip)
        assert rel_err(vis, p_vis) <= 1e-4 and rel_err(pool, p_pool) <= 1e-4
        session = StreamingSession(fast, batch_size=2)
        a, _ = session.process(clip[:, :, :2])
        b, _ = session.process(clip[:, :, 2:])
    assert rel_err(torch.cat([a, b], dim=1), vis) <= 1e-4


def test_bf16_model_kernels_match_plain_blocks(dev):
    """A small bf16 model on the whole-block route against the same Blocks'
    plain versions on the captured input tokens, and two chunks against the
    full clip; states stay fp32."""
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.runtime import StreamingSession
    from videomamba_tpu_torch.utils.precision import cast_module_for_compute

    model = PretrainVideoMamba(img_size=32, patch_size=8, depth=3, embed_dim=128,
                               num_frames=4, pool_type="avg", device=dev,
                               generator=torch.Generator().manual_seed(0)).eval()
    cast_module_for_compute(model, torch.bfloat16)
    clip = randn(2, 3, 4, 32, 32, dev=dev, seed=11)
    seen = {}

    def keep_tokens(module, args):
        seen.setdefault("tokens", args[0])

    hook = model.layers[0].register_forward_pre_hook(keep_tokens)
    with torch.inference_mode():
        before = (k2.fused_add_norm.launches, k4.block_fused.launches)
        vis, _ = model(clip)
        assert (k2.fused_add_norm.launches - before[0],
                k4.block_fused.launches - before[1]) == (1, 3)
        hook.remove()
        hidden = seen["tokens"]
        residual = torch.zeros_like(hidden, dtype=torch.float32)
        for layer in model.layers:
            mx = layer.mixer
            hidden, residual, _ = k4.block_fused_plain(
                hidden, residual,
                h0=torch.zeros(2, mx.d_inner, mx.d_state, device=dev),
                conv_state=torch.zeros(2, mx.d_inner, mx.d_conv, device=dev),
                **layer.block_fused_weights())
        feats = k2.fused_add_norm_plain(hidden, model.norm.weight, residual=residual,
                                        residual_in_fp32=True)
        assert vis.dtype == torch.bfloat16
        assert rel_err(vis, feats[:, 1:]) <= 2 * BF16_TOL
        session = StreamingSession(model, batch_size=2)
        a, _ = session.process(clip[:, :, :2])
        b, _ = session.process(clip[:, :, 2:])
    assert all(c.dtype == s.dtype == torch.float32 for c, s in session.state)
    assert rel_err(torch.cat([a, b], dim=1), vis) <= BF16_TOL


GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _same(a, b):
    return all(x is None and y is None or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("full", [True, False])
def test_scan_bwd_kernel_matches_plain(dev, dtype, full):
    """K1's checkpoints and K5 at a ragged shape (L 37, D 200), strided B/C,
    twice bit-identical."""
    b, L, d, n = 2, 37, 200, 16
    u = randn(b, L, d, dev=dev, seed=1).to(dtype)
    delta = randn(b, L, d, dev=dev, scale=0.5, seed=2).to(dtype)
    A = -torch.exp(randn(d, n, dev=dev, scale=0.3, seed=3))
    xdbl = randn(b, L, 5 + 2 * n, dev=dev, seed=4).to(dtype)
    Bm, Cm = xdbl[..., 5:5 + n], xdbl[..., 5 + n:]
    D = randn(d, dev=dev, seed=5) if full else None
    z = randn(b, L, d, dev=dev, seed=6).to(dtype) if full else None
    bias = randn(d, dev=dev, scale=0.5, seed=7) if full else None
    h0 = randn(b, d, n, dev=dev, scale=0.2, seed=8)
    y, h, ckpt = k1.selective_scan(u, delta, A, Bm, Cm, D, z, bias, h0, True, checkpoints=True)
    _, _, pckpt = k1.selective_scan_plain(u, delta, A, Bm, Cm, D, z, bias, h0, True,
                                          checkpoints=True)
    assert rel_err(ckpt, pckpt) <= TOL
    g, ghl = randn(b, L, d, dev=dev, seed=9).to(dtype), randn(b, d, n, dev=dev, seed=10)
    args = (u, delta, A, Bm, Cm, D, z, bias, ckpt, g, ghl)
    before = k1.selective_scan_bwd.launches
    got = k1.selective_scan_bwd(*args)
    again = k1.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    assert k1.selective_scan_bwd.launches == before + 2 and _same(got, again)
    for a, w in zip(got, k1.selective_scan_bwd_plain(*args)):
        assert (a is None) == (w is None)
        if a is not None:
            assert a.dtype == w.dtype and rel_err(a, w) <= GRAD_TOL[dtype]


# (with D, with z, with delta_bias, softplus): each operand optional on its own
SCAN_BWD_VARIANTS = [(True, True, True, False), (False, True, True, True),
                     (True, False, True, True), (True, True, False, True),
                     (False, False, False, False), (False, False, False, True),
                     (True, False, False, False), (False, True, False, False)]


@pytest.mark.parametrize("variant", SCAN_BWD_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_kernel_with_each_operand_optional(dev, dtype, variant):
    """K5 with and without D, z and delta_bias, with and without softplus
    (the split reverse walk's kZ and kSoftplus), from K1's checkpoints:
    every gradient against the plain version, two runs bit-identical."""
    with_d, with_z, with_bias, softplus = variant
    kw = _scan_operands(dev, dtype, 2, 300, 200, 16, with_d, with_z, with_bias, softplus)
    *_, ckpt = k1.selective_scan(**kw, softplus_delta=softplus, checkpoints=True)
    args = dict({k: v for k, v in kw.items() if k != "h0"}, ckpt=ckpt,
                g_out=randn(2, 300, 200, dev=dev, seed=9).to(dtype),
                g_hlast=randn(2, 200, 16, dev=dev, seed=10), softplus_delta=softplus)
    before = k1.selective_scan_bwd.launches
    got = k1.selective_scan_bwd(**args)
    again = k1.selective_scan_bwd(**args)
    torch.cuda.synchronize()
    assert k1.selective_scan_bwd.launches == before + 2 and _same(got, again)
    for a, w in zip(got, k1.selective_scan_bwd_plain(**args)):
        assert (a is None) == (w is None)
        if a is not None:
            assert a.dtype == w.dtype and rel_err(a, w) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_kernel_at_batch_4_and_each_reverse_walk_chunk(dev, monkeypatch, dtype, chunk):
    """K5 at batch 4 and L 300 with the split reverse walk's chunk fixed at
    each length the rule picks from, and at Base widths (L 1569, D 1536,
    batch 4) on the rule's own chunk: against the plain version, twice
    bit-identical."""
    for b, L, d in ((4, 300, 200), (4, 1569, 1536)):
        with monkeypatch.context() as m:
            if d == 200:
                m.setattr(k1, "walk_bwd_chunk", lambda *_: chunk)
            kw = _scan_operands(dev, dtype, b, L, d, 16)
            *_, ckpt = k1.selective_scan(**kw, checkpoints=True)
            args = dict({k: v for k, v in kw.items() if k != "h0"}, ckpt=ckpt,
                        g_out=randn(b, L, d, dev=dev, seed=9).to(dtype),
                        g_hlast=randn(b, d, 16, dev=dev, seed=10))
            got, again = k1.selective_scan_bwd(**args), k1.selective_scan_bwd(**args)
            torch.cuda.synchronize()
            assert _same(got, again)
            for a, w in zip(got, k1.selective_scan_bwd_plain(**args)):
                assert a.dtype == w.dtype and rel_err(a, w) <= GRAD_TOL[dtype]
        if chunk != 32:
            break  # Base once


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 37, 300])
def test_mixer_bwd_kernel_matches_plain(dev, dtype, L):
    kw = _mixer_inputs(dev, L=L)
    if dtype == torch.bfloat16:
        kw = {k: v.to(dtype) if k in ("x", "z", "conv_w", "conv_b", "x_proj_w", "dt_proj_w")
              else v for k, v in kw.items()}
    y, h, ckpt = k3.mixer_fused(**kw, checkpoints=True)
    py, ph, pckpt = k3.mixer_fused_plain(**kw, checkpoints=True)
    assert rel_err(y, py) <= (TOL if dtype == torch.float32 else BF16_TOL)
    args = {k: v for k, v in kw.items() if k != "h0"}
    g = randn(*y.shape, dev=dev, seed=12).to(dtype)
    ghl = randn(*h.shape, dev=dev, scale=0.3, seed=13)
    before = k6.mixer_bwd.launches
    got = k6.mixer_bwd(**args, ckpt=ckpt, g_y=g, g_hlast=ghl)
    again = k6.mixer_bwd(**args, ckpt=ckpt, g_y=g, g_hlast=ghl)
    torch.cuda.synchronize()
    assert k6.mixer_bwd.launches == before + 2 and _same(got, again)
    for a, w in zip(got, k6.mixer_bwd_plain(**args, ckpt=ckpt, g_y=g, g_hlast=ghl)):
        assert a.dtype == w.dtype and rel_err(a, w) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixer_and_block_bwd_at_each_reverse_walk_chunk(dev, monkeypatch, dtype, chunk):
    """K6 and K7 with the split reverse walk's chunk fixed at each length
    the rule picks from, at batch 4 and an L (300) that is no multiple of
    it, D 200 (a ragged channel group): against their plain versions, each
    twice bit-identical."""
    from videomamba_tpu_torch.ops.kernels import block_bwd as k7

    monkeypatch.setattr(k1, "walk_bwd_chunk", lambda *_: chunk)
    kw = _mixer_inputs(dev, b=4, L=300, di=200)
    if dtype == torch.bfloat16:
        kw = {k: v.to(dtype) if k in ("x", "z", "conv_w", "conv_b", "x_proj_w", "dt_proj_w")
              else v for k, v in kw.items()}
    *_, ckpt = k3.mixer_fused(**kw, checkpoints=True)
    args = dict({k: v for k, v in kw.items() if k != "h0"}, ckpt=ckpt,
                g_y=randn(4, 300, 200, dev=dev, seed=12).to(dtype),
                g_hlast=randn(4, 200, 16, dev=dev, scale=0.3, seed=13))
    got, again = k6.mixer_bwd(**args), k6.mixer_bwd(**args)
    torch.cuda.synchronize()
    assert _same(got, again)
    for a, w in zip(got, k6.mixer_bwd_plain(**args)):
        assert a.dtype == w.dtype and rel_err(a, w) <= GRAD_TOL[dtype]

    bk = _block_inputs(dev, dtype, b=4, L=300, di=200)
    with torch.inference_mode():
        *_, ckpt = k4.block_fused(**bk, checkpoints=True)
        res_out = bk["hidden"].float() + bk["residual"].float()
        args = dict(res_out=res_out, ckpt=ckpt,
                    **{k: bk[k] for k in ("norm_w", "norm_b", "in_proj_w", "out_proj_w",
                                          "conv_w", "conv_b", "x_proj_w", "dt_proj_w",
                                          "dt_bias", "A", "D", "conv_state")},
                    g_out=randn(*bk["hidden"].shape, dev=dev, seed=12).to(dtype),
                    g_res=randn(*res_out.shape, dev=dev, scale=0.3, seed=13),
                    g_hlast=randn(*bk["h0"].shape, dev=dev, scale=0.3, seed=14))
        got, again = k7.block_bwd(**args), k7.block_bwd(**args)
        torch.cuda.synchronize()
        assert _same(got, again)
        for i, (a, w) in enumerate(zip(got, k7.block_bwd_plain(**args))):
            assert a.dtype == w.dtype and rel_err(a, w) <= GRAD_TOL[dtype], i


@pytest.mark.parametrize("d", [3200, 8192, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
def test_add_norm_kernels_at_wide_rows(dev, d, dtype, norm_type):
    """K2 and K8 at D above 3072: 4 rows a block in more than 48 KB of
    shared memory (K2 at 3200 to 16384), a row in registers over 4 warps
    (K8 at 3200), a streamed row (K8 at 8192 and 16384); against the
    plain versions (fp32 1e-5 / 2e-5, bf16 1e-2 / 2e-2), K8 twice
    bit-identical."""
    x = randn(3, 41, d, dev=dev, seed=1).to(dtype)
    res = randn(3, 41, d, dev=dev, seed=2)
    w = 1 + randn(d, dev=dev, scale=0.1, seed=3)
    bias = randn(d, dev=dev, scale=0.1, seed=4) if norm_type == "layer" else None
    kw = dict(residual=res, prenorm=True, residual_in_fp32=True, norm_type=norm_type)
    before = k2.fused_add_norm.launches, k2.fused_add_norm_bwd.launches
    out = k2.fused_add_norm(x, w, bias, **kw)
    ref = k2.fused_add_norm_plain(x, w, bias, **kw)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and rel_err(a, b) <= tol
    g, gr = randn(3, 41, d, dev=dev, seed=5).to(dtype), randn(3, 41, d, dev=dev, seed=6)
    bkw = dict(prenorm=True, norm_type=norm_type)
    got = k2.fused_add_norm_bwd(x, w, res, g, gr, **bkw)
    again = k2.fused_add_norm_bwd(x, w, res, g, gr, **bkw)
    torch.cuda.synchronize()
    assert (k2.fused_add_norm.launches - before[0],
            k2.fused_add_norm_bwd.launches - before[1]) == (1, 2)
    assert _same(got, again)
    for a, b in zip(got, k2.fused_add_norm_bwd_plain(x, w, res, g, gr, **bkw)):
        assert a.dtype == b.dtype and rel_err(a, b) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("d", [200, 768])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
@pytest.mark.parametrize("x_dtype,res_dtype,prenorm", [
    (torch.float32, torch.float32, True), (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.float32, True), (torch.bfloat16, torch.bfloat16, True)])
def test_add_norm_bwd_kernel_matches_plain(dev, d, norm_type, x_dtype, res_dtype, prenorm):
    x = randn(3, 41, d, dev=dev, seed=1).to(x_dtype)
    res = randn(3, 41, d, dev=dev, seed=2).to(res_dtype)
    w = 1 + randn(d, dev=dev, scale=0.1, seed=3)
    g = randn(3, 41, d, dev=dev, seed=4).to(x_dtype)
    gr = randn(3, 41, d, dev=dev, seed=5).to(res_dtype) if prenorm else None
    kw = dict(prenorm=prenorm, norm_type=norm_type)
    got = k2.fused_add_norm_bwd(x, w, res, g, gr, **kw)
    again = k2.fused_add_norm_bwd(x, w, res, g, gr, **kw)
    torch.cuda.synchronize()
    assert _same(got, again)
    tol = TOL if x_dtype == torch.float32 else BF16_TOL
    for a, b in zip(got, k2.fused_add_norm_bwd_plain(x, w, res, g, gr, **kw)):
        assert a.dtype == b.dtype and rel_err(a, b) <= tol


# K8 row layouts: one warp a row (D <= 768, scalar below the vector), 2-8
# warps a row (1000-6128: four, two and one row groups a block at 1536,
# 3072 and 6128, the last filling 48 KB of shared memory with its
# reduction words), streamed (6144, one row's sums and reduction words
# past 48 KB; 8192, 16384); M from one row to B=4 Base.
NORM_BWD_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                   (torch.bfloat16, torch.bfloat16)]


def _norm_bwd_case(dev, m, d, x_dtype, res_dtype, prenorm, seed=0):
    x = randn(m, d, dev=dev, seed=seed + 1).to(x_dtype)
    res = randn(m, d, dev=dev, seed=seed + 2).to(res_dtype)
    w = 1 + randn(d, dev=dev, scale=0.1, seed=seed + 3)
    g = randn(m, d, dev=dev, seed=seed + 4).to(x_dtype)
    gr = randn(m, d, dev=dev, seed=seed + 5).to(res_dtype) if prenorm else None
    return x, w, res, g, gr


def _norm_bwd_holds(got, again, want, terms=None):
    """Twice bit-identical; each output within its dtype's bar of the plain
    version (fp32 1e-5, bf16 1e-2). ``terms``: the size of the terms dx and
    dresidual are a difference of, where that difference cancels."""
    torch.cuda.synchronize()
    assert _same(got, again)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, i
        tol = TOL if a.dtype == torch.float32 else BF16_TOL
        err = rel_err(a, b)
        if terms is not None and i in (0, 3):
            err = float((a.double() - b.double()).abs().max() / max(b.abs().max(), terms))
        assert err <= tol, (i, err)


def _dr_terms(x, w, res, g, eps=1e-5):
    """max |g w inv|: at D = 1 the RMS gradient g w inv (1 - r^2 inv^2) is
    that term times eps / (r^2 + eps), a total cancellation whose fp32 noise
    (about 1e-3 of it, in both versions) is measured against the term."""
    r = x.float() + res.float()
    inv = torch.rsqrt(r.square().mean(-1, keepdim=True) + eps)
    return float((g.float() * w * inv).abs().max())


@pytest.mark.parametrize("m", [1, 7, 1569, 6276])
@pytest.mark.parametrize("d", [1, 3, 100, 768, 1000, 1536, 3072, 3200, 6128, 6144, 8192,
                               16384])
def test_add_norm_bwd_kernel_at_every_row_layout(dev, d, m):
    """K8 against its plain version at each row layout its plan takes, fp32
    and bf16 x and residual, with and without g_resout, rms and layer (at D
    = 1, dx and dresidual against the size of the terms they cancel)."""
    before = k2.fused_add_norm_bwd.launches
    for x_dtype, res_dtype in NORM_BWD_DTYPES:
        for prenorm in (True, False):
            x, w, res, g, gr = _norm_bwd_case(dev, m, d, x_dtype, res_dtype, prenorm)
            terms = _dr_terms(x, w, res, g) if d == 1 else None
            for norm_type in ("rms", "layer"):
                kw = dict(prenorm=prenorm, norm_type=norm_type)
                got = k2.fused_add_norm_bwd(x, w, res, g, gr, **kw)
                again = k2.fused_add_norm_bwd(x, w, res, g, gr, **kw)
                _norm_bwd_holds(got, again, k2.fused_add_norm_bwd_plain(x, w, res, g, gr, **kw),
                                terms)
    assert k2.fused_add_norm_bwd.launches == before + 2 * 2 * 2 * len(NORM_BWD_DTYPES)


def _offset(t):
    """A contiguous copy of t whose storage starts one element in: its
    pointer is off every vector boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("x_dtype,res_dtype", NORM_BWD_DTYPES)
def test_add_norm_bwd_kernel_on_misaligned_views(dev, x_dtype, res_dtype):
    """Views whose storage offset breaks 16-byte alignment take the
    kernel's one-element vectors (the plan says so) and give the plain
    version's values, twice bit-identical; then the aligned copies."""
    x, w, res, g, gr = _norm_bwd_case(dev, 1569, 768, x_dtype, res_dtype, True, seed=9)
    views = [_offset(t) for t in (x, w, res, g, gr)]
    for t in views:
        assert t.is_contiguous() and t.data_ptr() % 16
    dtypes = [x_dtype, res_dtype, x_dtype, res_dtype]
    assert k2.norm_bwd_plan(1569, 768, dtypes, aligned=False).vec == 1
    for norm_type in ("rms", "layer"):
        kw = dict(prenorm=True, norm_type=norm_type)
        want = k2.fused_add_norm_bwd_plain(x, w, res, g, gr, **kw)
        _norm_bwd_holds(k2.fused_add_norm_bwd(*views, **kw), k2.fused_add_norm_bwd(*views, **kw),
                        want)
        _norm_bwd_holds(k2.fused_add_norm_bwd(x, w, res, g, gr, **kw),
                        k2.fused_add_norm_bwd(x, w, res, g, gr, **kw), want)


@pytest.mark.parametrize("norm_type", ["rms", "layer"])
@pytest.mark.parametrize("m", [7, 1569])
def test_add_norm_bwd_kernel_reads_an_fp32_cotangent_beside_bf16_x(dev, m, norm_type):
    """bf16 x (and residual) with an fp32 g_out: the kernel reads g_out at
    its own dtype, as the plain version does, so the fp32 dweight and dbias
    hold 1e-5 (rounding g to bf16 first missed it by a bf16 rounding)."""
    x, w, res, _, gr = _norm_bwd_case(dev, m, 768, torch.bfloat16, torch.float32, True, seed=4)
    g = randn(m, 768, dev=dev, seed=30)
    kw = dict(prenorm=True, norm_type=norm_type)
    got = k2.fused_add_norm_bwd(x, w, res, g, gr, **kw)
    want = k2.fused_add_norm_bwd_plain(x, w, res, g, gr, **kw)
    _norm_bwd_holds(got, k2.fused_add_norm_bwd(x, w, res, g, gr, **kw), want)
    assert rel_err(got[1], want[1]) <= 1e-5 and rel_err(got[2], want[2]) <= 1e-5


def test_small_model_trains_on_the_kernels(dev):
    """A small fp32 model's train step on the kernels (K2 + K3 forward, K6
    backward) against the same weights on the plain path."""
    from videomamba_tpu_torch.checkpoint import load_state_dict
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.parallel.train_step import make_train_step

    geom = dict(img_size=32, patch_size=8, depth=3, embed_dim=128, num_frames=4,
                pool_type="avg", device=dev)
    fast = PretrainVideoMamba(**geom, generator=torch.Generator().manual_seed(0))
    plain = PretrainVideoMamba(**geom, fused_add_norm=False, ssm_cfg={"use_fast_path": False})
    load_state_dict(plain, fast.state_dict())
    batch = {"video": randn(2, 3, 4, 32, 32, dev=dev, seed=11),
             "target": randn(2, 64, 128, dev=dev, seed=12)}
    before = (k3.mixer_fused.launches, k6.mixer_bwd.launches, k2.fused_add_norm.launches)
    metrics = {}
    for name, model in (("fast", fast), ("plain", plain)):
        metrics[name] = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))(batch)
    assert (k3.mixer_fused.launches - before[0], k6.mixer_bwd.launches - before[1],
            k2.fused_add_norm.launches - before[2]) == (3, 3, 4)
    assert rel_err(metrics["fast"]["loss"], metrics["plain"]["loss"]) <= 1e-5
    for (name, p), q in zip(fast.named_parameters(), plain.parameters()):
        if p.grad is not None:
            assert rel_err(p.grad, q.grad) <= 1e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixer_kernels_at_the_masked_visible_length(dev, dtype):
    """K3 (with and without checkpoints) and K6 at the masked Base step's
    shapes: B=2 and L = 1 + 8 * 49 = 393 visible tokens (a tube mask of
    ratio 0.75 on 8 x 14 x 14), no multiple of any walk chunk; against their
    plain versions, each twice bit-identical."""
    kw = _mixer_inputs(dev, b=2, L=393, di=1536, r=48)
    if dtype == torch.bfloat16:
        kw = {k: v.to(dtype) if k in MIXER_BF16 else v for k, v in kw.items()}
    tol = TOL if dtype == torch.float32 else BF16_TOL
    for checkpoints in (False, True):
        _same_twice_and_plain(k3.mixer_fused, k3.mixer_fused_plain,
                              dict(kw, checkpoints=checkpoints), tol)
    *_, ckpt = k3.mixer_fused(**kw, checkpoints=True)
    args = dict({k: v for k, v in kw.items() if k != "h0"}, ckpt=ckpt,
                g_y=randn(2, 393, 1536, dev=dev, seed=12).to(dtype),
                g_hlast=randn(2, 1536, 16, dev=dev, scale=0.3, seed=13))
    before = k6.mixer_bwd.launches
    got, again = k6.mixer_bwd(**args), k6.mixer_bwd(**args)
    torch.cuda.synchronize()
    assert k6.mixer_bwd.launches == before + 2 and _same(got, again)
    for a, w in zip(got, k6.mixer_bwd_plain(**args)):
        assert a.dtype == w.dtype and rel_err(a, w) <= GRAD_TOL[dtype]


def test_masked_small_model_trains_on_the_kernels(dev):
    """A masked fp32 train step (a tube mask in the batch, the default
    loss) on the kernels: K2 + K3 forward and K6 backward on the visible
    tokens only, against the same weights on the plain path."""
    import numpy as np

    from videomamba_tpu_torch.checkpoint import load_state_dict
    from videomamba_tpu_torch.data.masking import TubeMaskingGenerator
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.parallel.train_step import make_train_step

    geom = dict(img_size=32, patch_size=8, depth=3, embed_dim=128, num_frames=4,
                pool_type="avg", device=dev)
    fast = PretrainVideoMamba(**geom, generator=torch.Generator().manual_seed(0))
    plain = PretrainVideoMamba(**geom, fused_add_norm=False, ssm_cfg={"use_fast_path": False})
    load_state_dict(plain, fast.state_dict())
    mask = TubeMaskingGenerator((4, 4, 4), 0.75)(2, rng=np.random.default_rng(0))
    batch = {"video": randn(2, 3, 4, 32, 32, dev=dev, seed=11),
             "target": randn(2, 16, 128, dev=dev, seed=12), "mask": mask}
    before = (k3.mixer_fused.launches, k6.mixer_bwd.launches, k2.fused_add_norm.launches)
    metrics = {}
    for name, model in (("fast", fast), ("plain", plain)):
        metrics[name] = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))(batch)
    assert (k3.mixer_fused.launches - before[0], k6.mixer_bwd.launches - before[1],
            k2.fused_add_norm.launches - before[2]) == (3, 3, 4)
    assert rel_err(metrics["fast"]["loss"], metrics["plain"]["loss"]) <= 1e-5
    for (name, p), q in zip(fast.named_parameters(), plain.parameters()):
        if p.grad is not None:
            assert rel_err(p.grad, q.grad) <= 1e-4, name


BLOCK_BWD_CASES = {
    # name: (dtype, geometry, norm_type)
    "fp32_ragged_rms": (torch.float32, dict(), "rms"),
    "fp32_ragged_layer": (torch.float32, dict(L=300), "layer"),
    "bf16_ragged_rms": (torch.bfloat16, dict(L=300), "rms"),
    "bf16_bf16_residual": (torch.bfloat16, dict(L=5, residual_fp32=False), "rms"),
    "fp32_one_step": (torch.float32, dict(L=1), "layer"),
    # conv widths above 8 (the conv weight gradient in groups of 8 taps)
    # and a d_model above 3072
    "fp32_w9": (torch.float32, dict(w=9, L=300), "rms"),
    "bf16_w12": (torch.bfloat16, dict(w=12), "layer"),
    "fp32_e3200": (torch.float32, dict(e=3200), "layer"),
    # the add-norm row pass with several row groups of 2 warps a block
    # (E = 1536), and streamed because one row's sums fill 48 KB (E = 6144)
    "fp32_e1536": (torch.float32, dict(e=1536), "rms"),
    "bf16_e6144": (torch.bfloat16, dict(e=6144), "layer"),
}


@pytest.mark.parametrize("case", sorted(BLOCK_BWD_CASES))
def test_block_bwd_kernel_matches_plain(dev, case):
    """K4's checkpoints and K7 against their plain versions, with nonzero h0,
    conv_state and every cotangent; K7 twice bit-identical."""
    from videomamba_tpu_torch.ops.kernels import block_bwd as k7

    dtype, geom, norm_type = BLOCK_BWD_CASES[case]
    kw = _block_inputs(dev, dtype, **geom)
    e = kw["hidden"].shape[-1]
    if norm_type == "layer":
        kw.update(norm_b=randn(e, dev=dev, scale=0.1, seed=9), norm_type="layer")
    with torch.inference_mode():
        *_, ckpt = k4.block_fused(**kw, checkpoints=True)
        *_, pckpt = k4.block_fused_plain(**kw, checkpoints=True)
        # bf16: the products' sums in another order move delta, and so the
        # states, by more than fp32's bar (K3's bf16 checkpoints: the same).
        assert rel_err(ckpt, pckpt) <= (TOL if dtype == torch.float32 else BF16_TOL)
        res_out = kw["hidden"].float() + kw["residual"].float()
        args = dict(res_out=res_out, norm_w=kw["norm_w"], norm_b=kw["norm_b"],
                    in_proj_w=kw["in_proj_w"], out_proj_w=kw["out_proj_w"],
                    conv_w=kw["conv_w"], conv_b=kw["conv_b"], x_proj_w=kw["x_proj_w"],
                    dt_proj_w=kw["dt_proj_w"], dt_bias=kw["dt_bias"], A=kw["A"], D=kw["D"],
                    conv_state=kw["conv_state"], ckpt=ckpt,
                    g_out=randn(*kw["hidden"].shape, dev=dev, seed=12).to(dtype),
                    g_res=randn(*res_out.shape, dev=dev, scale=0.3, seed=13).to(
                        kw["residual"].dtype),
                    g_hlast=randn(*kw["h0"].shape, dev=dev, scale=0.3, seed=14),
                    norm_type=norm_type)
        before = k7.block_bwd.launches
        got = k7.block_bwd(**args)
        again = k7.block_bwd(**args)
        torch.cuda.synchronize()
        assert k7.block_bwd.launches == before + 2 and _same(got, again)
        for i, (a, b) in enumerate(zip(got, k7.block_bwd_plain(**args))):
            assert a.dtype == b.dtype and rel_err(a, b) <= GRAD_TOL[dtype], i


@pytest.mark.parametrize("backend", ["fused", "composite"])
def test_eval_model_backward_runs_k7(dev, monkeypatch, backend):
    """A small fp32 model in eval mode (every Block on the whole-block
    route): a loss on x_vis reaches every parameter through K4 and K7 (or
    the composite recompute with K1 / K5), within 1e-4 of the same weights
    on the plain path."""
    from videomamba_tpu_torch.checkpoint import load_state_dict
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.ops.kernels import block_bwd as k7

    monkeypatch.setenv("VIDEOMAMBA_BLOCK_BWD", backend)
    geom = dict(img_size=32, patch_size=8, depth=3, embed_dim=128, num_frames=4,
                pool_type="avg", add_pool_norm=False, device=dev)
    fast = PretrainVideoMamba(**geom, generator=torch.Generator().manual_seed(0)).eval()
    plain = PretrainVideoMamba(**geom, fused_add_norm=False,
                               ssm_cfg={"use_fast_path": False}).eval()
    load_state_dict(plain, fast.state_dict())
    clip = randn(2, 3, 4, 32, 32, dev=dev, seed=11)
    target = randn(2, 65, 128, dev=dev, seed=12)  # CLS leads x_vis without a pool norm
    before = (k4.block_fused.launches, k7.block_bwd.launches, k1.selective_scan_bwd.launches)
    for model in (fast, plain):
        (model(clip) - target).square().mean().backward()
    torch.cuda.synchronize()
    used = (k4.block_fused.launches - before[0], k7.block_bwd.launches - before[1],
            k1.selective_scan_bwd.launches - before[2])
    assert used == ((3, 3, 0) if backend == "fused" else (3, 0, 3))
    for (name, p), q in zip(fast.named_parameters(), plain.parameters()):
        assert p.grad is not None, name
        assert rel_err(p.grad, q.grad) <= 1e-4, name


def _decode_inputs(dev, wdt, sdt, depth=2, b=3, e=200, di=400, n=16, r=13, w=4, norm="rms"):
    g = torch.Generator().manual_seed(7)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dev)

    return dict(
        token=rn(b, e), norm_w=1 + rn(depth, e, scale=0.1),
        norm_b=rn(depth, e, scale=0.1) if norm == "layer" else None,
        in_proj_w=rn(depth, 2 * di, e, scale=e ** -0.5).to(wdt),
        out_proj_w=rn(depth, e, di, scale=di ** -0.5).to(wdt),
        conv_w=rn(depth, di, w, scale=0.5).to(wdt), conv_b=rn(depth, di, scale=0.1),
        x_proj_w=rn(depth, r + 2 * n, di, scale=di ** -0.5).to(wdt),
        dt_proj_w=rn(depth, di, r, scale=r ** -0.5).to(wdt),
        dt_bias=torch.linspace(-4.0, -1.0, di, device=dev).expand(depth, di).contiguous(),
        A=-torch.exp(rn(depth, di, n, scale=0.3)), D=rn(depth, di),
        conv_states=rn(depth, b, di, w).to(sdt), ssm_states=rn(depth, b, di, n, scale=0.3).to(sdt),
        norm_type=norm,
    )


DECODE_EDGES = (1, 7, 8, 9, 16, 17, 80, 81)  # around the batch tiles (1, 8, 16)
BASE_M1 = dict(e=768, di=1536, n=16, r=48)
ODD_M1 = dict(e=60, di=120, n=16, r=4)  # d_model not a multiple of 8 (the JAX kernel takes it)


@pytest.mark.parametrize("wdt,sdt,b,norm,widths", [
    (torch.float32, torch.float32, 3, "rms", None), (torch.float32, torch.float32, 9, "layer", None),
    (torch.bfloat16, torch.float32, 1, "rms", None), (torch.bfloat16, torch.bfloat16, 3, "layer", None),
    *[(torch.float32, torch.float32, b, "rms", BASE_M1) for b in DECODE_EDGES],
    *[(torch.bfloat16, torch.float32, b, "rms", BASE_M1) for b in DECODE_EDGES],
    *[(torch.bfloat16, torch.bfloat16, b, "layer", BASE_M1) for b in (1, 9, 17, 81)],
    *[(torch.float32, torch.bfloat16, b, "rms", BASE_M1) for b in (8, 16)],
    (torch.float32, torch.float32, 3, "rms", dict(e=1536, di=2048, n=16, r=96)),
    *[(w, torch.float32, b, norm, ODD_M1) for w, b, norm in (
        (torch.float32, 3, "rms"), (torch.float32, 9, "layer"), (torch.bfloat16, 1, "rms"))],
    (torch.float32, torch.float32, 2, "layer", dict(e=44, di=92, n=16, r=3)),
    (torch.bfloat16, torch.bfloat16, 17, "rms", dict(e=44, di=92, n=16, r=3))])
def test_decode_stack_kernel_matches_plain(dev, wdt, sdt, b, norm, widths):
    """Three tokens through K9 and its plain version from the same states:
    features and both state stacks, at ragged widths, at Base widths at the
    batch-tile edges, at widths whose weight slices are taken in pieces
    (d_model 1536, d_inner 2048 at fp32) and at widths that are not
    multiples of 8 (d_model 60, and 44 with d_inner 92: padded with zero
    lanes); a token run twice from the same states gives bit-identical
    results."""
    from videomamba_tpu_torch.ops.kernels import decode_step as k9

    kw = _decode_inputs(dev, wdt, sdt, b=b, norm=norm, **(widths or {}))
    states = (kw.pop("conv_states"), kw.pop("ssm_states"))
    kc, ks = (s.clone() for s in states)
    pc, ps = states
    tol = TOL if wdt == torch.float32 and sdt == torch.float32 else BF16_TOL
    before = k9.decode_stack.launches
    args = {k: v for k, v in kw.items() if k != "token"}
    for step in range(3):
        tok = randn(b, kw["token"].shape[1], dev=dev, seed=20 + step)
        if step == 0:
            c0, s0 = kc.clone(), ks.clone()
            first = [t.clone() for t in k9.decode_stack(tok, **args, conv_states=c0,
                                                         ssm_states=s0)]
        hk, rk, kc, ks = k9.decode_stack(tok, **args, conv_states=kc, ssm_states=ks)
        hp, rp, pc, ps = k9.decode_stack_plain(tok, **args, conv_states=pc, ssm_states=ps)
        torch.cuda.synchronize()
        if step == 0:
            assert all(torch.equal(a, f) for a, f in zip((hk, rk, kc, ks), first))
        for a, ref in ((hk, hp), (rk, rp), (kc, pc), (ks, ps)):
            assert a.dtype == ref.dtype and rel_err(a, ref) <= tol, step
    assert k9.decode_stack.launches == before + 4


@pytest.mark.parametrize("e,b,depth", [(128, 2, 3), (768, 80, 2)])
def test_decode_session_kernel_matches_step_route(dev, e, b, depth):
    """DecodeSession on K9 (+ K2 for the final norm) against the per-layer
    Mamba.step route on the card, after a streaming prefill; at Base width
    a batch of 80 streams (ten of K9's 8-row passes) stays on K9 by
    default."""
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.ops.kernels import decode_step as k9
    from videomamba_tpu_torch.runtime import DecodeSession

    model = PretrainVideoMamba(img_size=32, patch_size=8, depth=depth, embed_dim=e,
                               num_frames=4, pool_type="avg", device=dev,
                               generator=torch.Generator().manual_seed(0)).eval()
    clip = randn(b, 3, 4, 32, 32, dev=dev, seed=11)
    with torch.inference_mode():
        _, _, state = model(clip[:, :, :2], ssm_state=model.allocate_state(b))
    sessions = [DecodeSession(model, batch_size=b, use_kernel=flag) for flag in (None, False)]
    assert sessions[0].use_kernel
    for s in sessions:
        s.load_streaming_state(state)
    before = k9.decode_stack.launches
    for step in range(4):
        tok = randn(b, e, dev=dev, seed=30 + step)
        got, want = (s.step(tok) for s in sessions)
        assert rel_err(got, want) <= 1e-4, step
    assert k9.decode_stack.launches == before + 4
    assert rel_err(sessions[0].ssm_states, sessions[1].ssm_states) <= 1e-4


@pytest.mark.parametrize("e", [60, 50])
def test_decode_session_takes_widths_not_multiples_of_8(dev, e):
    """DecodeSession at d_model 60 (d_inner 120) and 50 (d_inner 100, whose
    states the session keeps as views of its launch's zero-padded storage) stays on K9
    and matches the per-layer Mamba.step route after a streaming prefill,
    features and states."""
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.ops.kernels import decode_step as k9
    from videomamba_tpu_torch.runtime import DecodeSession

    model = PretrainVideoMamba(img_size=32, patch_size=8, depth=2, embed_dim=e, num_frames=4,
                               pool_type="avg", device=dev,
                               generator=torch.Generator().manual_seed(0)).eval()
    clip = randn(3, 3, 4, 32, 32, dev=dev, seed=11)
    with torch.inference_mode():
        _, _, state = model(clip[:, :, :2], ssm_state=model.allocate_state(3))
    sessions = [DecodeSession(model, batch_size=3, use_kernel=flag) for flag in (None, False)]
    assert sessions[0].use_kernel and sessions[0].launch is not None
    for s in sessions:
        s.load_streaming_state(state)
    before = k9.decode_stack.launches
    for step in range(4):
        tok = randn(3, e, dev=dev, seed=30 + step)
        got, want = (s.step(tok) for s in sessions)
        assert got.shape == (3, e) and rel_err(got, want) <= 1e-4, step
    assert k9.decode_stack.launches == before + 4
    for a, b in ((sessions[0].conv_states, sessions[1].conv_states),
                 (sessions[0].ssm_states, sessions[1].ssm_states)):
        assert a.shape == b.shape and rel_err(a, b) <= 1e-4


@pytest.mark.parametrize("m2", [False, True])
def test_decode_session_prepares_once_and_reads_loaded_state(dev, m2, monkeypatch):
    """DecodeSession validates, plans and allocates once (at construction;
    again only when load_streaming_state changes the batch), each step is one
    launch, and a step after load_streaming_state reads the loaded state: the
    session's output equals a fresh session's that loaded the same state."""
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.ops.kernels import decode_step as k9
    from videomamba_tpu_torch.runtime import DecodeSession

    cfg = {"ssm_cfg": {"layer": "Mamba2", "d_state": 16, "headdim": 32, "chunk_size": 8}} \
        if m2 else {}
    model = PretrainVideoMamba(img_size=32, patch_size=8, depth=2, embed_dim=128, num_frames=4,
                               pool_type="avg", device=dev,
                               generator=torch.Generator().manual_seed(0), **cfg).eval()
    name = "prepare_decode_stack_m2" if m2 else "prepare_decode_stack"
    calls = []
    real = getattr(k9, name)
    monkeypatch.setattr(k9, name, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kernel = k9.decode_stack_m2 if m2 else k9.decode_stack
    session = DecodeSession(model, batch_size=2)
    assert session.use_kernel and len(calls) == 1
    before = kernel.launches
    for step in range(3):
        session.step(randn(2, 128, dev=dev, seed=60 + step))
    assert len(calls) == 1 and kernel.launches == before + 3
    with torch.inference_mode():
        _, _, state = model(randn(2, 3, 2, 32, 32, dev=dev, seed=61),
                            ssm_state=model.allocate_state(2))
    session.load_streaming_state(state)
    assert len(calls) == 1
    fresh = DecodeSession(model, batch_size=2)
    fresh.load_streaming_state(state)
    tok = randn(2, 128, dev=dev, seed=62)
    assert torch.equal(session.step(tok), fresh.step(tok))


@pytest.mark.parametrize("m2", [False, True])
def test_decode_session_step_replays_in_a_cuda_graph(dev, m2):
    """A DecodeSession step (K9 or K15, then K2) captured once in a CUDA
    graph and replayed twice, a new token copied in before each replay,
    matches the per-layer route step for step, and an eager step after the
    replays still does: the grid barrier's start value lives on the card,
    so no launch depends on a value the host passed when it was captured."""
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.runtime import DecodeSession

    cfg = {"ssm_cfg": {"layer": "Mamba2", "d_state": 16, "headdim": 32, "chunk_size": 8}} \
        if m2 else {}
    model = PretrainVideoMamba(img_size=32, patch_size=8, depth=2, embed_dim=128, num_frames=4,
                               pool_type="avg", device=dev,
                               generator=torch.Generator().manual_seed(0), **cfg).eval()
    fast, plain = (DecodeSession(model, batch_size=2, use_kernel=flag) for flag in (None, False))
    assert fast.launch is not None
    tok = randn(2, 128, dev=dev, seed=70)
    assert rel_err(fast.step(tok), plain.step(tok)) <= 1e-4  # eager: the kernels are set up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fast.step(tok)
    for step in (1, 2):
        tok.copy_(randn(2, 128, dev=dev, seed=70 + step))
        graph.replay()
        want = plain.step(tok)
        torch.cuda.synchronize()
        assert rel_err(out, want) <= 1e-4, step
    tok = randn(2, 128, dev=dev, seed=73)
    assert rel_err(fast.step(tok), plain.step(tok)) <= 1e-4
    assert rel_err(fast.ssm_states, plain.ssm_states) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,L", [(4, 130), (3, 37), (2, 1), (1, 37), (5, 130), (8, 70),
                                 (9, 130), (9, 9)])
def test_causal_conv_kernel_matches_plain(dev, dtype, w, L):
    from videomamba_tpu_torch.ops.kernels import causal_conv as k10

    x = randn(2, L, 400, dev=dev, seed=1).to(dtype)[..., :200]  # strided: the wrapper copies
    weight = randn(w, 200, dev=dev, scale=0.5, seed=2)
    bias = randn(200, dev=dev, scale=0.1, seed=3)
    state = randn(2, 200, w, dev=dev, seed=4).to(dtype)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    before = k10.causal_conv.launches
    for act, b in (("silu", bias), (None, None)):
        y = k10.causal_conv(x, weight, b, state, act)
        ref = k10.causal_conv_plain(x, weight, b, state, act)
        torch.cuda.synchronize()
        assert y.dtype == ref.dtype == dtype and rel_err(y, ref) <= tol
    assert k10.causal_conv.launches == before + 2


@pytest.mark.parametrize("w", list(range(1, 10)))
@pytest.mark.parametrize("d", [1, 3, 130, 1536])
def test_causal_conv_kernel_at_every_width_and_channel_count(dev, d, w):
    """K10 against its plain version at widths 1-9 (1-4 compiled as such,
    the rest a run-time tap loop), channel counts that take 16-byte vectors
    (1536) and that do not (1, 3, 130), L from 9 to 1569 (none a multiple
    of a tile but 1569's neighbours), fp32 and bf16, with and without SiLU
    and bias; twice bit-identical."""
    from videomamba_tpu_torch.ops.kernels import causal_conv as k10

    for L in (9, 37, 1569):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(2, L, d, dev=dev, seed=w + L).to(dtype)
            weight = randn(w, d, dev=dev, scale=0.5, seed=2)
            bias = randn(d, dev=dev, scale=0.1, seed=3)
            state = randn(2, d, w, dev=dev, seed=4).to(dtype)
            tol = TOL if dtype == torch.float32 else BF16_TOL
            for act, b in (("silu", bias), (None, None)):
                y = k10.causal_conv(x, weight, b, state, act)
                again = k10.causal_conv(x, weight, b, state, act)
                ref = k10.causal_conv_plain(x, weight, b, state, act)
                torch.cuda.synchronize()
                assert torch.equal(y, again)
                assert y.dtype == ref.dtype == dtype and rel_err(y, ref) <= tol, (L, dtype, act)


@pytest.mark.parametrize("w", [4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv_kernel_on_misaligned_views(dev, dtype, w):
    """x, weight and bias as views one element into their storage: the
    plan takes one channel a thread and the kernel gives the plain
    version's values, twice bit-identical."""
    from videomamba_tpu_torch.ops.kernels import causal_conv as k10

    x = _offset(randn(2, 1569, 1536, dev=dev, seed=5).to(dtype))
    weight = _offset(randn(w, 1536, dev=dev, scale=0.5, seed=6))
    bias = _offset(randn(1536, dev=dev, scale=0.1, seed=7))
    state = randn(2, 1536, w, dev=dev, seed=8)
    assert x.data_ptr() % 16 and weight.data_ptr() % 16
    assert k10.causal_conv_plan(2, 1569, 1536, dtype, w, aligned=False).vec == 1
    y = k10.causal_conv(x, weight, bias, state)
    again = k10.causal_conv(x, weight, bias, state)
    ref = k10.causal_conv_plain(x, weight, bias, state)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert rel_err(y, ref) <= (TOL if dtype == torch.float32 else BF16_TOL)


def test_causal_conv_route_takes_width_5(dev):
    """``causal_conv1d(use_kernel=True)`` at width 5 (inside the JAX gate)
    launches K10, forward and backward agree with the plain composition."""
    from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d
    from videomamba_tpu_torch.ops.kernels import causal_conv as k10

    x = randn(2, 24, 128, dev=dev, seed=1).requires_grad_()
    w = randn(5, 128, dev=dev, scale=0.5, seed=2).requires_grad_()
    b = randn(128, dev=dev, scale=0.1, seed=3)
    st = randn(2, 128, 5, dev=dev, seed=4)
    before = k10.causal_conv.launches
    y = causal_conv1d(x, w, b, initial_state=st, use_kernel=True)
    assert k10.causal_conv.launches == before + 1
    ref = causal_conv1d(x, w, b, initial_state=st)
    assert rel_err(y, ref) <= TOL
    gx, gw = torch.autograd.grad(y.square().sum(), (x, w))
    rx, rw = torch.autograd.grad(ref.square().sum(), (x, w))
    assert rel_err(gx, rx) <= TOL and rel_err(gw, rw) <= TOL


# ------------------------------------------- conv widths above 8 (K6, K7, K13)

@pytest.mark.parametrize("w", [9, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixer_bwd_kernel_at_wide_convs(dev, dtype, w):
    """K3's checkpoints and K6 at conv widths 9 and 12 (the conv weight
    gradient in groups of 8 taps): every gradient against the plain
    version, twice bit-identical."""
    kw = _mixer_inputs(dev, L=300, w=w)
    if dtype == torch.bfloat16:
        kw = {k: v.to(dtype) if k in MIXER_BF16 else v for k, v in kw.items()}
    y, h, ckpt = k3.mixer_fused(**kw, checkpoints=True)
    args = dict({k: v for k, v in kw.items() if k != "h0"}, ckpt=ckpt,
                g_y=randn(*y.shape, dev=dev, seed=12).to(dtype),
                g_hlast=randn(*h.shape, dev=dev, scale=0.3, seed=13))
    before = k6.mixer_bwd.launches
    got, again = k6.mixer_bwd(**args), k6.mixer_bwd(**args)
    torch.cuda.synchronize()
    assert k6.mixer_bwd.launches == before + 2 and _same(got, again)
    assert got[2].shape == (256, w) and got[10].shape == (2, 256, w)
    for a, b in zip(got, k6.mixer_bwd_plain(**args)):
        assert a.dtype == b.dtype and rel_err(a, b) <= GRAD_TOL[dtype]


def _layer_grads(layer, x, plain):
    """A loss's gradients through ``layer`` on the card, on its kernels or
    (``plain``) with every wrapper taking its plain version on card
    tensors."""
    from videomamba_tpu_torch.ops import dispatch

    layer.zero_grad()
    saved = dispatch.runs_plain
    if plain:
        dispatch.runs_plain = lambda t: True
    try:
        out = layer(x)
        (out * randn(*out.shape, dev=x.device, seed=21)).sum().backward()
    finally:
        dispatch.runs_plain = saved
    torch.cuda.synchronize()
    return out.detach(), {k: p.grad.clone() for k, p in layer.named_parameters()}


def test_mamba_layer_trains_at_conv_width_9(dev):
    """A Mamba(d_conv=9) layer's train step on the card takes K3 forward and
    K6 backward and matches the same layer on plain versions on the card:
    output 1e-5, every gradient 2e-5."""
    from videomamba_tpu_torch.models.mamba import Mamba

    layer = Mamba(128, d_conv=9, device=dev, generator=torch.Generator().manual_seed(0))
    x = randn(2, 70, 128, dev=dev, seed=17)
    before = k3.mixer_fused.launches, k6.mixer_bwd.launches
    out, grads = _layer_grads(layer, x, plain=False)
    assert (k3.mixer_fused.launches - before[0], k6.mixer_bwd.launches - before[1]) == (1, 1)
    ref, want = _layer_grads(layer, x, plain=True)
    assert rel_err(out, ref) <= TOL
    for k, g in grads.items():
        assert rel_err(g, want[k]) <= GRAD_TOL[torch.float32], k


@pytest.mark.parametrize("w", [9, 12])
def test_ssd_mixer_bwd_kernel_at_wide_convs(dev, w):
    """K13 at conv widths 9 and 12 from K12's checkpointed forward: every
    gradient against the plain version (fp32 2e-5), twice bit-identical."""
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13
    from videomamba_tpu_torch.ops.ssd import _prepare_dt

    b, L, h, p, g, n, q = 2, 250, 8, 32, 2, 16, 64
    kw = _ssd_inputs(dev, torch.float32, b, L, h, p, g, n, q, w=w)
    di, cd = h * p, h * p + 2 * g * n
    dt_p = _prepare_dt(kw["zxbcdt"][..., di + cd:], kw["dt_bias"], True)
    _, _, hins, yd = k12.ssd_mixer_core(
        kw["zxbcdt"], dt_p, kw["A"], kw["conv_weight"], kw["conv_bias"], kw["D"],
        kw["initial_state"], kw["conv_state"], kw["norm_weight"], 1e-5, q, h, p, g, n,
        checkpoints=True)
    args = (kw["zxbcdt"], dt_p, kw["A"], kw["conv_weight"], kw["conv_bias"], kw["D"],
            kw["conv_state"], kw["norm_weight"], 1e-5, hins, yd,
            randn(b, L, di, dev=dev, seed=21), randn(b, h, p, n, dev=dev, seed=22, scale=0.5),
            q, h, p, g, n)
    before = k13.ssd_mixer_bwd.launches
    got, again = k13.ssd_mixer_bwd(*args), k13.ssd_mixer_bwd(*args)
    torch.cuda.synchronize()
    assert k13.ssd_mixer_bwd.launches == before + 2
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))
    assert got[4].shape == (cd, w)
    _close(got, k13.ssd_mixer_bwd_plain(*args), BWD_TOL,
           ("dzx", "ddt", "dA", "dconv_state", "dconv_w", "dconv_b", "dh0", "dD", "dnorm"))


def test_mamba2_layer_trains_at_conv_width_9(dev):
    """A Mamba2(d_conv=9) layer's train step on the card runs K12 with
    checkpoints and K13 and matches the same layer on plain versions on the
    card: output 1e-5, every gradient 2e-5."""
    from videomamba_tpu_torch.models.mamba2 import Mamba2
    from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13

    layer = Mamba2(128, d_state=16, d_conv=9, headdim=32, chunk_size=64, device=dev,
                   generator=torch.Generator().manual_seed(0))
    x = randn(2, 150, 128, dev=dev, seed=18)
    before = k13.ssd_mixer_bwd.launches
    out, grads = _layer_grads(layer, x, plain=False)
    assert k13.ssd_mixer_bwd.launches == before + 1
    ref, want = _layer_grads(layer, x, plain=True)
    assert rel_err(out, ref) <= TOL
    for k, g in grads.items():
        assert rel_err(g, want[k]) <= BWD_TOL, k


# --------------------------------- Mamba-1 at any state size the JAX package takes

@pytest.mark.parametrize("n", [24, 48, 128, 256])
def test_scan_kernels_at_any_state_size(dev, n):
    """K1 (with checkpoints) and K5 at state sizes outside the walks' own
    8/16/32/64: 24 and 48 run on zero lanes up to 32 and 64, 128 on its own
    walk, 256 as two slices of 128 (the JAX package's K1 takes N up to 512);
    against the plain versions, with D, z and the delta bias."""
    b, L, d = 2, 37, 200
    u = randn(b, L, d, dev=dev, seed=1)
    delta = randn(b, L, d, dev=dev, scale=0.5, seed=2)
    A = -torch.exp(randn(d, n, dev=dev, scale=0.3, seed=3))
    xdbl = randn(b, L, 5 + 2 * n, dev=dev, seed=4)
    Bm, Cm = xdbl[..., 5:5 + n], xdbl[..., 5 + n:]
    D, bias = randn(d, dev=dev, seed=5), randn(d, dev=dev, seed=7)
    z = randn(b, L, d, dev=dev, seed=6)
    h0 = randn(b, d, n, dev=dev, scale=0.2, seed=8)
    before = k1.selective_scan.launches, k1.selective_scan_bwd.launches
    got = k1.selective_scan(u, delta, A, Bm, Cm, D, z, bias, h0, True, checkpoints=True)
    want = k1.selective_scan_plain(u, delta, A, Bm, Cm, D, z, bias, h0, True, checkpoints=True)
    for a, w in zip(got, want):
        assert a.shape == w.shape and rel_err(a, w) <= TOL
    args = (u, delta, A, Bm, Cm, D, z, bias, got[2], randn(b, L, d, dev=dev, seed=9),
            randn(b, d, n, dev=dev, seed=10))
    grads = k1.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    slices = -(-n // 128)  # above 128 K5 also reruns K1 per slice for dz
    assert k1.selective_scan.launches - before[0] == (2 * slices if slices > 1 else 1)
    assert k1.selective_scan_bwd.launches - before[1] == slices
    for a, w in zip(grads, k1.selective_scan_bwd_plain(*args)):
        assert a.shape == w.shape and rel_err(a, w) <= GRAD_TOL[torch.float32]


@pytest.mark.parametrize("n", [24, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixer_and_block_kernels_at_any_state_size(dev, n, dtype):
    """K3 and K6, K4 and K7 at d_state 24 (zero lanes up to 32) and 128,
    which the JAX package's fused kernels take: outputs, checkpoints and
    every gradient against the plain versions."""
    from videomamba_tpu_torch.ops.kernels import block_bwd as k7

    kw = _mixer_inputs(dev, n=n)
    if dtype == torch.bfloat16:
        kw = {k: v.to(dtype) if k in ("x", "z", "conv_w", "conv_b", "x_proj_w", "dt_proj_w")
              else v for k, v in kw.items()}
    tol = TOL if dtype == torch.float32 else BF16_TOL
    before = (k3.mixer_fused.launches, k6.mixer_bwd.launches, k4.block_fused.launches,
              k7.block_bwd.launches)
    y, h, ckpt = k3.mixer_fused(**kw, checkpoints=True)
    for a, w in zip((y, h, ckpt), k3.mixer_fused_plain(**kw, checkpoints=True)):
        assert a.shape == w.shape and rel_err(a, w) <= tol
    args = {k: v for k, v in kw.items() if k != "h0"}
    g, ghl = randn(*y.shape, dev=dev, seed=12).to(dtype), randn(*h.shape, dev=dev, seed=13)
    got = k6.mixer_bwd(**args, ckpt=ckpt, g_y=g, g_hlast=ghl)
    for a, w in zip(got, k6.mixer_bwd_plain(**args, ckpt=ckpt, g_y=g, g_hlast=ghl)):
        assert a.shape == w.shape and rel_err(a, w) <= GRAD_TOL[dtype]
    bk = _block_inputs(dev, dtype, n=n)
    with torch.inference_mode():
        out = k4.block_fused(**bk, checkpoints=True)
        ref = k4.block_fused_plain(**bk, checkpoints=True)
        for a, w in zip(out, ref):
            assert a.shape == w.shape and rel_err(a, w) <= tol
        res_out = bk["hidden"].float() + bk["residual"].float()
        bargs = dict(res_out=res_out, norm_w=bk["norm_w"], norm_b=None,
                     in_proj_w=bk["in_proj_w"], out_proj_w=bk["out_proj_w"],
                     conv_w=bk["conv_w"], conv_b=bk["conv_b"], x_proj_w=bk["x_proj_w"],
                     dt_proj_w=bk["dt_proj_w"], dt_bias=bk["dt_bias"], A=bk["A"], D=bk["D"],
                     conv_state=bk["conv_state"], ckpt=out[3],
                     g_out=randn(*bk["hidden"].shape, dev=dev, seed=14).to(dtype),
                     g_res=randn(*res_out.shape, dev=dev, scale=0.3, seed=15),
                     g_hlast=randn(*bk["h0"].shape, dev=dev, scale=0.3, seed=16))
        for a, w in zip(k7.block_bwd(**bargs), k7.block_bwd_plain(**bargs)):
            assert a.shape == w.shape and rel_err(a, w) <= GRAD_TOL[dtype]
    torch.cuda.synchronize()
    assert (k3.mixer_fused.launches - before[0], k6.mixer_bwd.launches - before[1],
            k4.block_fused.launches - before[2], k7.block_bwd.launches - before[3]) == (1, 1, 1, 1)


@pytest.mark.parametrize("d_state", [24, 48, 128])
def test_mamba_layer_trains_on_the_card_at_any_state_size(dev, d_state):
    """Mamba(d_model=128, d_state=...) on the card takes K3 forward and K6
    backward, as the JAX package routes it, and matches the same layer's
    plain versions on the CPU (output 1e-5, gradients 1e-4)."""
    from videomamba_tpu_torch.models.mamba import Mamba

    layer = Mamba(128, d_state=d_state, device=dev, generator=torch.Generator().manual_seed(0))
    cpu = Mamba(128, d_state=d_state, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    assert layer._use_fused_mixer()
    x = randn(2, 37, 128, dev=dev, seed=17)
    before = k3.mixer_fused.launches, k6.mixer_bwd.launches
    out = layer(x)
    out.square().mean().backward()
    torch.cuda.synchronize()
    assert (k3.mixer_fused.launches - before[0], k6.mixer_bwd.launches - before[1]) == (1, 1)
    ref = cpu(x.cpu())
    ref.square().mean().backward()
    assert rel_err(out.cpu(), ref) <= TOL
    for k, p in cpu.named_parameters():
        assert rel_err(layer.get_parameter(k).grad.cpu(), p.grad) <= 1e-4, k


# ---------------------------------------------------------- Mamba-2 (SSD)

def _ssd_inputs(dev, dtype, b, L, h, p, g, n, q, e=128, w=4, norm=True, state=True):
    """K12 / K14 operands: activations and the weights a bf16 model casts
    in ``dtype``; A, D, norm weight, h0 and the window fp32."""
    gen = torch.Generator().manual_seed(5)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    di = h * p
    cd = di + 2 * g * n
    dpj = di + cd + h
    return dict(
        hidden=rn(b, L, e).to(dtype), zxbcdt=rn(b, L, dpj).to(dtype),
        in_proj_w=rn(dpj, e, scale=e ** -0.5).to(dtype),
        out_proj_w=rn(e, di, scale=di ** -0.5).to(dtype),
        conv_weight=rn(cd, w, scale=0.5).to(dtype), conv_bias=rn(cd, scale=0.2).to(dtype),
        A=-torch.exp(rn(h, scale=0.5)), D=rn(h),
        dt_bias=torch.linspace(-4.0, -1.0, h, device=dev).to(dtype),
        initial_state=rn(b, h, p, n, scale=0.3) if state else None,
        conv_state=rn(b, cd, w) if state else None,
        norm_weight=1 + rn(di, scale=0.1) if norm else None,
        cfg=dict(chunk_size=q, nheads=h, hdim=p, ngroups=g, d_state=n),
    )


# The walk's pass over the chunks (csrc/ssd_mixer.cu launch 3) at the
# benchmark cells' chunk counts and widths, each from a nonzero state:
# 4 streams of Base-m2 at L 12,545 (99 chunks), Granite-4.0-H-Micro's
# Mamba-2 layers at an 8,192-token chunk (P 64, N 128, 32 chunks of 256)
# and a pretraining batch of 393 tokens (4 chunks); then its edges: one
# chunk, one chunk past the 8 loads a thread keeps in flight, and one past
# the 256 chunk-end decays a block stages at a time.
SSD_PASS_CASES = {
    "pass_stream64_bf16": (torch.bfloat16, 4, 12545, 24, 64, 1, 64, 128, 768, True, True),
    "pass_doc128k_bf16": (torch.bfloat16, 4, 8192, 64, 64, 1, 128, 256, 2048, True, True),
    "pass_pretrain_bf16": (torch.bfloat16, 64, 393, 24, 64, 1, 64, 128, 768, True, True),
    "pass_one_chunk_fp32": (torch.float32, 2, 100, 8, 32, 1, 16, 128, 128, True, True),
    "pass_nine_chunks_fp32": (torch.float32, 2, 261, 8, 32, 1, 16, 32, 128, True, True),
    "pass_257_chunks_fp32": (torch.float32, 1, 4099, 4, 16, 1, 8, 16, 64, True, True),
}

SSD_CASES = {
    **SSD_PASS_CASES,
    # name: (dtype, b, L, h, p, g, n, q, e, norm, state)
    "base_m2_fp32": (torch.float32, 1, 1569, 24, 64, 1, 64, 128, 768, True, True),
    "base_m2_bf16": (torch.bfloat16, 1, 1569, 24, 64, 1, 64, 128, 768, True, True),
    "ragged_two_groups": (torch.float32, 2, 41, 8, 32, 2, 16, 16, 128, True, True),
    "no_norm_no_state_bf16": (torch.bfloat16, 3, 70, 4, 16, 1, 8, 32, 64, False, False),
    "one_token": (torch.float32, 2, 1, 8, 32, 1, 16, 16, 128, True, True),
    # upstream Mamba-2's chunk 256 and d_state 128 at Base widths, and a
    # chunk that is no multiple of the kernels' 64-row slabs
    "base_chunk256_fp32": (torch.float32, 1, 1569, 24, 64, 1, 64, 256, 768, True, True),
    "base_dstate128_bf16": (torch.bfloat16, 1, 1569, 24, 64, 1, 128, 128, 768, True, True),
    "chunk100_two_groups": (torch.float32, 2, 250, 8, 32, 2, 16, 100, 128, True, True),
    # head dim and d_state 256, which the JAX package's kernels take
    "p256_fp32": (torch.float32, 1, 300, 6, 256, 1, 64, 128, 256, True, True),
    "n256_bf16": (torch.bfloat16, 1, 300, 8, 64, 1, 256, 128, 256, True, True),
    "p256_n256_fp32": (torch.float32, 1, 200, 4, 256, 1, 256, 128, 256, True, True),
    # Base widths with 4 groups (C B^T shared by 6 heads each), Base m2 at
    # B = 4; rows, head dim and in_proj / E widths that are no multiples of
    # the wide fp32 product tile (64 x 64) or of the 64-wide slabs,
    # and an E that is no multiple of 4 (its in_proj takes gemm_nt)
    "base_g4_fp32": (torch.float32, 1, 1569, 24, 64, 4, 64, 128, 768, True, True),
    "base_g4_bf16": (torch.bfloat16, 1, 1569, 24, 64, 4, 64, 128, 768, True, True),
    "base_m2_b4_fp32": (torch.float32, 4, 1569, 24, 64, 1, 64, 128, 768, True, True),
    "base_m2_b4_bf16": (torch.bfloat16, 4, 1569, 24, 64, 1, 64, 128, 768, True, True),
    "ragged_tiles_fp32": (torch.float32, 1, 300, 6, 20, 1, 16, 64, 200, True, True),
    "ragged_tiles_bf16": (torch.bfloat16, 1, 300, 6, 20, 1, 16, 64, 200, True, True),
    "odd_width_fp32": (torch.float32, 2, 77, 4, 12, 2, 8, 24, 130, True, True),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
@pytest.mark.parametrize("kind", ["ssd_mixer", "ssd_pmixer"])
def test_ssd_kernels_match_plain(dev, kind, case):
    """K12 and K14 against their plain versions: the output (the input
    dtype) and h_last (fp32), each launch counted; a second call gives
    bit-identical results."""
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    dtype, b, L, h, p, g, n, q, e, norm, state = SSD_CASES[case]
    kw = _ssd_inputs(dev, dtype, b, L, h, p, g, n, q, e=e, norm=norm, state=state)
    kw.update(kw.pop("cfg"))
    hidden, in_w, out_w = kw.pop("hidden"), kw.pop("in_proj_w"), kw.pop("out_proj_w")
    zxbcdt = kw.pop("zxbcdt")
    if kind == "ssd_mixer":
        fn, plain = k12.ssd_mixer, k12.ssd_mixer_plain
        kw.update(zxbcdt=zxbcdt)
    else:
        fn, plain = k14.ssd_pmixer, k14.ssd_pmixer_plain
        kw.update(hidden=hidden, in_proj_w=in_w, out_proj_w=out_w)
    before = fn.launches
    out, h_last = fn(**kw)
    again = fn(**kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(h_last, again[1])
    ref, ref_h = plain(**kw)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    assert out.dtype == ref.dtype == dtype and h_last.dtype == torch.float32
    assert rel_err(out, ref) <= tol and rel_err(h_last, ref_h) <= tol


def _decode_m2_inputs(dev, wdt, cdt, depth, b, e, h, p, n, w=4, norm="rms", gated=True):
    gen = torch.Generator().manual_seed(9)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    di = h * p
    cd = di + 2 * n
    return dict(
        token=rn(b, e), norm_w=1 + rn(depth, e, scale=0.1),
        norm_b=rn(depth, e, scale=0.1) if norm == "layer" else None,
        in_proj_w=rn(depth, di + cd + h, e, scale=e ** -0.5).to(wdt),
        out_proj_w=rn(depth, e, di, scale=di ** -0.5).to(wdt),
        conv_w=rn(depth, cd, w, scale=0.5).to(wdt), conv_b=rn(depth, cd, scale=0.1),
        A=-torch.exp(rn(depth, h, scale=0.5)), D=rn(depth, h),
        dt_bias=torch.linspace(-4.0, -1.0, h, device=dev).expand(depth, h).contiguous(),
        gate_w=1 + rn(depth, di, scale=0.1) if gated else None,
        conv_states=rn(depth, b, cd, w).to(cdt),
        ssm_states=rn(depth, b, h, p, n, scale=0.3),  # fp32: the Mamba-2 contract
        norm_type=norm,
    )


BASE_M2_WIDTHS = (768, 24, 64, 64)


@pytest.mark.parametrize("wdt,cdt,b,norm,gated,widths", [
    (torch.float32, torch.float32, 1, "rms", True, BASE_M2_WIDTHS),
    (torch.bfloat16, torch.float32, 1, "rms", True, BASE_M2_WIDTHS),
    (torch.float32, torch.float32, 80, "rms", True, BASE_M2_WIDTHS),
    (torch.float32, torch.float32, 9, "layer", False, (128, 8, 32, 16)),
    (torch.bfloat16, torch.bfloat16, 3, "layer", True, (128, 8, 32, 16)),
    *[(torch.float32, torch.float32, b, "rms", True, BASE_M2_WIDTHS)
      for b in DECODE_EDGES if b not in (1, 80)],
    *[(torch.bfloat16, torch.float32, b, "rms", True, BASE_M2_WIDTHS)
      for b in DECODE_EDGES if b != 1],
    *[(torch.bfloat16, torch.bfloat16, b, "rms", True, BASE_M2_WIDTHS) for b in (1, 9, 17, 81)],
    *[(torch.float32, torch.bfloat16, b, "rms", False, BASE_M2_WIDTHS) for b in (8, 16)],
    (torch.float32, torch.float32, 2, "rms", True, (1536, 32, 64, 64)),
    (torch.float32, torch.float32, 3, "rms", True, (100, 8, 16, 16)),
    (torch.bfloat16, torch.float32, 9, "layer", True, (100, 8, 16, 16))])
def test_decode_stack_m2_kernel_matches_plain(dev, wdt, cdt, b, norm, gated, widths):
    """Three tokens through K15 and its plain version from the same states
    (Base m2 widths at the batch-tile edges, d_model 1536 with d_inner
    2048, whose slices are taken in pieces, and d_model 100, not a multiple
    of 8; conv windows fp32 or bf16, SSD states fp32): features and both
    state stacks; a token run twice from the same states gives bit-identical
    results."""
    from videomamba_tpu_torch.ops.kernels import decode_step as k9

    e, h, p, n = widths
    kw = _decode_m2_inputs(dev, wdt, cdt, 2, b, e, h, p, n, norm=norm, gated=gated)
    kw.pop("token")
    states = (kw.pop("conv_states"), kw.pop("ssm_states"))
    kc, ks = (s.clone() for s in states)
    pc, ps = states
    tol = TOL if wdt == torch.float32 and cdt == torch.float32 else BF16_TOL
    before = k9.decode_stack_m2.launches
    for step in range(3):
        tok = randn(b, e, dev=dev, seed=40 + step)
        if step == 0:
            c0, s0 = kc.clone(), ks.clone()
            first = [t.clone() for t in k9.decode_stack_m2(tok, **kw, conv_states=c0,
                                                            ssm_states=s0)]
        hk, rk, kc, ks = k9.decode_stack_m2(tok, **kw, conv_states=kc, ssm_states=ks)
        if step == 0:
            assert all(torch.equal(a, f) for a, f in zip((hk, rk, kc, ks), first))
        hp, rp, pc, ps = k9.decode_stack_m2_plain(tok, **kw, conv_states=pc, ssm_states=ps)
        torch.cuda.synchronize()
        for a, ref in ((hk, hp), (rk, rp), (kc, pc), (ks, ps)):
            assert a.dtype == ref.dtype and rel_err(a, ref) <= tol, step
    assert k9.decode_stack_m2.launches == before + 4


def _m2_model(dev, depth=2):
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba

    return PretrainVideoMamba(
        img_size=32, patch_size=8, depth=depth, embed_dim=128, num_frames=4, pool_type="avg",
        ssm_cfg={"layer": "Mamba2", "d_state": 16, "headdim": 32, "chunk_size": 16},
        device=dev, generator=torch.Generator().manual_seed(0)).eval()


@pytest.mark.parametrize("pmixer", ["1", "0"])
def test_m2_model_card_gradients_match_plain(dev, monkeypatch, pmixer):
    """A backward through an m2 model on the card (training mode, the
    default routes: K14's layer on the "mixer" train route, or K12) runs
    K12 with checkpoints and K13, and every parameter's gradient matches
    the same model's plain versions on the CPU (1e-4)."""
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13

    monkeypatch.setenv("VIDEOMAMBA_SSD_PMIXER", pmixer)
    model = _m2_model(dev).train()
    clip = randn(2, 3, 4, 32, 32, dev=dev, seed=3)
    before = (k12.ssd_mixer.launches, k13.ssd_mixer_bwd.launches)
    x_vis, _ = model(clip)
    target = randn(*x_vis.shape, dev=dev, seed=8)
    (x_vis - target).square().mean().backward()
    torch.cuda.synchronize()
    assert (k12.ssd_mixer.launches - before[0], k13.ssd_mixer_bwd.launches - before[1]) == (2, 2)
    grads = {k: p.grad for k, p in model.named_parameters()}
    cpu = _m2_model("cpu").train()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x_vis, _ = cpu(clip.cpu())
    (x_vis - target.cpu()).square().mean().backward()
    for k, p in cpu.named_parameters():  # the pool norm is off the loss's path
        assert (grads[k] is None) == (p.grad is None), k
        if p.grad is not None:
            assert rel_err(grads[k].cpu(), p.grad) <= 1e-4, k


@pytest.mark.parametrize("pmixer", ["1", "0"])
@pytest.mark.parametrize("chunk,d_state", [(256, 64), (128, 128)])
def test_m2_model_takes_the_kernels_at_upstream_shapes(dev, monkeypatch, pmixer, chunk,
                                                        d_state):
    """Upstream Mamba-2's chunk 256 and d_state 128 run on K14 or K12 on
    the card, within 1e-4 of the plain chunked route on the same weights."""
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    monkeypatch.setenv("VIDEOMAMBA_SSD_PMIXER", pmixer)
    model = PretrainVideoMamba(
        img_size=64, patch_size=8, depth=2, embed_dim=128, num_frames=8, pool_type="avg",
        ssm_cfg={"layer": "Mamba2", "d_state": d_state, "headdim": 64, "chunk_size": chunk},
        device=dev, generator=torch.Generator().manual_seed(0)).eval()
    clip = randn(1, 3, 8, 64, 64, dev=dev, seed=4)  # L = 513: three chunks of 256
    before = (k12.ssd_mixer.launches, k14.ssd_pmixer.launches)
    with torch.no_grad():
        got, _ = model(clip)
        used = (k12.ssd_mixer.launches - before[0], k14.ssd_pmixer.launches - before[1])
        monkeypatch.setenv("VIDEOMAMBA_SSD_METHOD", "chunked")
        want, _ = model(clip)
    assert used == ((0, 2) if pmixer == "1" else (2, 0))
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("headdim,d_state", [(256, 64), (64, 256)])
def test_m2_layer_trains_on_the_card_at_head_dim_and_state_256(dev, headdim, d_state):
    """A Mamba-2 layer at head dim 256 or d_state 256 (which the JAX
    package's kernels take) runs K12 and K13 on the card, forward within
    1e-5 and every gradient within 1e-4 of the same layer's plain versions
    on the CPU."""
    from videomamba_tpu_torch.models.mamba2 import Mamba2
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13

    kw = dict(d_model=256, d_state=d_state, headdim=headdim, chunk_size=128)
    layer = Mamba2(**kw, device=dev, generator=torch.Generator().manual_seed(0))
    cpu = Mamba2(**kw, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    x = randn(2, 300, 256, dev=dev, seed=19)
    before = k12.ssd_mixer.launches, k13.ssd_mixer_bwd.launches
    out = layer(x)
    out.square().mean().backward()
    torch.cuda.synchronize()
    assert (k12.ssd_mixer.launches - before[0], k13.ssd_mixer_bwd.launches - before[1]) == (1, 1)
    ref = cpu(x.cpu())
    ref.square().mean().backward()
    assert rel_err(out.cpu(), ref) <= TOL
    for k, p in cpu.named_parameters():
        assert rel_err(layer.get_parameter(k).grad.cpu(), p.grad) <= 1e-4, k


def test_m2_shape_outside_the_kernel_gate_raises_on_the_card(dev):
    """A head dim the kernels do not take raises on the card; it never
    falls back to a plain version there."""
    from videomamba_tpu_torch.models.mamba2 import Mamba2

    mixer = Mamba2(d_model=60, d_state=16, headdim=30, chunk_size=16, device=dev).eval()
    with torch.no_grad(), pytest.raises(ValueError, match="multiples of 4"):
        mixer(randn(1, 21, 60, dev=dev, seed=6))

@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_m2_decode_session_kernel_matches_step_route(dev, dtype):
    """DecodeSession on K15 (+ K2) against the per-layer Mamba2.step route
    on the card, after a streaming prefill; ``dtype`` sets the conv
    windows' (the SSD states stay fp32)."""
    from videomamba_tpu_torch.ops.kernels import decode_step as k9
    from videomamba_tpu_torch.runtime import DecodeSession

    model = _m2_model(dev, depth=3)
    clip = randn(2, 3, 4, 32, 32, dev=dev, seed=12)
    with torch.inference_mode():
        _, _, state = model(clip[:, :, :2], ssm_state=model.allocate_state(2))
    sessions = [DecodeSession(model, batch_size=2, dtype=dtype, use_kernel=flag)
                for flag in (None, False)]
    assert sessions[0].use_kernel and sessions[0].is_m2
    assert sessions[0].ssm_states.dtype == torch.float32
    # bf16 windows: the kernel convolves the token's own fp32 input, step()
    # its bf16-rounded copy in the window (as the JAX package's two routes).
    tol = 1e-4 if dtype is None else BF16_TOL
    for s in sessions:
        s.load_streaming_state(state)
    before = k9.decode_stack_m2.launches
    for step in range(4):
        tok = randn(2, 128, dev=dev, seed=50 + step)
        got, want = (s.step(tok) for s in sessions)
        assert rel_err(got, want) <= tol, step
    assert k9.decode_stack_m2.launches == before + 4
    assert rel_err(sessions[0].ssm_states, sessions[1].ssm_states) <= tol


# ------------------------------------------- Mamba-2 (SSD) training kernels

BWD_TOL = 2e-5  # the backward kernels' bar against their plain versions
BWD_BF16_TOL = 2e-2

SSD_BWD_CASES = {k: SSD_CASES[k] for k in (
    "base_m2_fp32", "base_m2_bf16", "ragged_two_groups", "no_norm_no_state_bf16",
    "one_token", "base_chunk256_fp32", "base_dstate128_bf16", "chunk100_two_groups",
    "p256_n256_fp32", "base_g4_fp32", "base_g4_bf16", "base_m2_b4_fp32", "base_m2_b4_bf16",
    "ragged_tiles_fp32", "ragged_tiles_bf16", "odd_width_fp32")}


def _close(got, want, tol, names):
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert rel_err(a, b) <= tol, f"{name}: {rel_err(a, b):.3e}"


def _ssd_bwd_setup(dev, case):
    """K12's checkpointed forward on the card and the cotangents, for the
    backward kernels' tests."""
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.ssd import _prepare_dt

    dtype, b, L, h, p, g, n, q, e, norm, state = SSD_CASES[case]
    kw = _ssd_inputs(dev, dtype, b, L, h, p, g, n, q, e=e, norm=norm, state=state)
    cfg = kw.pop("cfg")
    di, cd = h * p, h * p + 2 * g * n
    dt_p = _prepare_dt(kw["zxbcdt"][..., di + cd:], kw["dt_bias"], True)
    core = (kw["A"], kw["conv_weight"], kw["conv_bias"], kw["D"])
    gated, h_last, hins, yd = k12.ssd_mixer_core(
        kw["zxbcdt"], dt_p, *core, kw["initial_state"], kw["conv_state"], kw["norm_weight"],
        1e-5, q, h, p, g, n, checkpoints=True)
    dout = randn(b, L, di, dev=dev, seed=21).to(dtype)
    dhlast = randn(b, h, p, n, dev=dev, seed=22, scale=0.5)
    tol = BWD_TOL if dtype == torch.float32 else BWD_BF16_TOL
    return kw, cfg, dt_p, (gated, h_last, hins, yd), dout, dhlast, tol


@pytest.mark.parametrize("case", sorted(SSD_BWD_CASES) + sorted(SSD_PASS_CASES))
def test_ssd_mixer_checkpoints_match_plain(dev, case):
    """K12's training forward: the output, h_last and its checkpoints (each
    chunk's entry state, the pre-gate y) against the plain version's; a
    second call gives bit-identical results."""
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12

    kw, cfg, dt_p, got, _, _, _ = _ssd_bwd_setup(dev, case)
    args = (kw["zxbcdt"], dt_p, kw["A"], kw["conv_weight"], kw["conv_bias"], kw["D"],
            kw["initial_state"], kw["conv_state"], kw["norm_weight"], 1e-5, cfg["chunk_size"],
            cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"])
    again = k12.ssd_mixer_core(*args, checkpoints=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = k12.ssd_core_plain(*args, checkpoints=True)
    tol = TOL if got[0].dtype == torch.float32 else BF16_TOL
    _close(got, want, tol, ("gated", "h_last", "hins", "yd"))


@pytest.mark.parametrize("case", sorted(SSD_BWD_CASES))
def test_ssd_scan_kernels_match_plain(dev, case):
    """K11, the bare chunk scan: its forward (y, h_last, the chunks' entry
    states) and its backward (dx, ddt, dA, dB, dC, dh0) against their plain
    versions; two backward runs give bit-identical gradients."""
    from videomamba_tpu_torch.ops.kernels import ssd_core as k11

    dtype, b, L, h, p, g, n, q, e, norm, state = SSD_BWD_CASES[case]
    x = randn(b, L, h, p, dev=dev, seed=31).to(dtype)
    Bm = randn(b, L, g, n, dev=dev, seed=32).to(dtype)
    Cm = randn(b, L, g, n, dev=dev, seed=33).to(dtype)
    dt_p = torch.nn.functional.softplus(randn(b, L, h, dev=dev, seed=34) - 3.0)
    A = -torch.exp(randn(h, dev=dev, seed=35, scale=0.5))
    h0 = randn(b, h, p, n, dev=dev, seed=36, scale=0.3) if state else None
    before = k11.ssd_scan.launches, k11.ssd_scan_bwd.launches
    got = k11.ssd_scan(x, dt_p, A, Bm, Cm, h0, q, checkpoints=True)
    want = k11.ssd_scan_plain(x, dt_p, A, Bm, Cm, h0, q, checkpoints=True)
    tol = BWD_TOL if dtype == torch.float32 else BWD_BF16_TOL
    _close(got, want, tol, ("y", "h_last", "hins"))
    dy = randn(b, L, h, p, dev=dev, seed=37)
    dhl = randn(b, h, p, n, dev=dev, seed=38, scale=0.5)
    grads = k11.ssd_scan_bwd(x, dt_p, A, Bm, Cm, want[2], dy, dhl, q)
    again = k11.ssd_scan_bwd(x, dt_p, A, Bm, Cm, want[2], dy, dhl, q)
    torch.cuda.synchronize()
    assert (k11.ssd_scan.launches - before[0], k11.ssd_scan_bwd.launches - before[1]) == (1, 2)
    ref = k11.ssd_scan_bwd_plain(x, dt_p, A, Bm, Cm, want[2], dy, dhl, q)
    _close(grads, ref, tol, ("dx", "ddt", "dA", "dB", "dC", "dh0"))
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.parametrize("case,backend", [(c, "fused") for c in sorted(SSD_BWD_CASES)] + [
    (c, "composite") for c in sorted(SSD_BWD_CASES) if SSD_BWD_CASES[c][0] == torch.float32])
def test_ssd_mixer_bwd_kernel_matches_plain(dev, monkeypatch, case, backend):
    """K13 (or, at fp32, the composite backward around K11's) against K13's
    plain version: dzxbcdt, ddt, dA, the conv window's, taps' and bias'
    gradients, dh0, dD and the norm weight's; K13 twice gives bit-identical
    gradients. (At bf16 the composite backward rounds the conv output, as
    the JAX package's does, so it is held to K13 at fp32 only.)"""
    from videomamba_tpu_torch.ops.kernels import ssd_core as k11
    from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13

    monkeypatch.setenv("VIDEOMAMBA_SSD_BWD", backend)
    kw, cfg, dt_p, (_, _, hins, yd), dout, dhlast, tol = _ssd_bwd_setup(dev, case)
    args = (kw["zxbcdt"], dt_p, kw["A"], kw["conv_weight"], kw["conv_bias"], kw["D"],
            kw["conv_state"], kw["norm_weight"], 1e-5, hins, yd, dout, dhlast,
            cfg["chunk_size"], cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"])
    before = k13.ssd_mixer_bwd.launches, k11.ssd_scan_bwd.launches
    got = k13.mixer_backward(*args)
    torch.cuda.synchronize()
    want = k13.ssd_mixer_bwd_plain(*args)
    names = ("dzx", "ddt", "dA", "dconv_state", "dconv_w", "dconv_b", "dh0", "dD", "dnorm")
    if backend == "composite":
        assert (k13.ssd_mixer_bwd.launches, k11.ssd_scan_bwd.launches) == (before[0],
                                                                          before[1] + 1)
        _close([a.to(b.dtype) if a is not None and b is not None else a
                for a, b in zip(got, want)], want, tol, names)
        return
    assert k13.ssd_mixer_bwd.launches == before[0] + 1
    _close(got, want, tol, names)
    again = k13.ssd_mixer_bwd(*args)
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("case", sorted(SSD_BWD_CASES))
def test_ssd_pmixer_bwd_kernel_matches_plain(dev, case):
    """K14's backward against its plain version from K14's checkpointed
    forward: dhidden, ddt, dA, the conv gradients, dWin (zero dt rows),
    dWout, dh0, dD and the norm weight's gradient."""
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    dtype, b, L, h, p, g, n, q, e, norm, state = SSD_BWD_CASES[case]
    kw = _ssd_inputs(dev, dtype, b, L, h, p, g, n, q, e=e, norm=norm, state=state)
    cfg = kw.pop("cfg")
    dt_p = k14.dt_projection(kw["hidden"], kw["in_proj_w"], h, kw["dt_bias"])
    ws = (kw["in_proj_w"], kw["out_proj_w"], kw["conv_weight"], kw["conv_bias"], kw["D"])
    out, h_last, hins, yd = k14.ssd_pmixer_core(
        kw["hidden"], dt_p, kw["A"], *ws, kw["initial_state"], kw["conv_state"],
        kw["norm_weight"], 1e-5, q, h, p, g, n, checkpoints=True)
    dout = randn(b, L, e, dev=dev, seed=23).to(dtype)
    dhlast = randn(b, h, p, n, dev=dev, seed=24, scale=0.5)
    args = (kw["hidden"], dt_p, kw["A"], *ws[:2], *ws[2:4], kw["D"], kw["conv_state"],
            kw["norm_weight"], 1e-5, hins, yd, dout, dhlast, q, h, p, g, n)
    before = k14.ssd_pmixer_bwd.launches
    got = k14.ssd_pmixer_bwd(*args)
    again = k14.ssd_pmixer_bwd(*args)
    torch.cuda.synchronize()
    assert k14.ssd_pmixer_bwd.launches == before + 2
    want = k14.ssd_pmixer_bwd_plain(*args)
    tol = BWD_TOL if dtype == torch.float32 else BWD_BF16_TOL
    _close(got, want, tol, ("dhidden", "ddt", "dA", "dconv_state", "dWin", "dWout", "dconv_w",
                            "dconv_b", "dh0", "dD", "dnorm"))
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("route", ["mixer", "pmixer"])
def test_m2_train_routes_run_the_kernels(dev, monkeypatch, route):
    """Training an m2 model on the card on each VIDEOMAMBA_SSD_TRAIN_ROUTE:
    "mixer" runs K12 with checkpoints and K13, "pmixer" K14 and its
    backward; the gradients match the CPU model's plain versions (1e-4)."""
    from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
    from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    monkeypatch.setenv("VIDEOMAMBA_SSD_TRAIN_ROUTE", route)
    model = _m2_model(dev).train()
    clip = randn(2, 3, 4, 32, 32, dev=dev, seed=5)
    counters = (k12.ssd_mixer, k13.ssd_mixer_bwd, k14.ssd_pmixer, k14.ssd_pmixer_bwd)
    before = [c.launches for c in counters]
    x_vis, _ = model(clip)
    target = randn(*x_vis.shape, dev=dev, seed=9)
    (x_vis - target).square().mean().backward()
    torch.cuda.synchronize()
    used = tuple(c.launches - b for c, b in zip(counters, before))
    assert used == ((2, 2, 0, 0) if route == "mixer" else (0, 0, 2, 2))
    cpu = _m2_model("cpu").train()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x_vis, _ = cpu(clip.cpu())
    (x_vis - target.cpu()).square().mean().backward()
    for k, p in cpu.named_parameters():  # the pool norm is off the loss's path
        got = model.get_parameter(k).grad
        assert (got is None) == (p.grad is None), k
        if p.grad is not None:
            assert rel_err(got.cpu(), p.grad) <= 1e-4, k


# ------------------------------------ K14's backward product tile (wgmma, TMA)

PRODUCT_CASES = {
    # name: (layout, M, N, K): K14's backward shapes at Base-m2 with ragged
    # B L rows (1, 1569, 6276), and small ragged ones
    "zx_rows1569": ("nt", 1569, 3200, 768),
    "zx_rows1": ("nt", 1, 3200, 768),
    "dgated_rows6276": ("nn", 6276, 1536, 768),
    "dhidden_rows1569": ("nn", 1569, 768, 3200),
    "dwout_rows1569": ("tn", 768, 1536, 1569),
    "dwout_rows6276": ("tn", 768, 1536, 6276),
    "dwin_rows1": ("tn", 3200, 768, 1),
    "ragged_nt": ("nt", 77, 130, 45),
    "ragged_nn": ("nn", 130, 77, 200),
    "ragged_tn": ("tn", 45, 200, 77),
}


def _product_operands(dev, dtype, layout, m, n, k, pad_a=0, pad_b=0, seed=40):
    """a and b of a projection product, rows padded by pad_a / pad_b
    elements (a row stride that TMA cannot describe when it is odd)."""
    sa = (k, m) if layout == "tn" else (m, k)
    sb = (n, k) if layout == "nt" else (k, n)
    a = randn(sa[0], sa[1] + pad_a, dev=dev, seed=seed).to(dtype)[:, :sa[1]]
    b = randn(sb[0], sb[1] + pad_b, dev=dev, seed=seed + 1).to(dtype)[:, :sb[1]]
    x = a.double().t() if layout == "tn" else a.double()
    y = b.double().t() if layout == "nt" else b.double()
    return a, b, x @ y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PRODUCT_CASES))
def test_projection_product_matches_float64(dev, case, dtype):
    """The product tile of K14's backward alone, each layout at each dtype:
    fp32 (three TF32 products) within 2e-5 of a float64 product, bf16 within
    2e-2 (zx is rounded to bf16); two calls bit-identical (the weight
    gradients' contraction slices are summed in a fixed order)."""
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    layout, m, n, k = PRODUCT_CASES[case]
    a, b, want = _product_operands(dev, dtype, layout, m, n, k)
    before = k14.projection_product.launches
    got = k14.projection_product(layout, a, b)
    again = k14.projection_product(layout, a, b)
    torch.cuda.synchronize()
    assert k14.projection_product.launches == before + 2
    assert got.dtype == (dtype if layout == "nt" else torch.float32)
    assert torch.equal(got, again)
    tol = BWD_TOL if dtype == torch.float32 else BWD_BF16_TOL
    assert rel_err(got, want) <= tol
    plain = k14.projection_product_plain(layout, a, b)
    assert rel_err(got, plain.double()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nt", "nn", "tn"])
@pytest.mark.parametrize("pads", [(1, 0), (0, 3), (1, 1)])
def test_projection_product_takes_strides_tma_cannot(dev, layout, dtype, pads):
    """Row strides that are no multiple of 16 bytes (an odd H P at bf16):
    the tile's staging variant, against float64."""
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    a, b, want = _product_operands(dev, dtype, layout, 300, 200, 1569 if layout == "tn" else 77,
                                   *pads)
    got = k14.projection_product(layout, a, b)
    assert torch.equal(got, k14.projection_product(layout, a, b))
    assert rel_err(got, want) <= (BWD_TOL if dtype == torch.float32 else BWD_BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("odd", ["di", "e"])
def test_ssd_pmixer_bwd_at_strides_tma_cannot(dev, dtype, odd):
    """K14's backward where rows are no multiple of 16 bytes: Di = H P = 12
    (bf16: gated, dgated and Wout's rows) or E = 130 (hidden, dout, Win,
    dhidden), against plain. (The SSD kernels take P and N in multiples of
    4, so ZX = 2 Di + 2 G N is a multiple of 8.)"""
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    h, p, g, n, e = (3, 4, 1, 8, 128) if odd == "di" else (4, 8, 1, 8, 130)
    b, L, q = 2, 70, 32
    kw = _ssd_inputs(dev, dtype, b, L, h, p, g, n, q, e=e, norm=True, state=True)
    kw.pop("cfg")
    dt_p = k14.dt_projection(kw["hidden"], kw["in_proj_w"], h, kw["dt_bias"])
    ws = (kw["in_proj_w"], kw["out_proj_w"], kw["conv_weight"], kw["conv_bias"], kw["D"])
    _, _, hins, yd = k14.ssd_pmixer_core(
        kw["hidden"], dt_p, kw["A"], *ws, kw["initial_state"], kw["conv_state"],
        kw["norm_weight"], 1e-5, q, h, p, g, n, checkpoints=True)
    args = (kw["hidden"], dt_p, kw["A"], *ws, kw["conv_state"], kw["norm_weight"], 1e-5, hins,
            yd, randn(b, L, e, dev=dev, seed=25).to(dtype),
            randn(b, h, p, n, dev=dev, seed=26, scale=0.5), q, h, p, g, n)
    got = k14.ssd_pmixer_bwd(*args)
    again = k14.ssd_pmixer_bwd(*args)
    want = k14.ssd_pmixer_bwd_plain(*args)
    _close(got, want, BWD_TOL if dtype == torch.float32 else BWD_BF16_TOL,
           ("dhidden", "ddt", "dA", "dconv_state", "dWin", "dWout", "dconv_w", "dconv_b",
            "dh0", "dD", "dnorm"))
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))


# ------------------------- the serving forward's bf16 projections on wgmma

# (M, N, K, C's dtype): K4's in_proj (fp32 xz) and out_proj, K14's in_proj
# (N = Di + CD) and out_proj at 4 streams of a 64-frame chunk (B L = 4 x
# 12,545 rows), and one stream's rows (ragged against every tile height)
# with each output dtype.
SERVING_PRODUCTS = {
    "k4_in_proj": (50180, 3072, 768, torch.float32),
    "k4_out_proj": (50180, 768, 1536, torch.bfloat16),
    "k14_in_proj": (50180, 3200, 768, torch.bfloat16),
    "k14_out_proj": (50180, 768, 1536, torch.bfloat16),
    "rows12545_fp32": (12545, 3200, 768, torch.float32),
    "rows12545_bf16": (12545, 768, 1536, torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(SERVING_PRODUCTS))
def test_wgmma_nt_product_at_the_serving_shapes(dev, case):
    """The bf16 NT product of the serving forward alone, activations against
    weights scaled as the model's, C in fp32 or bf16: against the plain
    version at the K14 product tests' bf16 bar, two calls bit-identical."""
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    m, n, k, out = SERVING_PRODUCTS[case]
    a = randn(m, k, dev=dev, seed=60).to(torch.bfloat16)
    b = randn(n, k, dev=dev, seed=61, scale=k ** -0.5).to(torch.bfloat16)
    got = k14.projection_product("nt", a, b, out_dtype=out)
    again = k14.projection_product("nt", a, b, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out and torch.equal(got, again)
    want = k14.projection_product_plain("nt", a, b, out_dtype=out)
    assert rel_err(got, want) <= BWD_BF16_TOL


@pytest.mark.parametrize("kind", ["block_fused", "ssd_pmixer"])
def test_serving_forward_at_four_streams_from_a_carried_state(dev, kind):
    """K4 (Base) and K14's forward (Base-m2) at the serving cells' shape, 4
    streams of L 12,545, bf16, from a nonzero carried state (SSM state and
    conv window): every output against the plain version at the bf16 bar
    (1e-2), two calls bit-identical."""
    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    b, L = 4, 12545
    with torch.inference_mode():
        if kind == "block_fused":
            kw = _block_inputs(dev, torch.bfloat16, b=b, L=L, **{
                k: v for k, v in BASE_WIDTHS.items() if k != "b"})
            assert kw["h0"].abs().max() > 0 and kw["conv_state"].abs().max() > 0
            _same_twice_and_plain(k4.block_fused, k4.block_fused_plain, kw, BF16_TOL)
        else:
            kw = _ssd_inputs(dev, torch.bfloat16, b, L, 24, 64, 1, 64, 128, e=768)
            kw.update(kw.pop("cfg"))
            del kw["zxbcdt"]
            _same_twice_and_plain(k14.ssd_pmixer, k14.ssd_pmixer_plain, kw, BF16_TOL)


def test_serving_forward_hands_in_and_out_proj_to_wgmma(dev):
    """Under the profiler: a bf16 K4 call runs in_proj and out_proj on the
    wgmma tile (hg::product_kernel) and only x_proj and dt_proj on the
    mma.sync tile (gemm_nt_bf16_kernel); a bf16 K14 call runs no
    gemm_nt_bf16_kernel. Each counts 2 wgmma_products; fp32 calls count 0."""
    from torch.autograd import DeviceType

    from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

    k4_kw = _block_inputs(dev, torch.bfloat16, b=1, L=300, **{
        k: v for k, v in BASE_WIDTHS.items() if k != "b"})
    m2_kw = _ssd_inputs(dev, torch.bfloat16, 1, 300, 24, 64, 1, 64, 128, e=768)
    m2_kw.update(m2_kw.pop("cfg"))
    del m2_kw["zxbcdt"]

    def kernels(fn, kw):
        with torch.inference_mode():
            fn(**kw)
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            before = fn.wgmma_products
            with torch.profiler.profile(activities=acts) as prof:
                fn(**kw)
                torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        return ({tag: sum(tag in nm for nm in names)
                 for tag in ("gemm_nt_bf16_kernel", "product_kernel")},
                fn.wgmma_products - before)

    assert kernels(k4.block_fused, k4_kw) == (
        {"gemm_nt_bf16_kernel": 2, "product_kernel": 2}, 2)
    assert kernels(k14.ssd_pmixer, m2_kw) == (
        {"gemm_nt_bf16_kernel": 0, "product_kernel": 2}, 2)

    def fp32(kw):
        return {k: v.float() if torch.is_tensor(v) else v for k, v in kw.items()}

    before = k4.block_fused.wgmma_products, k14.ssd_pmixer.wgmma_products
    with torch.inference_mode():
        k4.block_fused(**fp32(k4_kw))
        k14.ssd_pmixer(**fp32(m2_kw))
    assert (k4.block_fused.wgmma_products, k14.ssd_pmixer.wgmma_products) == before


# The distribution slice's shapes: a Base clip of 16 frames (3136 tokens)
# over 4 sequence-parallel ranks (784 a shard; the local scan from a zero
# state, no D, gate or bias, the last state kept), and a Base mixer's
# channels over 2 tensor-parallel ranks (d_inner 1536 / 2).
SHARD_SHAPES = {"sequence_shard": (1, 784, 1536, False), "tp_channels": (2, 1569, 768, True)}


@pytest.mark.parametrize("shape", sorted(SHARD_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_at_the_distributed_shapes(dev, dtype, shape):
    """K1 (with checkpoints) and K5 at a shard's shapes against their plain
    versions, each twice bit-identical."""
    b, L, d, full = SHARD_SHAPES[shape]
    kw = _scan_operands(dev, dtype, b, L, d, 16, full, full, full, full)
    if not full:
        kw["h0"] = torch.zeros_like(kw["h0"])
    tol = TOL if dtype == torch.float32 else BF16_TOL
    _same_twice_and_plain(k1.selective_scan, k1.selective_scan_plain,
                          dict(kw, softplus_delta=full, checkpoints=True), tol)
    *_, ckpt = k1.selective_scan(**kw, softplus_delta=full, checkpoints=True)
    args = dict({k: v for k, v in kw.items() if k != "h0"}, ckpt=ckpt,
                g_out=randn(b, L, d, dev=dev, seed=9).to(dtype),
                g_hlast=randn(b, d, 16, dev=dev, seed=10), softplus_delta=full)
    got = k1.selective_scan_bwd(**args)
    again = k1.selective_scan_bwd(**args)
    torch.cuda.synchronize()
    assert _same(got, again)
    for a, w in zip(got, k1.selective_scan_bwd_plain(**args)):
        assert (a is None) == (w is None)
        if a is not None:
            assert a.dtype == w.dtype and rel_err(a, w) <= GRAD_TOL[dtype]
