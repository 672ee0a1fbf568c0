"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA card. On the GPU machine,
run them without the JAX test harness (this file imports no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Shapes here are deliberately ragged (L not a multiple of the time tile, D
not a multiple of the channel block, strided views). fp32 throughout, TF32
off, rel_err = max|a - b| / max|b| <= 1e-5 (sums reordered, no TF32).
"""

import pytest
import torch

from videomamba_tpu_torch.ops.kernels import fused_add_norm as k2
from videomamba_tpu_torch.ops.kernels import mixer_fused as k3
from videomamba_tpu_torch.ops.kernels import scan as k1

pytestmark = pytest.mark.cuda
TOL = 1e-5


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


@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("full", [True, False])
def test_scan_kernel_matches_plain(dev, n, full):
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
    torch.cuda.synchronize()
    assert k1.selective_scan.launches == before + 1
    py, ph = k1.selective_scan_plain(u, delta, A, Bm, Cm, D, z, bias, h0, full)
    assert rel_err(y, py) <= TOL and rel_err(h, ph) <= TOL


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


@pytest.mark.parametrize("L", [1, 3, 37, 300])
def test_mixer_fused_kernel_matches_plain(dev, L):
    kw = _mixer_inputs(dev, L=L)
    before = k3.mixer_fused.launches
    y, h = k3.mixer_fused(**kw)
    torch.cuda.synchronize()
    assert k3.mixer_fused.launches == before + 1
    py, ph = k3.mixer_fused_plain(**kw)
    assert rel_err(y, py) <= TOL and rel_err(h, ph) <= TOL


def test_wrappers_raise_on_what_they_do_not_take(dev):
    kw = _mixer_inputs(dev)
    with pytest.raises(ValueError, match="fp32"):
        k3.mixer_fused(**dict(kw, x=kw["x"].bfloat16()))
    with pytest.raises(ValueError, match="contiguous"):
        k3.mixer_fused(**dict(kw, h0=kw["h0"].transpose(0, 1).contiguous().transpose(0, 1)))
    with pytest.raises(ValueError, match="d_state"):
        k3.mixer_fused(**dict(kw, A=kw["A"][:, :12].contiguous()))
    with pytest.raises(RuntimeError, match="no backward"):
        k3.mixer_fused(**dict(kw, D=kw["D"].clone().requires_grad_()))
    x = randn(4, 64, dev=dev)
    with pytest.raises(ValueError, match="fp32"):
        k2.fused_add_norm(x.bfloat16(), torch.ones(64, device=dev))


def test_model_kernels_match_plain_path(dev):
    """A small model (two streams) with kernels on against the same weights
    on the plain path, full clip and two chunks, on the card."""
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
        before = (k2.fused_add_norm.launches, k3.mixer_fused.launches)
        vis, pool = fast(clip)
        assert (k2.fused_add_norm.launches - before[0],
                k3.mixer_fused.launches - before[1]) == (4, 3)
        p_vis, p_pool = plain(clip)
        assert rel_err(vis, p_vis) <= 1e-4 and rel_err(pool, p_pool) <= 1e-4
        session = StreamingSession(fast, batch_size=2)
        a, _ = session.process(clip[:, :, :2])
        b, _ = session.process(clip[:, :, 2:])
    assert rel_err(torch.cat([a, b], dim=1), vis) <= 1e-4
