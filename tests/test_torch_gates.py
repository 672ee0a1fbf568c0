"""The port's kernel gates against the JAX package's, on the CPU.

A Hopper gate is never narrower than the JAX package's where the JAX
package runs its kernel. Here each wrapper's own checks run on CPU tensors
with the route forced to the kernel (``dispatch.runs_plain`` patched) and a
stand-in for the built library that records the launch and does nothing:
a wrapper that refuses a shape raises before it reaches the library. Over
conv widths 1 to 16 and row widths D in {3072, 3200, 4096, 8192, 16384}:

- K10 (``causal_conv_supported`` and ``causal_conv1d(use_kernel=True)``)
  against ``pallas_conv_supported(d, seqlen, w)``;
- K2 and K8 (``fused_add_norm``, ``fused_add_norm_bwd``) against
  ``fused_add_norm_supported(d)``;
- the mixer backward K6 and the whole-block backward K7 at every conv width
  where ``mixer_bwd_supported`` takes the layer (it has no width term), and
  K13 at every width where ``pallas_ssd_supported`` takes its shape (no width
  term either).
"""

import numpy as np
import pytest
import torch

from videomamba_tpu.ops.pallas.causal_conv import pallas_conv_supported
from videomamba_tpu.ops.pallas.fused_add_norm import fused_add_norm_supported
from videomamba_tpu.ops.pallas.mixer_bwd import mixer_bwd_supported
from videomamba_tpu.ops.pallas.ssd_scan import pallas_ssd_supported
from videomamba_tpu_torch.ops import dispatch
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from videomamba_tpu_torch.ops.kernels import _build
from videomamba_tpu_torch.ops.kernels import block_bwd as k7
from videomamba_tpu_torch.ops.kernels import causal_conv as k10
from videomamba_tpu_torch.ops.kernels import fused_add_norm as k2
from videomamba_tpu_torch.ops.kernels import mixer_bwd as k6
from videomamba_tpu_torch.ops.kernels import scan as k1
from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12
from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13

CONV_WIDTHS = range(1, 17)
ROW_WIDTHS = (3072, 3200, 4096, 8192, 16384)


class _Library:
    """Every C entry point succeeds without doing anything; the size
    queries ask for one float or one block."""

    def __getattr__(self, name):
        return lambda *args: 1 if name in _build.SIZE_QUERIES else 0


@pytest.fixture
def kernel_route(monkeypatch):
    """Wrappers take their kernel route on CPU tensors, into _Library."""
    monkeypatch.setattr(dispatch, "runs_plain", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: _Library())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


def randn(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("d", (128, 200, 512, *ROW_WIDTHS))
def test_causal_conv_gate_takes_every_jax_shape(d, kernel_route):
    for w in CONV_WIDTHS:
        for seqlen in (w - 1, w, 24):
            if seqlen < 1:
                continue
            port = k10.causal_conv_supported(w, seqlen)
            if pallas_conv_supported(d, seqlen, w):
                assert port, (d, seqlen, w)
            assert port == (seqlen >= w), (d, seqlen, w)
    x = randn(1, 12, d)  # widths above 12 take the plain composition, as in JAX
    for w in CONV_WIDTHS:
        before = k10.causal_conv.launches
        causal_conv1d(x, randn(w, d, seed=w), randn(d, seed=1), use_kernel=True)
        assert k10.causal_conv.launches == before + (1 if w <= 12 else 0), w


@pytest.mark.parametrize("d", ROW_WIDTHS)
def test_norm_gates_take_every_jax_width(d, kernel_route):
    assert fused_add_norm_supported(d)
    x, res, g = randn(1, 3, d, seed=1), randn(1, 3, d, seed=2), randn(1, 3, d, seed=3)
    w = 1 + randn(d, seed=4, scale=0.1)
    before = k2.fused_add_norm.launches, k2.fused_add_norm_bwd.launches
    for norm_type in ("rms", "layer"):
        k2.fused_add_norm(x, w, randn(d, seed=5), residual=res, prenorm=True,
                          norm_type=norm_type)
        k2.fused_add_norm_bwd(x, w, res, g, g, prenorm=True, norm_type=norm_type)
    assert (k2.fused_add_norm.launches - before[0],
            k2.fused_add_norm_bwd.launches - before[1]) == (2, 2)


def mixer_operands(b, L, di, r, n, w):
    return dict(
        x=randn(b, L, di, seed=1), z=randn(b, L, di, seed=2), conv_w=randn(di, w, seed=3),
        conv_b=randn(di, seed=4), x_proj_w=randn(r + 2 * n, di, seed=5),
        dt_proj_w=randn(di, r, seed=6), dt_bias=randn(di, seed=7), A=-randn(di, n, seed=8).abs(),
        D=randn(di, seed=9), conv_state=randn(b, di, w, seed=10),
        ckpt=randn(b, k1.num_segments(L), di, n, seed=11), g_y=randn(b, L, di, seed=12),
        g_hlast=randn(b, di, n, seed=13))


@pytest.mark.parametrize("di,r,n", [(128, 4, 16), (1536, 48, 16), (256, 128, 128)])
def test_mixer_backward_gates_take_every_conv_width(di, r, n, kernel_route):
    """K6 and K7 at conv widths 1 to 16, where the JAX package's mixer
    backward takes the layer; K7 also at d_model 3200."""
    assert mixer_bwd_supported(di, r, n)
    b, L = 1, 40
    for w in CONV_WIDTHS:
        kw = mixer_operands(b, L, di, r, n, w)
        before = k6.mixer_bwd.launches, k7.block_bwd.launches
        k6.mixer_bwd(**kw)
        for e in (64, 3200):
            k7.block_bwd(
                randn(b, L, e, seed=14), 1 + randn(e, seed=15), None, randn(2 * di, e, seed=16),
                randn(e, di, seed=17), kw["conv_w"], kw["conv_b"], kw["x_proj_w"],
                kw["dt_proj_w"], kw["dt_bias"], kw["A"], kw["D"], kw["conv_state"],
                kw["ckpt"], randn(b, L, e, seed=18), randn(b, L, e, seed=19), kw["g_hlast"])
        assert (k6.mixer_bwd.launches - before[0], k7.block_bwd.launches - before[1]) == (1, 2)


@pytest.mark.parametrize("h,p,g,n,q", [(4, 8, 1, 8, 16), (24, 64, 1, 64, 128),
                                       (8, 32, 2, 16, 64)])
def test_ssd_mixer_backward_gate_takes_every_conv_width(h, p, g, n, q, kernel_route,
                                                        monkeypatch):
    """K13 at conv widths 1 to 16 where pallas_ssd_supported takes the
    shape (in interpret mode, the CPU tests' mode, which takes more chunks
    than the TPU): the wrapper goes to the kernel (whose conv weight
    gradient takes any width)."""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    assert pallas_ssd_supported(h, p, g, n, q) and k12.ssd_kernel_supported(h, p, g, n, q)
    b, L = 1, 2 * q + 3
    di, cd = h * p, h * p + 2 * g * n
    nc = -(-L // q)
    for w in CONV_WIDTHS:
        before = k13.ssd_mixer_bwd.launches
        k13.ssd_mixer_bwd(
            randn(b, L, di + cd + h, seed=1), randn(b, L, h, seed=2).abs(),
            -randn(h, seed=3).abs(),
            randn(cd, w, seed=4), randn(cd, seed=5), randn(h, seed=6), randn(b, cd, w, seed=7),
            1 + randn(di, seed=8, scale=0.1), 1e-5, randn(b, nc, h, p, n, seed=9),
            randn(b, L, di, seed=10), randn(b, L, di, seed=11), randn(b, h, p, n, seed=12),
            q, h, p, g, n)
        assert k13.ssd_mixer_bwd.launches == before + 1, w
