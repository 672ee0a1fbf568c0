"""The serving forward's bf16 in_proj and out_proj on the wgmma tile: what
the CPU can hold of it.

On the card K4 (ops/kernels/block_fused.py) and K14's forward
(ops/kernels/ssd_pmixer.py) hand both projections of a bf16 call to
csrc/hopper_gemm.cuh and count them in ``wgmma_products``; on the CPU every
wrapper runs its plain version, so the counters stay 0, and the plain
versions keep their rounding points: K4 rounds y to the weight dtype before
out_proj. No JAX: these are the port's own contracts.
"""

import pytest
import torch

from videomamba_tpu_torch.ops.kernels import block_fused as k4
from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14

COUNTERS = (k4.block_fused, k14.ssd_pmixer)


def _block_kw(dtype, b=2, L=9, e=32, di=64, n=8, r=4, w=4):
    g = torch.Generator().manual_seed(3)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g)

    return dict(
        hidden=rn(b, L, e).to(dtype), residual=rn(b, L, e), norm_w=1 + rn(e, scale=0.1),
        norm_b=None, in_proj_w=rn(2 * di, e, scale=e ** -0.5).to(dtype),
        out_proj_w=rn(e, di, scale=di ** -0.5).to(dtype), conv_w=rn(di, w, scale=0.5).to(dtype),
        conv_b=rn(di, scale=0.1).to(dtype), x_proj_w=rn(r + 2 * n, di, scale=di ** -0.5).to(dtype),
        dt_proj_w=rn(di, r, scale=r ** -0.5).to(dtype),
        dt_bias=torch.linspace(-4.0, -1.0, di),
        A=-torch.arange(1, n + 1, dtype=torch.float32).expand(di, n).contiguous(),
        D=torch.ones(di), h0=rn(b, di, n, scale=0.1), conv_state=rn(b, di, w),
    )


def _pmixer_kw(dtype, b=2, L=9, e=32, h=2, p=8, n=8, q=4, w=4):
    g = torch.Generator().manual_seed(4)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g)

    di = h * p
    cd = di + 2 * n
    return dict(
        hidden=rn(b, L, e).to(dtype), A=-torch.exp(rn(h, scale=0.5)),
        in_proj_w=rn(di + cd + h, e, scale=e ** -0.5).to(dtype),
        out_proj_w=rn(e, di, scale=di ** -0.5).to(dtype),
        conv_weight=rn(cd, w, scale=0.5).to(dtype), conv_bias=rn(cd, scale=0.2).to(dtype),
        D=rn(h), dt_bias=torch.linspace(-4.0, -1.0, h), initial_state=rn(b, h, p, n, scale=0.3),
        conv_state=rn(b, cd, w), norm_weight=1 + rn(di, scale=0.1),
        chunk_size=q, nheads=h, hdim=p, ngroups=1, d_state=n,
    )


def test_wgmma_counters_exist_beside_the_launch_counters():
    for fn in COUNTERS:
        assert isinstance(fn.wgmma_products, int) and isinstance(fn.launches, int)
        # only a bf16 call on a card counts
        assert fn.wgmma_products == 0 or torch.cuda.is_available()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgmma_counters_stay_zero_on_cpu_calls(dtype):
    before = [(fn.launches, fn.wgmma_products) for fn in COUNTERS]
    with torch.inference_mode():
        out = k4.block_fused(**_block_kw(dtype))
        out_m2, _ = k14.ssd_pmixer(**_pmixer_kw(dtype))
    assert out[0].dtype == out_m2.dtype == dtype
    assert [(fn.launches, fn.wgmma_products) for fn in COUNTERS] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_plain_rounds_y_to_the_weight_dtype_before_out_proj(monkeypatch, dtype):
    """The plain version's four products, in order in_proj, x_proj, dt_proj,
    out_proj, each take an operand rounded to the weight dtype (bf16 y on
    the bf16 path, which the CUDA walk now stores as such); out is the fp32
    sum over those operands, rounded once to the hidden dtype."""
    seen = []
    product = k4._product

    def record(a, w):
        seen.append((a, w))
        return product(a, w)

    monkeypatch.setattr(k4, "_product", record)
    kw = _block_kw(dtype)
    with torch.inference_mode():
        out, *_ = k4.block_fused_plain(**kw)
    assert [w.data_ptr() for _, w in seen] == [
        kw[k].data_ptr() for k in ("in_proj_w", "x_proj_w", "dt_proj_w", "out_proj_w")]
    assert all(a.dtype == dtype for a, _ in seen)
    y = seen[-1][0]
    assert torch.equal(out, (y.float() @ kw["out_proj_w"].float().t()).to(dtype))
    assert torch.equal(y, y.float().to(dtype))


@pytest.mark.parametrize("out", [None, torch.float32, torch.bfloat16])
def test_projection_product_takes_an_nt_output_dtype(out):
    g = torch.Generator().manual_seed(5)
    a = torch.randn(7, 20, generator=g).to(torch.bfloat16)
    b = torch.randn(5, 20, generator=g).to(torch.bfloat16)
    got = k14.projection_product("nt", a, b, out_dtype=out)
    sums = a.float() @ b.float().t()
    assert got.dtype == (out or torch.bfloat16)
    assert torch.equal(got, sums.to(got.dtype))


@pytest.mark.parametrize("layout", ["nn", "tn"])
def test_projection_product_keeps_fp32_outside_nt(layout):
    a = torch.ones(4, 4, dtype=torch.bfloat16)
    assert k14.projection_product(layout, a, a).dtype == torch.float32
    with pytest.raises(ValueError, match="no torch.bfloat16 output"):
        k14.projection_product(layout, a, a, out_dtype=torch.bfloat16)
