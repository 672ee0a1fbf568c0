"""The numerical argument for the fp32 path of K14's backward products.

csrc/hopper_gemm.cuh runs each fp32 product as three TF32 products on the
tensor cores: a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and the
sum hi hi' + hi lo' + lo hi' in fp32. Here TF32 is emulated in torch on
the CPU (fp32 rounded to 10 mantissa bits, to nearest with ties away from
zero, as ``cvt.rna.tf32.f32`` rounds) at K14's contraction lengths at
VideoMamba-Base-m2 (E = 768, B L = 1569, Di + CD = 3200) with the other
dimensions small, against a float64 product: the split meets the backward
kernels' fp32 bar (2e-5 of the largest element), one TF32 product does not.
"""

import numpy as np
import pytest
import torch

FP32_BAR = 2e-5  # the backward kernels' fp32 bar against their plain versions
CONTRACTIONS = (768, 1569, 3200)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half of the 13 dropped bits to the magnitude, then drop them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def operands(k: int, seed: int):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((48, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 40), dtype=np.float32))
    return a, b, a.double() @ b.double()


def test_tf32_rounding_keeps_ten_mantissa_bits_ties_away():
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one,
                      3.0 * 2.0 ** -11 + 1.0], dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, one, 1.0 + 2.0 ** -9], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    r = tf32(torch.from_numpy(np.random.default_rng(0).standard_normal(1000, dtype=np.float32)))
    assert not (r.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("k", CONTRACTIONS)
def test_three_tf32_products_meet_the_fp32_bar(k):
    a, b, want = operands(k, seed=k)
    err = rel_err(split_product(a, b), want)
    assert err <= FP32_BAR, f"K={k}: {err:.3e}"
    assert err <= 5 * rel_err(a @ b, want) + 1e-6  # the order of a plain fp32 product


@pytest.mark.parametrize("k", CONTRACTIONS)
def test_one_tf32_product_misses_the_fp32_bar(k):
    a, b, want = operands(k, seed=k)
    assert rel_err(tf32(a) @ tf32(b), want) > FP32_BAR
