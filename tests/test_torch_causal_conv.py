"""K10 (causal depthwise conv + bias + SiLU) vs videomamba_tpu on the CPU.

``causal_conv1d(use_kernel=True)`` is the port's K10 route, the JAX
package's ``use_pallas=True``; on CPU tensors the wrapper runs its plain
version, and the JAX package runs its Pallas kernel in interpret mode
(VIDEOMAMBA_PALLAS_INTERPRET=1, as tests/test_pallas_conv.py does). Same
numpy inputs, rel_err = max|a - b| / max|b| <= 1e-5 for outputs and
gradients; the new conv window is sliced from the raw input, bit-equal.
The JAX kernel also runs at channel counts its own gate refuses (1, 3,
130: one channel block of D) against the port's route. K10's launch plan
(``causal_conv_plan``) is checked against a model of the kernel's index
arithmetic (csrc/causal_conv.cu): every (t, d) is written exactly once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.ops.causal_conv1d import causal_conv1d as j_conv
from videomamba_tpu.ops.pallas.causal_conv import causal_conv1d_pallas
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d as t_conv
from videomamba_tpu_torch.ops.kernels import causal_conv as k10

TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")


def rel_err(a, b) -> float:
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def inputs(seed, b=2, L=24, d=128, w=4):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, L, d)).astype(f), rng.standard_normal((w, d)).astype(f),
            rng.standard_normal(d).astype(f), (0.3 * rng.standard_normal((b, d, w))).astype(f))


@pytest.mark.parametrize("L", [24, 19])
@pytest.mark.parametrize("with_state", [True, False])
def test_kernel_route_matches_pallas(with_state, L):
    x, w, b, st = inputs(0, L=L)
    st = st if with_state else None
    jy, js = j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    initial_state=None if st is None else jnp.asarray(st),
                    return_final_state=True, use_pallas=True)
    before = k10.causal_conv.launches
    ty, ts = t_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                    initial_state=None if st is None else torch.from_numpy(st),
                    return_final_state=True, use_kernel=True)
    assert k10.causal_conv.launches == before  # the plain version on the CPU
    assert rel_err(ty, jy) <= TOL
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_plain_matches_pallas_across_time_blocks():
    """The TPU kernel at block_l 16 carries its left context over four time
    blocks; the plain version has no blocks."""
    x, w, b, st = inputs(2, L=64)
    jy = causal_conv1d_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(st), block_l=16)
    ty = k10.causal_conv_plain(*(torch.from_numpy(a) for a in (x, w, b, st)))
    assert rel_err(ty, jy) <= TOL
    jy = causal_conv1d_pallas(jnp.asarray(x), jnp.asarray(w), None, jnp.asarray(st),
                              activation=None)
    ty = k10.causal_conv(torch.from_numpy(x), torch.from_numpy(w), None,
                         torch.from_numpy(st), activation=None)
    assert rel_err(ty, jy) <= TOL


def test_gradients_match_jax():
    """Through CausalConvFn (autograd of the plain composition) against the
    JAX package's ``_pallas_conv`` vjp, which is the same."""
    x, w, b, st = inputs(4, L=16)

    def jloss(x_, w_, b_):
        y = j_conv(x_, w_, b_, initial_state=jnp.asarray(st), use_pallas=True)
        return jnp.sum(y * y)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = t_conv(tx, tw, tb, initial_state=torch.from_numpy(st), use_kernel=True)
    assert "CausalConvFn" in type(y.grad_fn).__name__
    y.square().sum().backward()
    for got, want in zip((tx.grad, tw.grad, tb.grad), jg):
        assert rel_err(got, want) <= TOL


def test_width_outside_the_gate_takes_the_plain_composition():
    """The gate is the JAX package's (pallas_conv_supported) without its
    128-lane rule: any width up to the sequence length. Width 5 is inside
    it; a width above L (5 over 4 steps) takes the plain composition, as in
    the JAX package."""
    x, w, b, st = inputs(5, L=4, w=5)
    assert k10.causal_conv_supported(5, 24) and k10.causal_conv_supported(4, 4)
    assert not k10.causal_conv_supported(5, 4)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    before = k10.causal_conv.launches
    y = t_conv(*args, initial_state=torch.from_numpy(st), use_kernel=True)
    assert k10.causal_conv.launches == before
    assert torch.equal(y, t_conv(*args, initial_state=torch.from_numpy(st)))


@pytest.mark.parametrize("w", [1, 5, 9])
@pytest.mark.parametrize("d", [1, 3, 130])
def test_route_matches_pallas_at_odd_channel_counts(d, w):
    """The port's route (its plain version on the CPU) against the JAX
    kernel run with one channel block of all D, at an L of 37 (no multiple
    of either tile)."""
    x, wt, b, st = inputs(6 + w, L=37, d=d, w=w)
    jy = causal_conv1d_pallas(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                              jnp.asarray(st), block_d=d)
    before = k10.causal_conv.launches
    ty = t_conv(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
                initial_state=torch.from_numpy(st), use_kernel=True)
    assert k10.causal_conv.launches == before
    assert rel_err(ty, jy) <= TOL


def _conv_cover(plan, batch, seqlen, d):
    """How often the kernel writes each (b, t, d): block (x, y, z) of
    CONV_THREADS threads takes time steps x * tile .. + tile - 1 (those
    below L) of batch row z, and thread i channel vector j = y * threads +
    i (those below D / vec), channels j * vec .. j * vec + vec - 1."""
    gx, gy, gz = plan.grid
    t = np.arange(gx)[:, None] * plan.tile + np.arange(plan.tile)[None, :]
    t = t[t < seqlen]
    j = np.arange(gy)[:, None] * k10.CONV_THREADS + np.arange(k10.CONV_THREADS)[None, :]
    j = j[j < d // plan.vec]
    ch = (j[:, None] * plan.vec + np.arange(plan.vec)[None, :]).ravel()
    return gz, np.bincount(t, minlength=seqlen), np.bincount(ch, minlength=d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 7, 8, 768, 1000, 3200, 14529, 65536])
def test_conv_plan_covers_every_output_once(d, dtype):
    for seqlen in (1, 5, 1569, 6276):
        for w in (1, 4, 5, 9):
            for aligned in (True, False):
                plan = k10.causal_conv_plan(2, seqlen, d, dtype, w, aligned=aligned)
                wide = 8 if dtype == torch.bfloat16 else 4
                assert plan.vec == (wide if aligned and d % wide == 0 else 1)
                assert plan.tile == (4 if w <= 4 else 8)
                batches, t_seen, d_seen = _conv_cover(plan, 2, seqlen, d)
                assert batches == 2
                assert np.all(t_seen == 1) and np.all(d_seen == 1)


def test_conv_plan_fills_two_waves_at_base():
    """At Base B=1, (1, 1569, 1536), the grid holds at least two waves of
    132 blocks at fp32 and at bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        gx, gy, gz = k10.causal_conv_plan(1, 1569, 1536, dtype, 4).grid
        assert gx * gy * gz >= 2 * 132


@pytest.mark.parametrize("py_name,c_name", [
    ("CONV_THREADS", "kConvThreads"), ("CONV_TILE_FIXED", "kConvTileFixed"),
    ("CONV_TILE_ANY", "kConvTileAny")])
def test_conv_plan_constants_are_the_kernels(py_name, c_name):
    """The plan's constants are those csrc/causal_conv.cu launches with
    and checks a plan's tile against."""
    import pathlib
    import re

    src = (pathlib.Path(__file__).resolve().parents[1] / "videomamba_tpu_torch" / "csrc" /
           "causal_conv.cu").read_text()
    found = re.search(rf"constexpr int {c_name} = (\d+);", src)
    assert found and int(found.group(1)) == getattr(k10, py_name)
