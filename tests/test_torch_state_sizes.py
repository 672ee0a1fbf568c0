"""Mamba-1 at state sizes outside the walks' built ones, on the CPU.

The Hopper walks are compiled for d_state 8, 16, 32, 64 and 128; the
wrappers pad a smaller state with zero lanes and run K1 and K5 above 128 as
slices of 128 (ops/kernels/scan.py). Here: the padding helpers, the slicing
arithmetic (its per-slice calls take the plain versions on CPU tensors)
against the plain versions at full width (fp32 1e-5 forward, 2e-5
gradients), and a Mamba layer's route and numbers against the JAX
package's at d_state 24, 48 and 128 (its fused mixer's shape rule,
mixer_fused.py:45-51; fp32 1e-5 forward, 2e-5 gradients).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.models.mamba import Mamba as JMamba
from videomamba_tpu_torch.models.mamba import Mamba
from videomamba_tpu_torch.ops.kernels import scan as k1


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def test_state_padding_helpers():
    assert [k1.walk_state(n, "k") for n in (1, 8, 24, 48, 64, 65, 128)] == \
        [8, 8, 32, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="d_state 1..128"):
        k1.walk_state(136, "k")
    r, n, di = 5, 24, 16
    w = torch.randn(r + 2 * n, di)
    wp = k1.pad_x_proj(w, r, n, 32)
    x = torch.randn(3, di)
    proj, projp = x @ w.t(), x @ wp.t()
    assert torch.equal(projp[:, :r + n], proj[:, :r + n])
    assert torch.equal(projp[:, r + 32:r + 32 + n], proj[:, r + n:])
    assert not projp[:, r + n:r + 32].any() and not projp[:, r + 32 + n:].any()
    assert torch.equal(k1.unpad_x_proj(wp, r, n, 32), w)
    assert torch.equal(k1.unpad(k1.pad_state(x, 20), 16), x)


def scan_args(n, b=2, L=37, d=24, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g)

    return (rn(b, L, d), rn(b, L, d, scale=0.5), -torch.exp(rn(d, n, scale=0.3)), rn(b, L, n),
            rn(b, L, n), rn(d), rn(b, L, d), rn(d), rn(b, d, n, scale=0.2))


@pytest.mark.parametrize("n", [136, 256])
def test_scan_slices_match_the_full_width_plain_version(n):
    """K1's and K5's slicing above 128 states (two slices), its gate and D
    skip in torch, against the plain versions at full width."""
    u, delta, A, B, C, D, z, bias, h0 = scan_args(n)
    got = k1._scan_sliced(u, delta, A, B, C, D, z, bias, h0, True, True)
    want = k1.selective_scan_plain(u, delta, A, B, C, D, z, bias, h0, True, checkpoints=True)
    for a, w in zip(got, want):
        assert a.shape == w.shape and rel_err(a, w) <= 1e-5
    g = torch.randn(u.shape, generator=torch.Generator().manual_seed(1))
    ghl = torch.randn(h0.shape, generator=torch.Generator().manual_seed(2))
    args = (u, delta, A, B, C, D, z, bias, want[2], g, ghl)
    got = k1._scan_bwd_sliced(*args, True)
    for a, w in zip(got, k1.selective_scan_bwd_plain(*args, True)):
        assert a.shape == w.shape and rel_err(a, w) <= 2e-5


@pytest.mark.parametrize("d_model,d_state", [(64, 24), (64, 48), (64, 128), (16, 16)])
def test_mamba_layer_routes_and_matches_jax(monkeypatch, d_model, d_state):
    """The fused-mixer route as the JAX package picks it (in interpret mode,
    where its Pallas route is live), and the layer's output and every
    gradient against the JAX layer on the same weights (on its XLA route,
    the same arithmetic without the interpreter's cost)."""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    jm = JMamba(d_model=d_model, d_state=d_state, use_fast_path=True)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = Mamba(d_model, d_state=d_state, device="cpu")
    sd = {"in_proj.weight": params["in_proj"]["kernel"].T,
          "conv1d.weight": params["conv1d"]["weight"].T[:, None, :],
          "conv1d.bias": params["conv1d"]["bias"],
          "x_proj.weight": params["x_proj"]["kernel"].T,
          "dt_proj.weight": params["dt_proj"]["kernel"].T,
          "dt_proj.bias": params["dt_proj"]["bias"],
          "A_log": params["A_log"], "D": params["D"],
          "out_proj.weight": params["out_proj"]["kernel"].T}
    tm.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()})
    assert tm._use_fused_mixer() == jm._use_fused_mixer(params)
    assert tm._use_fused_mixer() == (d_model == 64)
    monkeypatch.delenv("VIDEOMAMBA_PALLAS_INTERPRET")
    x = np.random.default_rng(3).standard_normal((2, 21, d_model)).astype(np.float32)
    tgt = np.random.default_rng(4).standard_normal((2, 21, d_model)).astype(np.float32)

    def j_loss(p, xx):
        return jnp.sum((jm(p, xx) - tgt) ** 2)

    jgrads = jax.grad(j_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx)
    assert rel_err(out, jm(params, jnp.asarray(x))) <= 1e-5
    (out - torch.from_numpy(tgt)).square().sum().backward()
    assert rel_err(tx.grad, jgrads[1]) <= 2e-5
    jg = jgrads[0]
    pairs = {"in_proj.weight": jg["in_proj"]["kernel"].T,
             "x_proj.weight": jg["x_proj"]["kernel"].T, "A_log": jg["A_log"], "D": jg["D"],
             "dt_proj.bias": jg["dt_proj"]["bias"],
             "conv1d.weight": np.asarray(jg["conv1d"]["weight"]).T[:, None, :]}
    for name, want in pairs.items():
        assert rel_err(tm.get_parameter(name).grad, want) <= 2e-5, name
