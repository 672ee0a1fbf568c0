"""The port's BiMambaRefinerBlock vs videomamba_tpu's on the CPU.

Weights come from the JAX refiner's tree through
``refiner_params_from_jax``; inputs from numpy seeds. Two settings: the JAX
refiner test's (dim 16, LayerNorm, plain mixer) and the Base prenorm
settings at dim 64 (RMSNorm, fused add-norm, fp32 residual, fast path, whose
plain versions the port runs here). rel_err = max|a - b| / max|b|, bar 1e-5
(the JAX kernels' own fp32 bar).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.models.refiner import BiMambaRefinerBlock as JRefiner
from videomamba_tpu_torch.checkpoint import load_state_dict, refiner_params_from_jax
from videomamba_tpu_torch.models.refiner import BiMambaRefinerBlock as TRefiner

TOL = 1e-5
SETTINGS = {
    "plain": (16, dict(ssm_cfg={"use_fast_path": False, "d_state": 8}, rms_norm=False,
                       fused_add_norm=False, residual_in_fp32=False, layer_idx=0)),
    "prenorm": (64, dict(ssm_cfg=None, rms_norm=True, fused_add_norm=True,
                         residual_in_fp32=True, layer_idx=3)),
}


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


_PAIRS = {}


def pair(name):
    """(JAX refiner, its params, port refiner) on the same weights, with a
    nonzero dt bias in both Blocks."""
    if name not in _PAIRS:
        dim, kw = SETTINGS[name]
        jr = JRefiner(dim, **kw)
        params = jax.tree.map(np.asarray, jr.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        for blk in ("block_fwd", "block_bwd"):
            b = params[blk]["mixer"]["dt_proj"]["bias"]
            params[blk]["mixer"]["dt_proj"]["bias"] = rng.uniform(-3, 0, b.shape).astype(np.float32)
        tr = TRefiner(dim, device="cpu", **kw).eval()
        load_state_dict(tr, refiner_params_from_jax(params, tr))
        _PAIRS[name] = (jr, jax.tree.map(jnp.asarray, params), tr)
    return _PAIRS[name]


def tokens(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_state_dict_keys_are_the_mapping():
    jr, params, tr = pair("prenorm")
    sd = refiner_params_from_jax(jax.tree.map(np.asarray, params), tr)
    assert set(sd) == set(tr.state_dict())
    assert tr.block_bwd.layer_idx == tr.block_fwd.layer_idx + 1_000_000
    np.testing.assert_array_equal(sd["fusion_gate.weight"].numpy(),
                                  np.asarray(params["fusion_gate"]["kernel"]).T)


@pytest.mark.parametrize("name", sorted(SETTINGS))
@pytest.mark.parametrize("layout", ["sequence", "packed"])
def test_refiner_matches_jax(name, layout):
    jr, params, tr = pair(name)
    dim = SETTINGS[name][0]
    shape = (2, 7, dim) if layout == "sequence" else (2, 3, 4, dim)
    x = tokens(shape, seed=2)
    jout, (jc, js) = jr(params, jnp.asarray(x))
    with torch.no_grad():
        tout, (tc, ts) = tr(torch.from_numpy(x))
    assert tout.shape == jout.shape == x.shape
    assert tc.shape == jc.shape and ts.shape == js.shape
    for got, want in ((tout, jout), (tc, jc), (ts, js)):
        assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_streamed_forward_state_matches_jax(name):
    """A second call from the first call's forward state and an explicit
    backward initial state, in both packages."""
    jr, params, tr = pair(name)
    dim = SETTINGS[name][0]
    x1, x2 = tokens((1, 2, 3, dim), seed=3), tokens((1, 2, 3, dim), seed=4)
    bwd_init = tuple(tokens(s.shape, seed=5 + i)
                     for i, s in enumerate(tr.allocate_state(1)[1]))
    _, jstate = jr(params, jnp.asarray(x1))
    jout, jstate2 = jr(params, jnp.asarray(x2), state_fwd=jstate,
                       state_bwd_init=tuple(map(jnp.asarray, bwd_init)))
    with torch.no_grad():
        _, tstate = tr(torch.from_numpy(x1))
        tout, tstate2 = tr(torch.from_numpy(x2), state_fwd=tstate,
                           state_bwd_init=tuple(map(torch.from_numpy, bwd_init)))
    assert rel_err(tout, jout) <= TOL
    for got, want in zip(tstate2, jstate2):
        assert rel_err(got, want) <= TOL


def test_forward_state_of_two_calls_equals_one_call():
    """Only the forward direction streams: its state after two 2-frame calls
    is the state after one 4-frame call."""
    _, _, tr = pair("prenorm")
    x = torch.from_numpy(tokens((2, 4, 3, 64), seed=6))
    with torch.no_grad():
        _, state = tr(x[:, :2])
        _, state = tr(x[:, 2:], state_fwd=state)
        _, whole = tr(x)
    for got, want in zip(state, whole):
        assert rel_err(got, want) <= TOL


def test_flip_time_flips_frames_not_tokens():
    x = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3 * 2, 1)
    want = JRefiner._flip_time(jnp.asarray(x), (2, 3, 2))
    got = TRefiner._flip_time(torch.from_numpy(x), (2, 3, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x.reshape(2, 3, 2, 1)[:, ::-1].reshape(2, 6, 1))
    np.testing.assert_array_equal(TRefiner._flip_time(torch.from_numpy(x), None).numpy(),
                                  x[:, ::-1])


def test_gate_saturated_to_forward_is_the_forward_branch():
    _, _, tr = pair("plain")
    x = torch.from_numpy(tokens((1, 4, 16), seed=7))
    bias = tr.fusion_gate.bias.detach().clone()
    with torch.no_grad():
        tr.fusion_gate.bias.fill_(100.0)
        try:
            out, _ = tr(x)
        finally:
            tr.fusion_gate.bias.copy_(bias)
        fwd, _, _ = tr.block_fwd(x, state=tr.block_fwd.mixer.allocate_state(1),
                                 return_state=True)
        want = tr.out_proj(fwd)
    assert rel_err(out, want) <= TOL


def test_rejects_other_ranks():
    _, _, tr = pair("plain")
    with pytest.raises(ValueError, match=r"\[B, L, C\] or \[B, T, N, C\]"):
        tr(torch.zeros(1, 5, 1, 1, 16))


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_use_checkpoint_gradients_equal_unchecked(name):
    _, _, tr = pair(name)
    dim = SETTINGS[name][0]
    x = tokens((2, 3, 2, dim), seed=8)
    target = torch.from_numpy(tokens((2, 3, 2, dim), seed=9))
    grads = []
    for use_checkpoint in (False, True):
        tr.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x).requires_grad_()
        out, (conv, ssm) = tr(xt, use_checkpoint=use_checkpoint)
        ((out - target).square().mean() + ssm.square().mean()).backward()
        grads.append({"x": xt.grad, **{k: p.grad for k, p in tr.named_parameters()}})
    tr.zero_grad(set_to_none=True)
    assert set(grads[0]) == set(grads[1])
    for k, g in grads[0].items():
        assert g is not None and torch.equal(grads[1][k], g), k
