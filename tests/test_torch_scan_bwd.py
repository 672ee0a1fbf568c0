"""K1 with checkpoints and K5 (selective-scan backward) vs videomamba_tpu.

The port's ``SelectiveScanFn`` (K1 forward with segment checkpoints, K5
backward; their plain versions on the CPU) against ``jax.grad`` through the
JAX package's ``_pallas_fused_scan`` with its Pallas kernels in interpret
mode (VIDEOMAMBA_PALLAS_INTERPRET=1, as tests/test_mixer_bwd.py:23-25).
Same numpy inputs and cotangents. rel_err = max|a - b| / max|b|. Bars: 2e-5
at fp32 (tests/test_mixer_bwd.py:76), 2e-2 with bf16 operands
(tests/test_block_bwd.py:115).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.ops.selective_scan import _pallas_fused_scan
from videomamba_tpu_torch.ops.kernels import scan as k1
from videomamba_tpu_torch.ops.selective_scan import SelectiveScanFn, selective_scan_bld

TOL = {"fp32": 2e-5, "bf16": 2e-2}
JDTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
NAMES = ["du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias", "dh0"]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def scan_inputs(seed, b=2, L=40, d=128, n=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        u=rng.standard_normal((b, L, d)).astype(f),
        delta=(0.5 * rng.standard_normal((b, L, d))).astype(f),
        A=-np.exp(0.3 * rng.standard_normal((d, n))).astype(f),
        B=rng.standard_normal((b, L, n)).astype(f),
        C=rng.standard_normal((b, L, n)).astype(f),
        D=rng.standard_normal(d).astype(f),
        z=rng.standard_normal((b, L, d)).astype(f),
        delta_bias=np.linspace(-1.0, 0.5, d).astype(f),
        h0=(0.2 * rng.standard_normal((b, d, n))).astype(f),
    ), (rng.standard_normal((b, L, d)).astype(f),
        (0.3 * rng.standard_normal((b, d, n))).astype(f))


ACTIVATIONS = ("u", "delta", "B", "C", "z")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_selective_scan_fn_grads_match_pallas(dtype):
    """L = 40: two full 16-step segments and a ragged one."""
    p, (gy, ghl) = scan_inputs(seed=0)
    jd, td = JDTYPE[dtype], TDTYPE[dtype]
    jargs = [jnp.asarray(v).astype(jd if k in ACTIVATIONS else jnp.float32)
             for k, v in p.items()]

    def loss(*a):
        y, hl = _pallas_fused_scan(*a, True)
        return jnp.sum(y.astype(jnp.float32) * gy) + jnp.sum(hl * ghl)

    jgrads = jax.grad(loss, argnums=tuple(range(9)))(*jargs)

    targs = [torch.from_numpy(v).to(td if k in ACTIVATIONS else torch.float32).requires_grad_()
             for k, v in p.items()]
    y, hl = SelectiveScanFn.apply(*targs, True)
    assert y.dtype == td and hl.dtype == torch.float32
    ((y.float() * torch.from_numpy(gy)).sum() + (hl * torch.from_numpy(ghl)).sum()).backward()
    for name, t, jg in zip(NAMES, targs, jgrads):
        assert t.grad.dtype == t.dtype, name
        assert rel_err(t.grad, jg) <= TOL[dtype], name


def test_checkpoints_are_segment_start_states():
    p, _ = scan_inputs(seed=1, L=37)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    y, h_last, ckpt = k1.selective_scan_plain(*t.values(), True, checkpoints=True)
    assert ckpt.shape == (2, 3, 128, 16)
    assert torch.equal(ckpt[:, 0], t["h0"])
    for seg in (1, 2):  # the state after 16 * seg steps
        L = 16 * seg
        _, h = k1.selective_scan_plain(*(v[:, :L] if k in ACTIVATIONS else v
                                         for k, v in t.items()), True)
        assert rel_err(ckpt[:, seg], h) <= 1e-6
    y2, h2 = k1.selective_scan(*t.values(), True)
    assert torch.equal(y, y2) and torch.equal(h_last, h2)


def test_bwd_plain_contract_without_optional_operands():
    """No D, z or bias and no softplus: None in their slots, and the same
    gradients as autograd through the plain forward."""
    p, (gy, ghl) = scan_inputs(seed=2, L=21)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    t["delta"] = t["delta"].abs() * 0.1
    _, _, ckpt = k1.selective_scan_plain(t["u"], t["delta"], t["A"], t["B"], t["C"], None,
                                         None, None, t["h0"], False, checkpoints=True)
    grads = k1.selective_scan_bwd(t["u"], t["delta"], t["A"], t["B"], t["C"], None, None,
                                  None, ckpt, torch.from_numpy(gy), None, False)
    assert grads[5] is None and grads[6] is None and grads[7] is None
    live = [t[k].clone().requires_grad_() for k in ("u", "delta", "A", "B", "C", "h0")]
    y, _ = k1.selective_scan_plain(*live[:5], None, None, None, live[5], False)
    want = torch.autograd.grad((y * torch.from_numpy(gy)).sum(), live)
    for got, w in zip((*grads[:5], grads[8]), want):
        assert rel_err(got, w) <= 1e-5


def test_kernel_method_records_autograd():
    """selective_scan_bld(method="kernel") under autograd takes
    SelectiveScanFn and agrees with autograd of the reference method."""
    p, (gy, _) = scan_inputs(seed=3, L=18)
    grads = {}
    for method in ("kernel", "ref"):
        t = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        out = selective_scan_bld(t["u"], t["delta"], t["A"], t["B"], t["C"], D=t["D"],
                                 z=t["z"], delta_bias=t["delta_bias"], delta_softplus=True,
                                 initial_state=t["h0"], method=method)
        if method == "kernel":
            assert out.grad_fn.name().startswith("SelectiveScanFn")
        (out * torch.from_numpy(gy)).sum().backward()
        grads[method] = [v.grad for v in t.values()]
    for a, b in zip(grads["kernel"], grads["ref"]):
        assert rel_err(a, b) <= 1e-5
