"""K8 (fused add-norm backward) vs videomamba_tpu, and the norm's two routes.

K8's plain version (the kernel's reference on the card) against the JAX
package's ``fused_add_norm_bwd_pallas`` in interpret mode, for RMS and
LayerNorm, prenorm on and off, ``residual_in_fp32`` on (fp32 residual) and
off (residual in x's dtype). The default backward of ``FusedAddNormFn``
(autograd of the plain composition, JAX ``_fan_bwd``) against its K8 route
under VIDEOMAMBA_NORM_BWD=pallas. rel_err = max|a - b| / max|b|. Bars: 1e-5
at fp32 (the JAX kernels' own), 1e-2 with bf16 x (one bf16 ulp is 2^-8).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videomamba_tpu.ops.pallas.fused_add_norm import fused_add_norm_bwd_pallas
from videomamba_tpu_torch.ops.kernels.fused_add_norm import fused_add_norm_bwd_plain
from videomamba_tpu_torch.ops.norm import fused_add_norm

TOL = {"fp32": 1e-5, "bf16": 1e-2}
JDTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def norm_inputs(seed, m=37, d=128):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((m, d)).astype(f), rng.standard_normal((m, d)).astype(f),
            (1 + 0.1 * rng.standard_normal(d)).astype(f),
            rng.standard_normal((m, d)).astype(f), rng.standard_normal((m, d)).astype(f))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("residual_in_fp32", [True, False])
@pytest.mark.parametrize("prenorm", [True, False])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
def test_norm_bwd_plain_matches_pallas(norm_type, prenorm, residual_in_fp32, dtype):
    x, res, w, gn, gr = norm_inputs(seed=len(norm_type) + 2 * prenorm)
    res_dtype = "fp32" if residual_in_fp32 else dtype
    jx, jres = jnp.asarray(x, JDTYPE[dtype]), jnp.asarray(res, JDTYPE[res_dtype])
    jgn = jnp.asarray(gn, JDTYPE[dtype])
    jgr = jnp.asarray(gr, JDTYPE[res_dtype]) if prenorm else None
    jdx, jdw, jdb, jdres = fused_add_norm_bwd_pallas(
        jx, jnp.asarray(w), jres, jgn, jgr, prenorm=prenorm, has_residual=True,
        eps=1e-5, norm_type=norm_type, interpret=True,
    )
    tx = torch.from_numpy(x).to(TDTYPE[dtype])
    tres = torch.from_numpy(res).to(TDTYPE[res_dtype])
    tgr = torch.from_numpy(gr).to(TDTYPE[res_dtype]) if prenorm else None
    dx, dw, db, dres = fused_add_norm_bwd_plain(
        tx, torch.from_numpy(w), tres, torch.from_numpy(gn).to(TDTYPE[dtype]), tgr,
        prenorm=prenorm, eps=1e-5, norm_type=norm_type,
    )
    assert dx.dtype == TDTYPE[dtype] and dres.dtype == TDTYPE[res_dtype]
    assert dw.dtype == db.dtype == torch.float32
    tol = TOL[dtype]
    for a, b in ((dx, jdx), (dres, jdres), (dw, jdw), (db, jdb)):
        assert rel_err(a, b) <= tol


@pytest.mark.parametrize("prenorm", [True, False])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
def test_default_backward_matches_k8_route(norm_type, prenorm, monkeypatch):
    """FusedAddNormFn: autograd of the plain composition (default) against
    K8's route (VIDEOMAMBA_NORM_BWD=pallas), every input's gradient."""
    x, res, w, gn, gr = norm_inputs(seed=11)
    bias = np.linspace(-0.1, 0.1, w.shape[0]).astype(np.float32)
    grads = {}
    for route in ("", "pallas"):
        monkeypatch.setenv("VIDEOMAMBA_NORM_BWD", route)
        t = [torch.from_numpy(v).requires_grad_() for v in (x, w, bias, res)]
        out = fused_add_norm(t[0], t[1], t[2] if norm_type == "layer" else None,
                             residual=t[3], prenorm=prenorm, residual_in_fp32=True,
                             norm_type=norm_type, use_kernel=True)
        outs = out if prenorm else (out,)
        assert outs[0].grad_fn.name().startswith("FusedAddNormFn")
        loss = (outs[0] * torch.from_numpy(gn)).sum()
        if prenorm:
            loss = loss + (outs[1] * torch.from_numpy(gr)).sum()
        loss.backward()
        grads[route] = [v.grad for v in t]
    for a, b in zip(grads["pallas"], grads[""]):
        assert (a is None) == (b is None)
        if a is not None:
            assert rel_err(a, b) <= 1e-5
