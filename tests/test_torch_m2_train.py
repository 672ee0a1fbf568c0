"""The port's Mamba-2 (SSD) training path vs videomamba_tpu on the CPU.

A 2-layer m2 model (img 16, patch 8, 4 frames: 17 tokens, two chunks of
16), embed 128 (the projected-mixer layer, K14's route) or 64 (K12 between
the projections), headdim 32, d_state 16, with the same weights (exported
from the JAX model) and the same numpy video and target. The port's layers
run through ``SsdMixerFn`` / ``SsdPmixerFn`` with the kernels' plain
versions (CPU tensors); JAX runs its XLA route at fp32 and its Pallas
kernels in interpret mode at bf16. JAX gradients are mapped to torch names
and layouts with the port's ``params_from_jax``, which only moves axes.
rel_err = max|a - b| / max|b|. Bars: fp32 loss and grad_norm 1e-5,
gradients 2e-5, and the parameters after one AdamW step within the JAX
package's own bar for an m2 step (rtol 5e-3, atol 1e-4,
tests/test_parallel_train.py:372-381: AdamW's first step divides by
sqrt(nu) + eps and so amplifies fp32 reassociation); bf16 compute over fp32
masters loss 1e-2, gradients 2e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.parallel.train_step import default_loss_fn as j_loss_fn
from videomamba_tpu.parallel.train_step import make_train_step as j_make_train_step
from videomamba_tpu_torch.checkpoint import load_state_dict, params_from_jax
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.parallel.train_step import make_train_step


def geom(embed):
    return dict(img_size=16, patch_size=8, depth=2, embed_dim=embed, channels=3,
                ssm_cfg={"layer": "Mamba2", "d_state": 16, "headdim": 32, "chunk_size": 16},
                kernel_size=1, num_frames=4, add_pool_norm=False)


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def pair(embed):
    jm = JModel(**geom(embed), rng=0)
    tm = TModel(**geom(embed), device="cpu")
    load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
    return jm, tm


def torch_tree(tm, tree):
    """A JAX parameter-shaped tree (gradients or parameters) in the port's
    names and layouts: params_from_jax only moves axes, so it maps
    gradients too."""
    return params_from_jax(jax.tree.map(np.asarray, tree), tm)


def batch(seed, embed):
    rng = np.random.default_rng(seed)
    return {"video": rng.standard_normal((2, 3, 4, 16, 16)).astype(np.float32),
            "target": rng.standard_normal((2, 17, embed)).astype(np.float32)}


ROUTES = {"k14-mixer": (128, {}), "k14-pmixer": (128, {"VIDEOMAMBA_SSD_TRAIN_ROUTE": "pmixer"}),
          "k12": (64, {}), "k12-composite": (64, {"VIDEOMAMBA_SSD_BWD": "composite"})}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_m2_fp32_train_step_matches_jax(route, monkeypatch):
    """One make_train_step step (AdamW 1e-3, weight decay 0.05) on each
    training route: the loss, grad_norm, every parameter's gradient and the
    parameters after the step against JAX's."""
    embed, env = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jm, tm = pair(embed)
    b = batch(3, embed)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    rng = jax.random.PRNGKey(0)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_loss_fn(jm, p, jb, rng), has_aux=True)(jm.params)
    tx = optax.adamw(1e-3, weight_decay=0.05)
    jstep = j_make_train_step(jm, tx, donate=False)
    p1, _, _, jm1 = jstep(jm.params, tx.init(jm.params), jnp.zeros((), jnp.int32), jb, rng)

    opt = torch.optim.AdamW(tm.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_train_step(tm, opt)
    m1 = step({k: torch.from_numpy(v) for k, v in b.items()}, torch.Generator().manual_seed(0))
    assert abs(float(m1["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(m1["grad_norm"]) - float(jm1["grad_norm"])) <= \
        1e-5 * float(jm1["grad_norm"])
    grads = {k: p.grad for k, p in tm.named_parameters()}
    want = torch_tree(tm, jgrads)
    assert set(want) == set(grads)
    for name, g in want.items():
        assert rel_err(grads[name], g) <= 2e-5, name
    params = dict(tm.named_parameters())
    for name, p in torch_tree(tm, p1).items():
        np.testing.assert_allclose(f64(params[name]), f64(p), rtol=5e-3, atol=1e-4,
                                   err_msg=name)


def test_m2_bf16_gradients_match_jax_interpret(monkeypatch):
    """bf16 compute over fp32 masters; JAX runs its Pallas training route
    (the mixer kernel with checkpoints and its fused backward) in interpret
    mode on its per-head arms, whose backward rounding the port's kernels
    follow: the loss and every fp32 master gradient. (JAX's merged arms
    differ from its per-head arms by 3.2e-2 on layer 0's A_log gradient at
    this size, a sum over every step with heavy cancellation; the port lies
    between them.)"""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VIDEOMAMBA_SSD_FWD_MERGED", "0")
    monkeypatch.setenv("VIDEOMAMBA_SSD_BWD_MERGED", "0")
    jm, tm = pair(128)
    b = batch(4, 128)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_loss_fn(jm, p, jb, jax.random.PRNGKey(0), compute_dtype=jnp.bfloat16),
        has_aux=True)(jm.params)
    opt = torch.optim.AdamW(tm.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_train_step(tm, opt, compute_dtype=torch.bfloat16)
    m1 = step({k: torch.from_numpy(v) for k, v in b.items()}, torch.Generator().manual_seed(0))
    assert abs(float(m1["loss"]) - float(jloss)) <= 1e-2 * abs(float(jloss))
    grads = {k: p.grad for k, p in tm.named_parameters()}
    for name, g in torch_tree(tm, jgrads).items():
        assert grads[name].dtype == torch.float32
        assert rel_err(grads[name], g) <= 2e-2, name
