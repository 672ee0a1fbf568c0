"""The port's training path vs videomamba_tpu on the CPU.

The tiny geometry of ``__graft_entry__.dryrun_multichip`` (img 16, patch 8,
depth 2, embed 64, 4 frames, fused add-norm, RMSNorm, fp32 residual, no pool
norm): the same weights (exported from the JAX model), the same numpy video
and target, AdamW. JAX gradients are mapped to torch names and layouts with
``params_to_torch_state_dict`` on a shallow copy of the JAX model whose
params are the gradients. rel_err = max|a - b| / max|b|. Bars:

* fp32 (JAX on its XLA route): loss, grad_norm and step 2's loss 1e-5,
  every gradient 2e-5 (tests/test_mixer_bwd.py:76);
* bf16 compute over fp32 masters (JAX kernels in interpret mode): loss
  1e-2, every gradient 2e-2 (tests/test_block_bwd.py:115);
* optimizer masks equal leaf by leaf, one step of each optimizer from the
  same gradients within 1e-6, the schedule within 1e-7;
* activation checkpointing with stochastic depth: the gradients of the
  unchecked model within 1e-6.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from videomamba_tpu.checkpoint import params_to_torch_state_dict
from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.parallel.train_step import default_loss_fn as j_loss_fn
from videomamba_tpu.parallel.train_step import make_train_step as j_make_train_step
from videomamba_tpu.utils import optimizer as j_opt
from videomamba_tpu.utils.scheduler import get_cosine_schedule_with_warmup as j_cosine
from videomamba_tpu_torch.checkpoint import load_state_dict, params_from_jax
from videomamba_tpu_torch.models.block import create_block, drop_path, drop_path_mask
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.parallel.train_step import init_train_state, make_train_step
from videomamba_tpu_torch.utils import optimizer as t_opt
from videomamba_tpu_torch.utils.scheduler import create_scheduler, get_cosine_schedule_with_warmup

GEOM = dict(img_size=16, patch_size=8, depth=2, embed_dim=64, channels=3,
            ssm_cfg={"use_fast_path": True}, fused_add_norm=True, rms_norm=True,
            residual_in_fp32=True, kernel_size=1, num_frames=4, add_pool_norm=False)


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def torch_tree(jm, tree):
    """A JAX parameter-shaped tree in torch names and layouts."""
    view = copy.copy(jm)
    view.params = jax.tree.map(np.asarray, tree)
    return params_to_torch_state_dict(view)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"video": rng.standard_normal((2, 3, 4, 16, 16)).astype(np.float32),
            "target": rng.standard_normal((2, 17, 64)).astype(np.float32)}


def pair():
    jm = JModel(**GEOM, rng=0)
    tm = TModel(**GEOM, device="cpu")
    load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
    return jm, tm


def port_step(tm, b, compute_dtype=None):
    opt = torch.optim.AdamW(tm.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_train_step(tm, opt, compute_dtype=compute_dtype)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    m1 = step(tb, torch.Generator().manual_seed(0))
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    m2 = step(tb, torch.Generator().manual_seed(1))
    return m1, grads, m2


def test_fp32_train_step_matches_jax():
    jm, tm = pair()
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    rng = jax.random.PRNGKey(0)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_loss_fn(jm, p, jb, rng), has_aux=True)(jm.params)
    tx = optax.adamw(1e-3, weight_decay=0.05)
    jstep = j_make_train_step(jm, tx, donate=False)
    p1, o1, s1, jm1 = jstep(jm.params, tx.init(jm.params), jnp.zeros((), jnp.int32), jb, rng)
    _, _, _, jm2 = jstep(p1, o1, s1, jb, rng)

    m1, grads, m2 = port_step(tm, b)
    assert abs(float(m1["loss"]) - float(jm1["loss"])) <= 1e-5 * abs(float(jm1["loss"]))
    assert abs(float(m1["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(m1["grad_norm"]) - float(jm1["grad_norm"])) <= \
        1e-5 * float(jm1["grad_norm"])
    want = torch_tree(jm, jgrads)
    assert set(want) == set(grads)
    for name, g in want.items():
        assert rel_err(grads[name], g) <= 2e-5, name
    assert abs(float(m2["loss"]) - float(jm2["loss"])) <= 1e-5 * abs(float(jm2["loss"]))


def test_bf16_train_step_matches_jax_interpret(monkeypatch):
    """bf16 compute over fp32 masters; JAX runs its Pallas training route
    (K2, K3 with checkpoints, K6) in interpret mode."""
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    jm, tm = pair()
    b = batch(seed=1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_loss_fn(jm, p, jb, jax.random.PRNGKey(0), compute_dtype=jnp.bfloat16),
        has_aux=True)(jm.params)
    m1, grads, _ = port_step(tm, b, compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert abs(float(m1["loss"]) - float(jloss)) <= 1e-2 * abs(float(jloss))
    for name, g in torch_tree(jm, jgrads).items():
        assert grads[name].dtype == torch.float32
        assert rel_err(grads[name], g) <= 2e-2, name


def _jax_name(path: str) -> str:
    return path.replace("patch_embed.", "patch_embed.proj.").replace(".kernel", ".weight")


def _flat(tree):
    return {_jax_name(".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)): v
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("opt", ["sgd", "nesterov", "momentum", "adam", "adamw"])
def test_optimizers_match_jax(opt):
    jm, tm = pair()
    diff = SimpleNamespace(enable=True, module_names=[r"layers\.1\.", "cls_token"], lr=5e-3)
    args = SimpleNamespace(opt=opt, lr=1e-3, weight_decay=0.05, momentum=0.9,
                           opt_eps=None, opt_betas=None, different_lr=diff)
    jmask = _flat(j_opt.weight_decay_mask(jm.params, jm.no_weight_decay()))
    assert jmask == t_opt.weight_decay_mask(tm, tm.no_weight_decay())
    assert _flat(j_opt.different_lr_mask(jm.params, diff.module_names)) == \
        t_opt.different_lr_mask(tm, diff.module_names)

    rng = np.random.default_rng(5)
    jgrads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), jm.params)
    tx = j_opt.create_optimizer(args, model=jm, params=jm.params)
    updates, _ = tx.update(jgrads, tx.init(jm.params), jm.params)
    want = torch_tree(jm, optax.apply_updates(jm.params, updates))

    t_optim = t_opt.create_optimizer(args, tm)
    for name, p in tm.named_parameters():
        p.grad = torch.from_numpy(torch_tree(jm, jgrads)[name])
    t_optim.step()
    for name, p in tm.named_parameters():
        assert float((p.detach() - torch.tensor(want[name])).abs().max()) <= 1e-6, name


def test_cosine_schedule_matches_jax():
    """At the order of learning rate of the bench recipe (JAX evaluates the
    schedule in fp32)."""
    sched_j = j_cosine(1e-3, num_warmup_steps=5, num_training_steps=20, min_lr_multi=0.01)
    param = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([param], lr=1e-3)
    sched = get_cosine_schedule_with_warmup(opt, 5, 20, min_lr_multi=0.01)
    for step in range(25):
        lr, want = opt.param_groups[0]["lr"], float(sched_j(step))
        assert abs(lr - want) <= 1e-7, step
        opt.step()
        sched.step()
    cfg = SimpleNamespace(sched="cosine", num_warmup_steps=5, num_training_steps=20,
                          min_lr_multi=0.01)
    assert create_scheduler(cfg, opt) is not None
    assert create_scheduler(SimpleNamespace(sched="constant"), opt) is None


def test_init_train_state_without_mesh():
    _, tm = pair()
    opt = torch.optim.AdamW(tm.parameters(), lr=1e-3)
    params, state, step = init_train_state(tm, opt)
    assert step == 0 and set(params) == {k for k, _ in tm.named_parameters()}
    with pytest.raises(TypeError, match="DeviceMesh"):
        init_train_state(tm, opt, mesh=object())


def _grads_with_drop_path(use_checkpoint, seed=0):
    tm = TModel(**dict(GEOM, depth=3), drop_path_rate=0.6, use_checkpoint=use_checkpoint,
                checkpoint_num=3, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.train()
    b = batch(seed=2)
    masks = tm._drop_path_masks(2, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed)
    x_vis = tm(torch.from_numpy(b["video"]), generator=g)
    assert masks[:2] == [None, None] and any(float(m.min()) == 0 for m in masks[2:])
    (x_vis - torch.from_numpy(b["target"])).square().mean().backward()
    return {k: p.grad for k, p in tm.named_parameters()}


def test_remat_with_drop_path_matches_plain_gradients():
    plain = _grads_with_drop_path(False)
    remat = _grads_with_drop_path(True)
    for name, g in plain.items():
        assert rel_err(remat[name], g) <= 1e-6, name
    other = _grads_with_drop_path(False, seed=1)  # the masks matter
    assert any(rel_err(other[k], g) > 1e-3 for k, g in plain.items())


def test_drop_path_semantics():
    g = torch.Generator().manual_seed(0)
    mask = drop_path_mask(4000, 0.25, g)
    assert mask.shape == (4000, 1, 1) and set(mask.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(mask.mean()) - 0.75) < 0.03
    x = torch.randn(4000, 3, 5, generator=g)
    y = drop_path(x, mask, 0.25)
    kept = mask[:, 0, 0] == 1
    assert torch.allclose(y[kept], x[kept] / 0.75) and bool((y[~kept] == 0).all())

    block = create_block(64, drop_path=0.5, device="cpu").train()
    h = torch.randn(2, 9, 64, generator=g)
    with pytest.raises(ValueError, match="drop_path_mask"):
        block(h, residual=torch.zeros_like(h))
    # The first block (no residual) is never dropped; eval ignores the rate.
    zero = torch.zeros(2, 1, 1)
    out_train = block(h, drop_path_mask=zero)
    out_eval = block.eval()(h)
    assert torch.allclose(out_train[0], out_eval[0], atol=1e-6)
    block.train()
    res = torch.randn(2, 9, 64, generator=g)
    dropped, new_res = block(h, residual=res, drop_path_mask=zero)
    assert torch.allclose(new_res, res)


def test_whole_block_training_opt_in_names_k7(monkeypatch):
    """VIDEOMAMBA_BLOCK_BWD=fused routes training through the whole Block:
    K4 with checkpoints forward and K7 backward in both packages (JAX in
    interpret mode); the fp32 step's loss and every gradient match the JAX
    package's within its fp32 bars. Unset, training stays on the mixer
    route."""
    from videomamba_tpu_torch.models import block as block_mod

    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VIDEOMAMBA_BLOCK_BWD", "fused")
    calls = []
    apply = block_mod.BlockFusedFn.apply
    monkeypatch.setattr(block_mod.BlockFusedFn, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    jm, tm = pair()
    b = batch(seed=3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_loss_fn(jm, p, jb, jax.random.PRNGKey(0)), has_aux=True)(jm.params)
    m1, grads, _ = port_step(tm, b)
    assert len(calls) == 2 * GEOM["depth"]  # two steps on the whole-block route
    assert abs(float(m1["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for name, g in torch_tree(jm, jgrads).items():
        assert rel_err(grads[name], g) <= 2e-5, name
    monkeypatch.delenv("VIDEOMAMBA_BLOCK_BWD")
    block = create_block(64, device="cpu").train()
    out, _ = block(torch.randn(1, 5, 64))
    assert len(calls) == 2 * GEOM["depth"] and out.grad_fn is not None


def test_remat_on_the_whole_block_route(monkeypatch):
    """checkpoint_num remat with stochastic depth on the opt-in whole-block
    route: the recomputed K4 forward sees the same masks, so the gradients
    equal the unchecked model's."""
    monkeypatch.setenv("VIDEOMAMBA_BLOCK_BWD", "fused")
    plain = _grads_with_drop_path(False)
    remat = _grads_with_drop_path(True)
    for name, g in plain.items():
        assert rel_err(remat[name], g) <= 1e-6, name
