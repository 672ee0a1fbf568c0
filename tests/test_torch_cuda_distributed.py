"""The distribution layer over NCCL on four cards, against one card.

Marked ``cuda``; skips without four CUDA cards. On a machine with them,
after the kernels are built (``python -c "from videomamba_tpu_torch.ops.
kernels import _build; _build.library()"``), without the JAX harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_distributed.py -q

One spawn of four ranks, a card each, an NCCL group started through
``init_distributed_mode`` (torchrun's variables, a ``file://`` rendezvous
under ``tmp_path``), runs every case; rank 0 then computes the one-card
references on its card. TF32 off. Cases and bars:

* the small model of tests/test_torch_parallel_train.py on the kernels:
  one AdamW step under ``init_train_state(mesh=...)`` on {dp 1, fsdp 2, tp
  2}, {dp 2, fsdp 2} and {dp 4}, and the Mamba-2 model on {dp 1, fsdp 2,
  tp 2}, against the unsharded step on one card: loss and grad_norm 1e-5.
  Mamba-1: the step's update itself (the parameters after it less those
  before), against the one-card update, to 1e-6 absolute (a thousandth of
  the learning rate, which a missed or wrong update exceeds) and 1e-3
  relative, wherever the one-card gradient is above 1e-6; AdamW's first
  step, lr m / (sqrt(v) + eps), makes the update of an element whose
  gradient is near eps turn on the gradient's last bits, and the two sides
  take different kernels for the same sums (tp runs K1 / K5 where one card
  runs K3 / K6; a rank's rows change the walks' chunks), so there the
  update is only held to AdamW's bound, lr (1 + weight decay |p|): in
  this model 13 % of the elements on the CPU, among them every element of
  A_log and dt_proj.weight, whose updates are bounded, not compared.
  Mamba-2: the parameters after the step at the JAX package's m2 bar, rtol
  5e-3 / atol 1e-4 (tests/test_parallel_train.py:372-381);
* a Base-width Mamba-1 mixer and Mamba-2 mixer with ``sp_axis`` the world
  group over a 16-frame clip (L 3136, 784 a rank: K1 / K5 and the chunked
  SSD on each card): output, returned states and gradients (parameter
  gradients all-reduced) within 1e-4 (rel_err) of the one-card mixer.
"""

from __future__ import annotations

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_parallel_train import collect, geom, make_batch, spawn

pytestmark = pytest.mark.cuda
WORLD = 4
MESHES = {"dp1xfsdp2xtp2": {"dp": 1, "fsdp": 2, "tp": 2}, "dp2xfsdp2": {"dp": 2, "fsdp": 2},
          "dp4": {"dp": 4}}
LR, WEIGHT_DECAY = 1e-3, 0.05
SP_LEN = 16 * 196
SP_TOL = 1e-4


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def _model(m2, sd=None):
    from videomamba_tpu_torch.checkpoint import load_state_dict
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba

    model = PretrainVideoMamba(**geom(m2), device="cuda",
                               generator=torch.Generator().manual_seed(0))
    if sd is not None:
        load_state_dict(model, sd)
    return model


def _step(model, batch, mesh=None):
    from videomamba_tpu_torch.parallel import full_state_dict, init_train_state, make_train_step

    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WEIGHT_DECAY)
    if mesh is not None:
        init_train_state(model, opt, mesh=mesh)
    metrics = make_train_step(model, opt)({k: torch.from_numpy(v) for k, v in batch.items()})
    params = {k: v.cpu().numpy() for k, v in full_state_dict(model).items()}
    res = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "params": params}
    if mesh is None:
        res["grads"] = {n: p.grad.cpu().numpy() for n, p in model.named_parameters()}
    return res


def _mixers():
    from videomamba_tpu_torch.models.mamba import Mamba
    from videomamba_tpu_torch.models.mamba2 import Mamba2
    from videomamba_tpu_torch.models.presets import M2_SSM_CFG

    cfg = {k: v for k, v in M2_SSM_CFG.items() if k != "layer"}
    return {"m1": lambda group=None: Mamba(768, sp_axis=group, device="cuda",
                                           generator=torch.Generator().manual_seed(5)),
            "m2": lambda group=None: Mamba2(768, **cfg, sp_axis=group, device="cuda",
                                            generator=torch.Generator().manual_seed(6))}


def _sp_case(mixer, x, cot, states, reduce_grads):
    """Output, new states and gradients of ``mixer`` on ``x`` under ``cot``."""
    x = x.clone().requires_grad_()
    out, (conv, ssm) = mixer(x, state=states, return_state=True)
    grads = torch.autograd.grad(out, [x] + list(mixer.parameters()), cot)
    names = [n for n, _ in mixer.named_parameters()]
    if reduce_grads:
        for g in grads[1:]:
            torch.distributed.all_reduce(g)
    return {"out": out.detach().cpu().numpy(), "conv": conv.detach().cpu().numpy(),
            "ssm": ssm.detach().cpu().numpy(), "dx": grads[0].cpu().numpy(),
            "grads": {n: g.cpu().numpy() for n, g in zip(names, grads[1:])}}


def _worker(rank, world, outdir):
    import torch.distributed as dist

    from videomamba_tpu_torch.parallel import make_mesh
    from videomamba_tpu_torch.utils.distributed import init_distributed_mode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    init_distributed_mode(SimpleNamespace(dist_url=f"file://{outdir}/rdv"))
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    res = {"backend": dist.get_backend(), "card": torch.cuda.current_device()}
    for name, axes in MESHES.items():
        res[name] = _step(_model(False, inp["m1"]), inp["batch"], make_mesh(axes))
    res["m2"] = _step(_model(True, inp["m2"]), inp["batch"], make_mesh(MESHES["dp1xfsdp2xtp2"]))
    g = torch.Generator().manual_seed(7)
    x = torch.randn((1, SP_LEN, 768), generator=g).cuda()
    cot = torch.randn((1, SP_LEN, 768), generator=g).cuda()
    per = SP_LEN // world
    for kind, build in _mixers().items():
        states = build().allocate_state(1)
        res["sp_" + kind] = _sp_case(build(dist.group.WORLD), x[:, rank * per:(rank + 1) * per],
                                     cot[:, rank * per:(rank + 1) * per], states, True)
        if rank == 0:
            res["one_" + kind] = _sp_case(build(), x, cot, states, False)
    if rank == 0:  # the one-card references, on this rank's card
        res["m1_before"] = inp["m1"]
        res["one_m1_step"] = _step(_model(False, inp["m1"]), inp["batch"])
        res["one_m2_step"] = _step(_model(True, inp["m2"]), inp["batch"])
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_cards(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards")
    out = tmp_path_factory.mktemp("nccl4")
    with open(out / "inputs.pkl", "wb") as f:
        sds = {k: {n: t.cpu() for n, t in _model(m2).state_dict().items()}
               for k, m2 in (("m1", False), ("m2", True))}
        pickle.dump({"batch": make_batch(), **sds}, f)
    return collect(spawn(_worker, WORLD, out), WORLD, out)


def _check_metrics(got, want):
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(1.0, abs(want["loss"]))
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-5 * max(1.0, abs(want["grad_norm"]))


def _check_step(got, want, rtol, atol):
    _check_metrics(got, want)
    for name, ref in want["params"].items():
        np.testing.assert_allclose(got["params"][name], ref, rtol=rtol, atol=atol, err_msg=name)


def _check_update(got, want, before):
    """The step's update against the one-card update (module docstring)."""
    _check_metrics(got, want)
    assert set(got["params"]) == set(want["grads"])
    held = total = 0
    for name, g in want["grads"].items():
        p0 = before[name].numpy()
        upd, ref = got["params"][name] - p0, want["params"][name] - p0
        sure = np.abs(g) > 1e-6
        held, total = held + sure.sum(), total + sure.size
        np.testing.assert_allclose(upd[sure], ref[sure], rtol=1e-3, atol=1e-6, err_msg=name)
        bound = LR * (1.0 + WEIGHT_DECAY * np.abs(p0[~sure])) + 1e-6
        assert np.all(np.abs(upd[~sure]) <= bound), name
    assert held > 0.75 * total  # 87 % of this model's elements on the CPU


def test_ranks_hold_a_card_each_over_nccl(four_cards):
    assert [r["card"] for r in four_cards] == list(range(WORLD))
    assert {r["backend"] for r in four_cards} == {"nccl"}


@pytest.mark.parametrize("case", sorted(MESHES))
def test_sharded_step_on_four_cards_matches_one_card(four_cards, case):
    for r in four_cards:
        _check_update(r[case], four_cards[0]["one_m1_step"], four_cards[0]["m1_before"])


def test_mamba2_sharded_step_on_four_cards_matches_one_card(four_cards):
    for r in four_cards:
        _check_step(r["m2"], four_cards[0]["one_m2_step"], 5e-3, 1e-4)


@pytest.mark.parametrize("kind", ["m1", "m2"])
def test_sequence_parallel_mixer_on_four_cards_matches_one_card(four_cards, kind):
    want = four_cards[0]["one_" + kind]
    got = [r["sp_" + kind] for r in four_cards]
    assert rel_err(np.concatenate([g["out"] for g in got], axis=1), want["out"]) <= SP_TOL
    assert rel_err(np.concatenate([g["dx"] for g in got], axis=1), want["dx"]) <= SP_TOL
    for g in got:
        assert rel_err(g["conv"], want["conv"]) <= SP_TOL
        assert rel_err(g["ssm"], want["ssm"]) <= SP_TOL
        for name, ref in want["grads"].items():
            assert rel_err(g["grads"][name], ref) <= SP_TOL, name
