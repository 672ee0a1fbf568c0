"""The port's sharded train step (4 gloo ranks on the CPU) vs videomamba_tpu.

The JAX test's small model (tests/test_parallel_train.py:45-52: img 16,
patch 8, depth 2, embed 64, 4 frames, batch 8) with the same weights
(exported from the JAX model) and the same numpy batch. One AdamW step
(1e-3, weight decay 0.05) through ``init_train_state(mesh=...)`` and
``make_train_step`` on each mesh, every rank given the global batch; the
whole parameters after it gathered by ``full_state_dict``. The JAX side is
its single-device step, computed in the parent (this module imports no
JAX: the ranks import it). Bars, the JAX test's: loss and grad_norm 1e-5
(relative), parameters rtol 1e-5 / atol 1e-6; Mamba-2 (embed 64, headdim
32, d_state 16, chunk 8) loss and grad_norm 1e-5, parameters rtol 5e-3 /
atol 1e-4 (tests/test_parallel_train.py:363-384).

One spawn of 4 ranks runs every case (a ``file://`` rendezvous under
``tmp_path``; its own timeout) and returns numpy results.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 4
BATCH = 8
TOKENS = 1 + 4 * 2 * 2
EMBED = 64
MESHES = {
    "dp1xfsdp2xtp2": {"dp": 1, "fsdp": 2, "tp": 2},
    "dp2xfsdp2": {"dp": 2, "fsdp": 2},
    "dp4": {"dp": 4},
}
SPAWN_TIMEOUT = 240


def geom(m2=False):
    ssm = ({"layer": "Mamba2", "headdim": 32, "d_state": 16, "chunk_size": 8} if m2
           else {"use_fast_path": True})
    return dict(img_size=16, patch_size=8, depth=2, embed_dim=EMBED, channels=3, ssm_cfg=ssm,
                kernel_size=1, num_frames=4, add_pool_norm=False)


def make_batch():
    rng = np.random.default_rng(0)
    return {"video": rng.standard_normal((BATCH, 3, 4, 16, 16)).astype(np.float32),
            "target": rng.standard_normal((BATCH, TOKENS, EMBED)).astype(np.float32)}


def spawn(worker, world, outdir):
    """Start ``worker(rank, world, outdir)`` on ``world`` processes."""
    return mp.spawn(worker, args=(world, str(outdir)), nprocs=world, join=False), time.monotonic()


def collect(started, world, outdir, timeout=SPAWN_TIMEOUT):
    """Wait for :func:`spawn`'s ranks and load each one's ``rank{r}.pkl``;
    kill them and raise past ``timeout`` s from their start."""
    ctx, t0 = started
    deadline = t0 + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _port_model(sd, m2=False, **ssm):
    from videomamba_tpu_torch.checkpoint import load_state_dict
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba

    g = geom(m2)
    g["ssm_cfg"] = dict(g["ssm_cfg"], **ssm)
    model = PretrainVideoMamba(**g, device="cpu")
    load_state_dict(model, sd)
    return model


def _one_step(sd, batch, mesh, m2=False, **ssm):
    from videomamba_tpu_torch.parallel import full_state_dict, init_train_state, make_train_step

    model = _port_model(sd, m2, **ssm)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
    params, _, _ = init_train_state(model, opt, mesh=mesh)
    metrics = make_train_step(model, opt)({k: torch.from_numpy(v) for k, v in batch.items()})
    same = all(opt.state[p]["exp_avg"].placements == p.placements
               and opt.state[p]["exp_avg_sq"].placements == p.placements
               and opt.state[p]["exp_avg"].to_local().shape == p.to_local().shape
               for p in params.values())
    full = {k: v.numpy() for k, v in full_state_dict(model).items()}
    shards = {n: ([pl.dim if pl.is_shard() else None for pl in p.placements],
                  tuple(p.to_local().shape)) for n, p in params.items()}
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": full, "opt_state_like_params": same, "shards": shards}


def _resume(sd, batch, mesh, outdir, tag, m2=False):
    """Two steps straight through on ``mesh`` against one step, a train
    state saved (gathered whole), loaded into a fresh model and optimizer
    on the same mesh, and the second step; and the same file loaded into
    an unsharded model for the second step."""
    from videomamba_tpu_torch.checkpoint import load_train_state, save_train_state
    from videomamba_tpu_torch.parallel import full_state_dict, init_train_state, make_train_step

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def fresh(placed=True):
        model = _port_model(sd, m2)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
        if placed:
            init_train_state(model, opt, mesh=mesh)
        return model, opt, make_train_step(model, opt)

    model, opt, step = fresh()
    step(tb)
    path = os.path.join(outdir, f"state_{tag}.pt")
    save_train_state(path, model, opt, 1)
    after_one = full_state_dict(model)
    step(tb)
    straight = full_state_dict(model)
    model2, opt2, step2 = fresh()
    n = load_train_state(path, model2, opt2)
    loaded = full_state_dict(model2)
    step2(tb)
    resumed = full_state_dict(model2)
    model3, opt3, step3 = fresh(placed=False)
    load_train_state(path, model3, opt3)
    step3(tb)
    saved = torch.load(path, weights_only=True)
    return {
        "step": n,
        "file_is_whole": all(torch.equal(saved["params"][k], v) for k, v in after_one.items()),
        "loaded_equal": all(torch.equal(loaded[k], v) for k, v in after_one.items()),
        "resumed_equal": all(torch.equal(resumed[k], v) for k, v in straight.items()),
        "unsharded": {k: p.detach().numpy() for k, p in model3.named_parameters()},
        "straight": {k: v.numpy() for k, v in straight.items()},
    }


def _worker(rank, world, outdir):
    import torch.distributed as dist

    from videomamba_tpu_torch.parallel import make_hybrid_mesh, make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/rdv", rank=rank,
                            world_size=world)
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    batch = inputs["batch"]
    res = {}
    for name, axes in MESHES.items():
        res[name] = _one_step(inputs["m1"], batch, make_mesh(axes, "cpu"))
    hybrid = make_hybrid_mesh({"dp": (2, 1), "fsdp": (1, 2)}, "cpu", num_nodes=2)
    res["hybrid"] = _one_step(inputs["m1"], batch, hybrid)
    res["hybrid_ranks"] = hybrid.mesh.tolist()
    tp_mesh = make_mesh(MESHES["dp1xfsdp2xtp2"], "cpu")
    res["no_fast_path"] = _one_step(inputs["m1"], batch, tp_mesh, use_fast_path=False)
    res["m2"] = _one_step(inputs["m2"], batch, tp_mesh, m2=True)
    res["resume"] = {name: _resume(inputs["m1"], batch, make_mesh(MESHES[name], "cpu"), outdir,
                                   name) for name in ("dp1xfsdp2xtp2", "dp2xfsdp2")}
    res["resume"]["m2"] = _resume(inputs["m2"], batch, tp_mesh, outdir, "m2", m2=True)
    if rank:
        for v in res.values():
            if isinstance(v, dict):
                v.pop("params", None)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _jax_single_device(jm, batch):
    import jax
    import jax.numpy as jnp
    import optax

    from videomamba_tpu.parallel import make_train_step as j_make_train_step

    tx = optax.adamw(1e-3, weight_decay=0.05)
    step = j_make_train_step(jm, tx, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params, _, _, metrics = step(jm.params, tx.init(jm.params), jnp.zeros((), jnp.int32), jb,
                                 jax.random.PRNGKey(0))
    return float(metrics["loss"]), float(metrics["grad_norm"]), jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
    from videomamba_tpu_torch.checkpoint import params_from_jax
    from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel

    out = tmp_path_factory.mktemp("parallel_train")
    batch = make_batch()
    models = {key: (JModel(**geom(m2), rng=0), TModel(**geom(m2), device="cpu"))
              for key, m2 in (("m1", False), ("m2", True))}
    sds = {key: params_from_jax(jax.tree.map(np.asarray, jm.params), tm)
           for key, (jm, tm) in models.items()}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({"batch": batch, **sds}, f)
    started = spawn(_worker, WORLD, out)  # the ranks run while JAX computes
    want = {}
    for key, (jm, tm) in models.items():
        loss, gn, params = _jax_single_device(jm, batch)
        want[key] = (loss, gn, params_from_jax(params, tm))
    return want, collect(started, WORLD, out)


def _check(got, want, rtol, atol):
    loss0, gn0, params0 = want
    assert abs(got["loss"] - loss0) <= 1e-5 * max(1.0, abs(loss0))
    assert abs(got["grad_norm"] - gn0) <= 1e-5 * max(1.0, abs(gn0))
    if "params" in got:
        assert set(got["params"]) == set(params0)
        for name, ref in params0.items():
            np.testing.assert_allclose(got["params"][name], ref.numpy(), rtol=rtol, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("case", sorted(MESHES) + ["hybrid"])
def test_sharded_step_matches_jax_single_device(results, case):
    want, ranks = results
    for rank in ranks:
        _check(rank[case], want["m1"], 1e-5, 1e-6)


def test_hybrid_mesh_spans_nodes_with_dp(results):
    """Two nodes of two ranks: dp indexes the node, fsdp stays inside it."""
    _, ranks = results
    assert ranks[0]["hybrid_ranks"] == [[0, 1], [2, 3]]


def test_sharded_step_without_fast_path(results):
    want, ranks = results
    for rank in ranks:
        _check({k: v for k, v in rank["no_fast_path"].items() if k != "params"},
               want["m1"], 1e-5, 1e-6)


def test_mamba2_sharded_step_matches_jax_single_device(results):
    want, ranks = results
    for rank in ranks:
        _check(rank["m2"], want["m2"], 5e-3, 1e-4)


def test_optimizer_state_sharded_like_its_parameters(results):
    _, ranks = results
    for rank in ranks:
        for case in list(MESHES) + ["hybrid", "m2"]:
            assert rank[case]["opt_state_like_params"], case


def test_fsdp_shards_lie_on_the_table_dims(results):
    """Rank 0's FSDP2 shards on {dp 1, fsdp 2, tp 2}: a Mamba-1 mixer's
    tp-local in_proj (128, 64) on its fsdp dim 1, out_proj (64, 64) on dim
    0, A_log (no fsdp dim) on FSDP2's dim 0; a Mamba-2 Block, stored over
    fsdp x tp (4 ranks), on its tp dim, which 4 divides (in_proj (292, 64):
    dim 0; out_proj (64, 128): dim 1)."""
    _, ranks = results
    m1, m2 = ranks[0]["dp1xfsdp2xtp2"]["shards"], ranks[0]["m2"]["shards"]
    assert m1["layers.0.mixer.in_proj.weight"] == ([None, 1], (128, 32))
    assert m1["layers.0.mixer.out_proj.weight"] == ([None, 0], (32, 64))
    assert m1["layers.0.mixer.A_log"] == ([None, 0], (32, 16))
    assert m1["patch_embed.proj.weight"] == ([None, 0], (32, 3, 1, 8, 8))
    assert m2["layers.0.mixer.out_proj.weight"] == ([None, 1], (64, 32))
    assert m2["layers.0.mixer.in_proj.weight"] == ([None, 0], (73, 64))


@pytest.mark.parametrize("case", ["dp1xfsdp2xtp2", "dp2xfsdp2", "m2"])
def test_train_state_resumes_on_the_mesh(results, case):
    """``save_train_state`` on a mesh writes the whole parameters (FSDP2
    shards gathered, Mamba-1 tp channels joined; the Mamba-2 case stored
    over fsdp x tp), ``load_train_state`` puts them and the optimizer's
    states back into each rank's part: the resumed second step is bit-equal
    to the straight one on every rank. The same file resumes an unsharded
    model, at the sharded step's bars against one device (1e-5 / 1e-6;
    Mamba-2 5e-3 / 1e-4)."""
    _, ranks = results
    rtol, atol = (5e-3, 1e-4) if case == "m2" else (1e-5, 1e-6)
    for rank in ranks:
        got = rank["resume"][case]
        assert got["step"] == 1 and got["file_is_whole"] and got["loaded_equal"]
        assert got["resumed_equal"]
        for name, want in got["straight"].items():
            np.testing.assert_allclose(got["unsharded"][name], want, rtol=rtol, atol=atol,
                                       err_msg=name)
