"""The port's utils/distributed.py vs videomamba_tpu's.

Rank discovery under each launcher's environment (``monkeypatch``; the
process group's start and the master-only logging switch are recorded, not
run), the SLURM_TASKS_PER_NODE grammar, port probing and ``save_on_master``
against the JAX functions; then, at 2 gloo ranks (a ``file://`` rendezvous
under ``tmp_path``), the collectives: the gradient of a gathered,
rank-weighted sum equals the JAX ``all_gather`` transpose (``jax.grad``
through ``shard_map`` on 2 virtual CPU devices), the no-gradient gather,
``all_reduce_mean``, and the differentiable halo shift and Megatron pair.
"""

from __future__ import annotations

import os
import pickle
import socket
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_parallel_train import collect, spawn

ENVS = {
    "torchrun": {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1"},
    "slurm_ntasks": {"SLURM_PROCID": "5", "SLURM_LOCALID": "1", "SLURM_NTASKS": "16"},
    "slurm_tasks_per_node": {"SLURM_PROCID": "5", "SLURM_LOCALID": "1",
                             "SLURM_TASKS_PER_NODE": "4(x2),8"},
    "slurm_nnodes": {"SLURM_PROCID": "1", "SLURM_LOCALID": "1", "SLURM_NNODES": "2"},
    "none": {},
}
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "SLURM_LOCALID",
               "SLURM_NTASKS", "SLURM_TASKS_PER_NODE", "SLURM_NNODES", "SLURM_JOB_ID")


@pytest.mark.parametrize("spec", ["8", "16(x2)", "16(x2),8", " 4 , 2(x3)", "1(x1)"])
def test_parse_slurm_tasks_per_node_matches_jax(spec):
    from videomamba_tpu.utils.distributed import _parse_slurm_tasks_per_node as j_parse
    from videomamba_tpu_torch.utils.distributed import _parse_slurm_tasks_per_node

    assert _parse_slurm_tasks_per_node(spec) == j_parse(spec)


@pytest.mark.parametrize("spec", ["garbage", "8,", "(x2)", "4(x)"])
def test_parse_slurm_tasks_per_node_refuses_what_jax_refuses(spec):
    from videomamba_tpu.utils.distributed import _parse_slurm_tasks_per_node as j_parse
    from videomamba_tpu_torch.utils.distributed import _parse_slurm_tasks_per_node

    with pytest.raises(ValueError, match="Unsupported"):
        j_parse(spec)
    with pytest.raises(ValueError, match="Unsupported"):
        _parse_slurm_tasks_per_node(spec)


def _discover(monkeypatch, env, **args):
    """Both packages' init_distributed_mode under ``env``: their args, and
    what the port asked of torch (process group, card)."""
    import jax

    import videomamba_tpu.utils.distributed as jd
    import videomamba_tpu_torch.utils.distributed as td

    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: calls.append(("jax", kw)))
    monkeypatch.setattr(jd, "setup_for_distributed", lambda m: calls.append(("jax_master", m)))
    monkeypatch.setattr(td, "setup_for_distributed", lambda m: calls.append(("master", m)))
    monkeypatch.setattr(td.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(td.dist, "barrier", lambda *a, **k: None)
    monkeypatch.setattr(td.torch.cuda, "set_device", lambda d: calls.append(("card", d)))
    j_args, t_args = SimpleNamespace(**args), SimpleNamespace(**args)
    jd.init_distributed_mode(j_args)
    td.init_distributed_mode(t_args)
    return j_args, t_args, calls


@pytest.mark.parametrize("launcher", sorted(ENVS))
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_rank_discovery_matches_jax(monkeypatch, launcher, device):
    j_args, t_args, calls = _discover(monkeypatch, ENVS[launcher], device=device)
    keys = ("rank", "world_size", "gpu", "distributed")
    assert {k: getattr(t_args, k, None) for k in keys} == \
        {k: getattr(j_args, k, None) for k in keys}
    started = [c for c in calls if c[0] in ("nccl", "gloo")]
    if not t_args.distributed:
        assert not started
        return
    backend, kw = started[0]
    assert backend == ("gloo" if device == "cpu" else "nccl")
    assert (kw["rank"], kw["world_size"]) == (t_args.rank, t_args.world_size)
    assert ("card", t_args.gpu) in calls if device == "cuda" else ("card", t_args.gpu) not in calls
    assert ("master", t_args.rank == 0) in calls


def test_tcp_url_port_probing_matches_jax(monkeypatch):
    """A port in use moves up in steps of 10, in both packages."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as busy:
        busy.bind(("localhost", 0))
        busy.listen(1)
        port = busy.getsockname()[1]
        url = f"tcp://localhost:{port}"
        j_args, t_args, calls = _discover(monkeypatch, ENVS["torchrun"], dist_url=url,
                                          device="cpu")
    assert t_args.dist_url == j_args.dist_url != url
    assert int(t_args.dist_url.rsplit(":", 1)[1]) % 10 == port % 10
    assert [kw["init_method"] for b, kw in calls if b == "gloo"] == [t_args.dist_url]


def test_save_on_master(monkeypatch):
    import videomamba_tpu_torch.utils.distributed as td

    assert td.get_rank() == 0 and td.get_world_size() == 1 and td.is_main_process()
    assert td.save_on_master(lambda a, b=0: a + b, 2, b=3) == 5
    monkeypatch.setattr(td, "get_rank", lambda group=None: 1)
    assert td.save_on_master(lambda: pytest.fail("saved off the master")) is None


def _worker(rank, world, outdir):
    import torch.distributed as dist

    from videomamba_tpu_torch.utils import distributed as td

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/rdv", rank=rank,
                            world_size=world)
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    res = {}
    x = torch.from_numpy(inp["x"][rank]).requires_grad_()
    gathered = td.gather_tensor_along_batch_with_backward(x)
    (gathered * torch.from_numpy(inp["w"][rank])).sum().backward()
    res["gathered"], res["grad"] = gathered.detach().numpy(), x.grad.numpy()
    plain = td.gather_tensor_along_batch(x, dim=1)
    res["plain"], res["plain_grad"] = plain.numpy(), plain.requires_grad
    res["mean"] = td.all_reduce_mean(torch.tensor([rank + 1.0, 2.0 * rank])).numpy()
    y = x.detach().clone().requires_grad_()
    shifted = td.shift_to_next(y)
    (shifted * (rank + 2.0)).sum().backward()
    res["shifted"], res["shift_grad"] = shifted.detach().numpy(), y.grad.numpy()
    z = torch.from_numpy(inp["x"][0]).requires_grad_()  # replicated input
    part = td.copy_to_group(z) * (rank + 1.0)  # this rank's slice of the weights
    total = td.reduce_from_group(part)
    (total * total).sum().backward()
    res["reduced"], res["copy_grad"] = total.detach().numpy(), z.grad.numpy()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist2")
    rng = np.random.default_rng(0)
    inp = {"x": rng.standard_normal((2, 3, 5)).astype(np.float32),
           "w": rng.standard_normal((2, 6, 5)).astype(np.float32)}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    started = spawn(_worker, 2, out)
    return inp, _jax_gather_grad(inp), collect(started, 2, out)


def _jax_gather_grad(inp):
    """d/dx of sum_r sum(all_gather(x)_r * w_r) on 2 devices: the JAX
    all_gather's transpose (utils/distributed.py:158-167)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from videomamba_tpu.utils.distributed import gather_tensor_along_batch_with_backward

    mesh = Mesh(np.array(jax.devices()[:2]), ("b",))

    def loss(x, w):
        def local(xl, wl):
            g = gather_tensor_along_batch_with_backward(xl[0], "b")
            return jax.lax.psum(jnp.sum(g * wl[0]), "b")
        return jax.shard_map(local, mesh=mesh, in_specs=(P("b"), P("b")), out_specs=P(),
                             check_vma=False)(x, w)

    return np.asarray(jax.grad(loss)(jnp.asarray(inp["x"]), jnp.asarray(inp["w"])))


def test_gather_with_backward_is_the_jax_all_gather_transpose(two_ranks):
    inp, want, ranks = two_ranks
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["gathered"], inp["x"].reshape(6, 5))
        np.testing.assert_allclose(res["grad"], want[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["grad"], inp["w"][:, 3 * r:3 * r + 3].sum(0),
                                   rtol=1e-6, atol=1e-6)


def test_gather_without_gradient(two_ranks):
    inp, _, ranks = two_ranks
    for res in ranks:
        np.testing.assert_array_equal(res["plain"], np.concatenate(inp["x"], axis=1))
        assert res["plain_grad"] is False


def test_all_reduce_mean(two_ranks):
    _, _, ranks = two_ranks
    for res in ranks:
        np.testing.assert_allclose(res["mean"], [1.5, 1.0])


def test_shift_to_next_and_its_backward(two_ranks):
    """Rank 1 gets rank 0's tensor, rank 0 zeros; the cotangent goes back:
    rank 0's input gets rank 1's weight, rank 1's gets nothing."""
    inp, _, ranks = two_ranks
    np.testing.assert_array_equal(ranks[0]["shifted"], np.zeros((3, 5), np.float32))
    np.testing.assert_array_equal(ranks[1]["shifted"], inp["x"][0])
    np.testing.assert_allclose(ranks[0]["shift_grad"], np.full((3, 5), 3.0))
    np.testing.assert_allclose(ranks[1]["shift_grad"], np.zeros((3, 5)))


def test_megatron_pair(two_ranks):
    """A replicated z through rank r's weight r + 1: total = 3 z on both
    ranks (reduce_from_group), and the gradient of sum(total^2) with respect
    to z is 2 total 3 on both (copy_to_group sums the ranks' parts)."""
    inp, _, ranks = two_ranks
    total = 3.0 * inp["x"][0]
    for res in ranks:
        np.testing.assert_allclose(res["reduced"], total, rtol=1e-6)
        np.testing.assert_allclose(res["copy_grad"], 6.0 * total, rtol=1e-5)
