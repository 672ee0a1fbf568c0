"""The port's tensor-parallel Mamba-1 mixer (2 gloo ranks on the CPU) vs the
same mixer unsplit.

``Mamba.shard_channels`` keeps a rank's d_inner / 2 channels; its forward
is ``models.mamba.channel_parallel`` with the sums all-reduced, and a
decode step all-reduces x_dbl and the output. Each rank runs: the forward,
its gradients (a rank's parameter gradients are its channels' slices,
joined back with ``Mamba.join_channel_slices``; the input's gradient is
all-reduced by the Megatron pair), the streaming state carry, and decoding
through the cache (a prefill, then tokens through ``step``). The parent
holds them against the unsplit mixer (itself held against the JAX package's
in tests/test_torch_model.py and tests/test_torch_sequence_parallel.py), and runs
``tensor_parallel_shards`` (every rank's part in one process) against it.
Bars, phase B's and the JAX mixers': outputs and states 1e-5; gradients
rtol 2e-4 / atol 2e-5 (parts of x_dbl and of the output summed in another
order).
"""

from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_parallel_train import collect, spawn

WORLD = 2
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
PREFILL, TOKENS = 24, 3


def _mixer():
    from videomamba_tpu_torch.models.mamba import Mamba

    return Mamba(16, d_state=8, layer_idx=0, device="cpu",
                 generator=torch.Generator().manual_seed(3))


def _inputs():
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(2, 64, 16), "cot": f(2, 64, 16), "conv": f(2, 32, 4) * 0.5,
            "ssm": f(2, 32, 8) * 0.1}


def _channels(a, rank, world, axis=1):
    return np.split(a, world, axis=axis)[rank]


def _run(m, inp, rank=0, world=1):
    """Everything the parent compares, from mixer ``m`` holding ``rank``'s
    channels of ``world`` (the whole mixer at world 1)."""
    from videomamba_tpu_torch.models.mamba import InferenceCache

    t = torch.from_numpy
    res = {}
    x = t(inp["x"]).requires_grad_()
    out = m(x)
    out.backward(t(inp["cot"]))
    res["out"], res["dx"] = out.detach().numpy(), x.grad.numpy()
    res["grads"] = {n: p.grad.clone() for n, p in m.named_parameters()}
    state = (t(_channels(inp["conv"], rank, world)), t(_channels(inp["ssm"], rank, world)))
    with torch.no_grad():
        out, (conv, ssm) = m(x[:, :40], state=state, return_state=True)
        res["carry"] = (out.numpy(), conv.numpy(), ssm.numpy())
        cache = InferenceCache()
        outs = [m(x[:, :PREFILL], inference_params=cache)]
        for i in range(TOKENS):
            cache.seqlen_offset = PREFILL + i
            outs.append(m(x[:, PREFILL + i:PREFILL + i + 1], inference_params=cache))
        res["decode"] = [o.numpy() for o in outs]
        res["decode_state"] = [s.numpy() for s in cache.key_value_memory_dict[0]]
    return res


def _worker(rank, world, outdir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/rdv", rank=rank,
                            world_size=world)
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    m = _mixer()
    m.shard_channels(dist.group.WORLD)
    res = _run(m, inp, rank, world)
    res["grads"] = {n: g.numpy() for n, g in res["grads"].items()}
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp2")
    inp = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    started = spawn(_worker, WORLD, out)  # the ranks run while the parent computes
    want = _run(_mixer(), inp)
    return want, collect(started, WORLD, out)


def test_tp_mixer_forward_matches_the_unsplit_mixer(two_ranks):
    want, ranks = two_ranks
    for r in ranks:
        np.testing.assert_allclose(r["out"], want["out"], **OUT_TOL)


def test_tp_mixer_gradients_match_the_unsplit_mixer(two_ranks):
    from videomamba_tpu_torch.models.mamba import Mamba

    want, ranks = two_ranks
    joined = Mamba.join_channel_slices(
        [{n: torch.from_numpy(g) for n, g in r["grads"].items()} for r in ranks])
    assert set(joined) == set(want["grads"])
    for name, ref in want["grads"].items():
        np.testing.assert_allclose(joined[name].numpy(), ref.numpy(), err_msg=name, **GRAD_TOL)
    for r in ranks:
        np.testing.assert_allclose(r["dx"], want["dx"], **GRAD_TOL)


def test_tp_mixer_carries_state_like_the_unsplit_mixer(two_ranks):
    want, ranks = two_ranks
    out, conv, ssm = want["carry"]
    for k, r in enumerate(ranks):
        np.testing.assert_allclose(r["carry"][0], out, **OUT_TOL)
        np.testing.assert_allclose(r["carry"][1], _channels(conv, k, WORLD), **OUT_TOL)
        np.testing.assert_allclose(r["carry"][2], _channels(ssm, k, WORLD), **OUT_TOL)


def test_tp_mixer_decodes_like_the_unsplit_mixer(two_ranks):
    """The prefill and every decoded token equal the unsplit mixer's on
    every rank (a step without the all-reduces gives each rank a partial
    output), and the cache holds the rank's channels of the state."""
    want, ranks = two_ranks
    for k, r in enumerate(ranks):
        for got, ref in zip(r["decode"], want["decode"]):
            np.testing.assert_allclose(got, ref, **OUT_TOL)
        for got, ref in zip(r["decode_state"], want["decode_state"]):
            np.testing.assert_allclose(got, _channels(ref, k, WORLD), **OUT_TOL)


@pytest.mark.parametrize("parts", [2, 4])
def test_tensor_parallel_shards_in_one_process(parts):
    """Every rank's part in one process (chip_smoke.py's phase B): the same
    output and, through ``join_channel_slices``, the same gradients; the
    joined parameters are the mixer's, bit for bit."""
    from videomamba_tpu_torch.models.mamba import Mamba, tensor_parallel_shards

    inp = _inputs()
    whole = _mixer()
    shards = [copy.deepcopy(whole).keep_channels(k, parts) for k in range(parts)]
    joined = Mamba.join_channel_slices([dict(s.named_parameters()) for s in shards])
    for name, p in whole.named_parameters():
        assert torch.equal(joined[name], p), name
    cot = torch.from_numpy(inp["cot"])
    x = torch.from_numpy(inp["x"]).requires_grad_()
    out = tensor_parallel_shards(shards, x)
    out.backward(cot)
    x_ref = torch.from_numpy(inp["x"]).requires_grad_()
    ref = whole(x_ref)
    ref.backward(cot)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **OUT_TOL)
    np.testing.assert_allclose(x.grad.numpy(), x_ref.grad.numpy(), **GRAD_TOL)
    grads = Mamba.join_channel_slices([{n: p.grad for n, p in s.named_parameters()}
                                       for s in shards])
    for name, p in whole.named_parameters():
        np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(), err_msg=name,
                                   **GRAD_TOL)
