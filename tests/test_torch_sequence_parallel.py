"""The port's sequence parallelism (2 and 4 gloo ranks on the CPU) vs
videomamba_tpu's single-device scans and mixers.

tests/test_sequence_parallel.py and tests/test_sequence_parallel_m2.py at 2
and 4 time shards instead of 8 devices: the same shapes (B=2, L=64, D=16,
N=8; SSD H=4, P=8, G=2), the same numpy inputs on both sides, the mixers
with the JAX mixers' weights. Every rank runs its shard through
``sequence_parallel_scan`` / ``_ssd`` and ``Mamba(sp_axis=group)`` /
``Mamba2(sp_axis=group)``; the parent joins the shards. Parameter
gradients are each rank's share, all-reduced here (the caller's
reduction). The JAX side runs in the parent (this module imports no JAX:
the ranks import it). Bars, the JAX tests': scans 2e-4; mixers and state
carry 1e-5; gradients rtol 2e-4 / atol 2e-5. The ``*_shards`` functions
(every shard in one process) are held to the same numbers.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_parallel_train import collect, spawn

WORLDS = (2, 4)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
MIXER_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def scan_inputs(seed, bsz=2, L=64, d=16, n=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"u": f(bsz, L, d), "delta": f(bsz, L, d) * 0.3,
            "A": -np.exp(f(d, n) * 0.3), "B": f(bsz, L, n), "C": f(bsz, L, n), "D": f(d),
            "z": f(bsz, L, d), "delta_bias": np.linspace(-0.1, 0.2, d).astype(np.float32),
            "h0": f(bsz, d, n) * 0.1}


def ssd_inputs(seed, bsz=2, L=64, h=4, p=8, g=2, n=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(bsz, L, h, p), "dt": f(bsz, L, h) * 0.3, "A": -np.exp(f(h) * 0.3),
            "B": f(bsz, L, g, n), "C": f(bsz, L, g, n), "D": f(h),
            "dt_bias": np.linspace(-0.1, 0.2, h).astype(np.float32), "h0": f(bsz, h, p, n) * 0.1}


def mixer_inputs(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((2, 64, 16)).astype(np.float32),
            "x1": rng.standard_normal((1, 64, 16)).astype(np.float32)}


def _port_mixer(kind, sd, group=None):
    from videomamba_tpu_torch.models.mamba import Mamba
    from videomamba_tpu_torch.models.mamba2 import Mamba2

    if kind == "m1":
        m = Mamba(16, d_state=8, sp_axis=group, device="cpu")
    else:
        m = Mamba2(16, d_state=8, headdim=8, chunk_size=8, sp_axis=group, device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shard(a, k, num):
    return _t(np.split(a, num, axis=1)[k])


def _loss(out):
    return (out * torch.cos(out)).sum()


def _worker(rank, world, outdir):
    import torch.distributed as dist

    from videomamba_tpu_torch.parallel import sequence_parallel_scan, sequence_parallel_ssd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/rdv", rank=rank,
                            world_size=world)
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    res = {}
    s = inp["scan"]
    sh = {k: _shard(s[k], rank, world) for k in ("u", "delta", "B", "C", "z")}
    res["scan"] = [t.numpy() for t in sequence_parallel_scan(
        sh["u"], sh["delta"], _t(s["A"]), sh["B"], sh["C"], D=_t(s["D"]), z=sh["z"],
        delta_bias=_t(s["delta_bias"]), delta_softplus=True, initial_state=_t(s["h0"]))]
    res["scan_bare"] = sequence_parallel_scan(
        sh["u"], sh["delta"], _t(s["A"]), sh["B"], sh["C"], delta_softplus=True)[0].numpy()
    s = inp["ssd"]
    sh = {k: _shard(s[k], rank, world) for k in ("x", "dt", "B", "C")}
    res["ssd"] = [t.numpy() for t in sequence_parallel_ssd(
        sh["x"], sh["dt"], _t(s["A"]), sh["B"], sh["C"], D=_t(s["D"]),
        dt_bias=_t(s["dt_bias"]), initial_state=_t(s["h0"]), chunk_size=8)]
    res["ssd_bare"] = sequence_parallel_ssd(
        sh["x"], sh["dt"], _t(s["A"]), sh["B"], sh["C"], chunk_size=8)[0].numpy()
    x = inp["mixer_x"]
    for kind in ("m1", "m2"):
        m = _port_mixer(kind, inp[kind]["sd"], dist.group.WORLD)
        with torch.no_grad():
            res[kind + "_out"] = m(_shard(x["x"], rank, world)).numpy()
            state = tuple(_t(t) for t in inp[kind]["state"])
            out, (conv, ssm) = m(_shard(x["x1"], rank, world), state=state, return_state=True)
            res[kind + "_carry"] = (out.numpy(), conv.numpy(), ssm.numpy())
        xs = _shard(x["x1"], rank, world).requires_grad_()
        _loss(m(xs)).backward()
        grads = {}
        for name, p in m.named_parameters():
            dist.all_reduce(p.grad)
            grads[name] = p.grad.numpy()
        res[kind + "_grads"] = (grads, xs.grad.numpy())
        try:
            m(torch.zeros((1, 2, 16)))  # 2 steps < d_conv 4
            res[kind + "_short"] = None
        except ValueError as e:
            res[kind + "_short"] = str(e)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _mixer_sd(tree):
    from videomamba_tpu_torch.checkpoint import _block_params, _putter

    sd = {}
    _block_params({"norm": {"weight": np.ones(1)}, "mixer": tree}, "", _putter(sd))
    return {k[len("mixer."):]: v.numpy() for k, v in sd.items() if k.startswith("mixer.")}


def _jax_refs(inp, mixers):
    """The JAX single-device numbers: scans, mixers, streaming, gradients."""
    import jax
    import jax.numpy as jnp

    from videomamba_tpu.ops.selective_scan import selective_scan_bld
    from videomamba_tpu.ops.ssd import ssd_chunked

    s = inp["scan"]
    want = {"scan": jax.jit(lambda u, d, a, b, c, dd, z, db, h0: selective_scan_bld(
        u, d, a, b, c, dd, z=z, delta_bias=db, delta_softplus=True, initial_state=h0,
        return_last_state=True))(*(s[k] for k in ("u", "delta", "A", "B", "C", "D", "z",
                                                  "delta_bias", "h0")))}
    want["scan_bare"] = jax.jit(lambda u, d, a, b, c: selective_scan_bld(
        u, d, a, b, c, delta_softplus=True))(*(s[k] for k in ("u", "delta", "A", "B", "C")))
    s = inp["ssd"]
    want["ssd"] = jax.jit(lambda x, dt, a, b, c, dd, db, h0: ssd_chunked(
        x, dt, a, b, c, D=dd, dt_bias=db, dt_softplus=True, initial_state=h0,
        return_last_state=True, chunk_size=16))(*(s[k] for k in ("x", "dt", "A", "B", "C", "D",
                                                                 "dt_bias", "h0")))
    want["ssd_bare"] = jax.jit(lambda x, dt, a, b, c: ssd_chunked(
        x, dt, a, b, c, dt_softplus=True, chunk_size=8))(*(s[k] for k in ("x", "dt", "A", "B",
                                                                          "C")))
    x = inp["mixer_x"]
    for kind, (jmix, params) in mixers.items():
        want[kind + "_out"] = jax.jit(jmix)(params, x["x"])
        want[kind + "_carry"] = jax.jit(lambda p, xx, st: jmix(p, xx, state=st, return_state=True))(
            params, x["x1"], tuple(inp[kind]["state"]))

        def loss(p, xx):
            out = jmix(p, xx)
            return jnp.sum(out * jnp.cos(out))

        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x["x1"])
        want[kind + "_grads"] = (_mixer_sd(jax.tree.map(np.asarray, gp)), gx)
    return jax.tree.map(np.asarray, want)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from videomamba_tpu.models.mamba import Mamba as JMamba
    from videomamba_tpu.models.mamba2 import Mamba2 as JMamba2

    mixers = {"m1": JMamba(d_model=16, d_state=8, use_fast_path=False),
              "m2": JMamba2(d_model=16, d_state=8, headdim=8, chunk_size=8, use_fast_path=False)}
    mixers = {k: (m, m.init(jax.random.PRNGKey(3))) for k, m in mixers.items()}
    x = mixer_inputs(0)
    inp = {"scan": scan_inputs(0), "ssd": ssd_inputs(0), "mixer_x": x}
    rng = np.random.default_rng(1)
    for kind, (jmix, params) in mixers.items():
        # A carried state: random windows and SSM states of the streaming shapes.
        state = [(rng.standard_normal(t.shape) * scale).astype(np.float32)
                 for t, scale in zip(jmix.allocate_state(1), (1.0, 0.1))]
        inp[kind] = {"sd": _mixer_sd(jax.tree.map(np.asarray, params)), "state": state}
    started = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"sp{world}")
        with open(out / "inputs.pkl", "wb") as f:
            pickle.dump(inp, f)
        started[world] = (spawn(_worker, world, out), out)
    want = _jax_refs(inp, mixers)
    got = {world: collect(s, world, out) for world, (s, out) in started.items()}
    return inp, want, got


def _cat(ranks, key, index=None):
    parts = [r[key] if index is None else r[key][index] for r in ranks]
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_scan_matches_single_device(results, world):
    _, want, got = results
    np.testing.assert_allclose(_cat(got[world], "scan", 0), want["scan"][0], **SCAN_TOL)
    for r in got[world]:
        np.testing.assert_allclose(r["scan"][1], want["scan"][1], **SCAN_TOL)
    np.testing.assert_allclose(_cat(got[world], "scan_bare"), want["scan_bare"], **SCAN_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_ssd_matches_single_device(results, world):
    _, want, got = results
    np.testing.assert_allclose(_cat(got[world], "ssd", 0), want["ssd"][0], **SCAN_TOL)
    for r in got[world]:
        np.testing.assert_allclose(r["ssd"][1], want["ssd"][1], **SCAN_TOL)
    np.testing.assert_allclose(_cat(got[world], "ssd_bare"), want["ssd_bare"], **SCAN_TOL)


@pytest.mark.parametrize("kind", ["m1", "m2"])
@pytest.mark.parametrize("world", WORLDS)
def test_sp_mixer_matches_single_device(results, world, kind):
    _, want, got = results
    np.testing.assert_allclose(_cat(got[world], kind + "_out"), want[kind + "_out"],
                               **MIXER_TOL)


@pytest.mark.parametrize("kind", ["m1", "m2"])
@pytest.mark.parametrize("world", WORLDS)
def test_sp_mixer_state_carry_matches_streaming(results, world, kind):
    _, want, got = results
    out, (conv, ssm) = want[kind + "_carry"]
    np.testing.assert_allclose(_cat(got[world], kind + "_carry", 0), out, **MIXER_TOL)
    for r in got[world]:
        np.testing.assert_allclose(r[kind + "_carry"][1], conv, **MIXER_TOL)
        np.testing.assert_allclose(r[kind + "_carry"][2], ssm, **MIXER_TOL)


@pytest.mark.parametrize("kind", ["m1", "m2"])
@pytest.mark.parametrize("world", WORLDS)
def test_sp_mixer_gradients_match_single_device(results, world, kind):
    _, want, got = results
    gp_want, gx_want = want[kind + "_grads"]
    for r in got[world]:
        gp, _ = r[kind + "_grads"]
        assert set(gp) == set(gp_want)
        for name, g in gp_want.items():
            np.testing.assert_allclose(gp[name], g, err_msg=name, **GRAD_TOL)
    gx = np.concatenate([r[kind + "_grads"][1] for r in got[world]], axis=1)
    np.testing.assert_allclose(gx, gx_want, **GRAD_TOL)


@pytest.mark.parametrize("kind", ["m1", "m2"])
@pytest.mark.parametrize("world", WORLDS)
def test_sp_mixer_rejects_short_shards(results, world, kind):
    _, _, got = results
    for r in got[world]:
        assert r[kind + "_short"] is not None and "d_conv" in r[kind + "_short"]


def test_sp_axis_takes_a_process_group_not_a_name():
    from videomamba_tpu_torch.models.mamba import Mamba
    from videomamba_tpu_torch.models.mamba2 import Mamba2

    for cls in (Mamba, Mamba2):
        with pytest.raises(TypeError, match="process group"):
            cls(16, sp_axis="sp", device="cpu")


@pytest.mark.parametrize("num", [2, 4])
def test_per_rank_functions_in_one_process(results, num):
    """The ``*_shards`` functions: the ranks' arithmetic for every shard in
    one process, the collectives a stack and a list shift."""
    from videomamba_tpu_torch.parallel import sequence as sp

    inp, want, _ = results
    s = {k: _t(v) for k, v in inp["scan"].items()}
    out, h_last = sp.sequence_parallel_scan_shards(
        s["u"], s["delta"], s["A"], s["B"], s["C"], D=s["D"], z=s["z"],
        delta_bias=s["delta_bias"], delta_softplus=True, initial_state=s["h0"], num_shards=num)
    np.testing.assert_allclose(out.numpy(), want["scan"][0], **SCAN_TOL)
    np.testing.assert_allclose(h_last.numpy(), want["scan"][1], **SCAN_TOL)
    s = {k: _t(v) for k, v in inp["ssd"].items()}
    for method in ("chunked", "pallas"):
        out, h_last = sp.sequence_parallel_ssd_shards(
            s["x"], s["dt"], s["A"], s["B"], s["C"], D=s["D"], dt_bias=s["dt_bias"],
            initial_state=s["h0"], num_shards=num, chunk_size=8, method=method)
        np.testing.assert_allclose(out.numpy(), want["ssd"][0], **SCAN_TOL)
        np.testing.assert_allclose(h_last.numpy(), want["ssd"][1], **SCAN_TOL)
    x = inp["mixer_x"]
    for kind, fn in (("m1", sp.sequence_parallel_mixer_shards),
                     ("m2", sp.sequence_parallel_mixer_m2_shards)):
        m = _port_mixer(kind, inp[kind]["sd"])
        with torch.no_grad():
            np.testing.assert_allclose(fn(m, _t(x["x"]), num).numpy(), want[kind + "_out"],
                                       **MIXER_TOL)
            state = tuple(_t(t) for t in inp[kind]["state"])
            out, (conv, ssm) = fn(m, _t(x["x1"]), num, state=state, return_state=True)
        w_out, (w_conv, w_ssm) = want[kind + "_carry"]
        for a, b in ((out, w_out), (conv, w_conv), (ssm, w_ssm)):
            np.testing.assert_allclose(a.numpy(), b, **MIXER_TOL)
        xs = _t(x["x1"]).requires_grad_()
        _loss(fn(m, xs, num)).backward()
        gp_want, gx_want = want[kind + "_grads"]
        for name, p in m.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), gp_want[name], err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(xs.grad.numpy(), gx_want, **GRAD_TOL)
