"""The port's selective-scan surface vs videomamba_tpu's on the CPU.

``selective_scan_bld``'s methods and ``chunk_size``, the reference-layout
``selective_scan``, the ``ops`` exports and ``Mamba(scan_chunk_size=...)``,
each held against the JAX function on the same numpy inputs, fp32,
rel_err = max|a - b| / max|b| <= 1e-5. The seven cases of
tests/test_selective_scan.py run here on both packages.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import videomamba_tpu.ops as j_ops
from videomamba_tpu.models.mamba import Mamba as JMamba
from videomamba_tpu.ops.selective_scan import selective_scan as j_scan_ref_layout
from videomamba_tpu.ops.selective_scan import selective_scan_bld as j_scan
from videomamba_tpu.ops.selective_scan import selective_state_update as j_state_update
import videomamba_tpu_torch.ops as t_ops
from videomamba_tpu_torch.models.block import create_block
from videomamba_tpu_torch.models.mamba import Mamba as TMamba
from videomamba_tpu_torch.ops.selective_scan import DEFAULT_CHUNK_SIZE
from videomamba_tpu_torch.ops.selective_scan import selective_scan as t_scan_ref_layout
from videomamba_tpu_torch.ops.selective_scan import selective_scan_bld as t_scan
from videomamba_tpu_torch.ops.selective_scan import selective_state_update as t_state_update

TOL = 1e-5
METHODS = ["chunked", "pallas", "kernel", "ref"]


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def bld_inputs(b=2, L=13, d=32, n=8, seed=4):
    rng = np.random.default_rng(seed)
    return dict(
        u=rng.standard_normal((b, L, d)).astype(np.float32),
        delta=(0.5 * rng.standard_normal((b, L, d))).astype(np.float32),
        A=-np.exp(0.3 * rng.standard_normal((d, n))).astype(np.float32),
        B=rng.standard_normal((b, L, n)).astype(np.float32),
        C=rng.standard_normal((b, L, n)).astype(np.float32),
        D=rng.standard_normal(d).astype(np.float32),
        z=rng.standard_normal((b, L, d)).astype(np.float32),
        delta_bias=rng.standard_normal(d).astype(np.float32),
        initial_state=rng.standard_normal((b, d, n)).astype(np.float32),
    )


@pytest.mark.parametrize("chunk_size", [None, 4])
@pytest.mark.parametrize("method", METHODS)
def test_every_method_matches_jax_chunked(method, chunk_size):
    """Every method, with and without chunk_size=4, against the JAX chunked
    scan at chunk 4 on L = 13 (4 does not divide it)."""
    x = bld_inputs()
    kw = dict(delta_softplus=True, return_last_state=True)
    jy, jh = j_scan(**{k: j(v) for k, v in x.items()}, method="chunked", chunk_size=4, **kw)
    extra = {} if chunk_size is None else {"chunk_size": chunk_size}
    ty, th = t_scan(**{k: t(v) for k, v in x.items()}, method=method, **extra, **kw)
    assert rel_err(ty, jy) <= TOL and rel_err(th, jh) <= TOL


def test_defaults_are_the_jax_ones():
    for fn, jfn in ((t_scan, j_scan), (t_scan_ref_layout, j_scan_ref_layout)):
        params = inspect.signature(fn).parameters
        jparams = inspect.signature(jfn).parameters
        assert params["method"].default == jparams["method"].default == "chunked"
        assert params["chunk_size"].default == jparams["chunk_size"].default
    assert DEFAULT_CHUNK_SIZE == inspect.signature(j_scan).parameters["chunk_size"].default


def test_bad_method_and_chunk_size_raise():
    x = {k: t(v) for k, v in bld_inputs().items()}
    with pytest.raises(ValueError, match="Unknown selective_scan method"):
        t_scan(**x, method="associative")
    with pytest.raises(ValueError, match="chunk_size"):
        t_scan(**x, chunk_size=0)


def test_ops_exports_every_jax_name():
    assert set(j_ops.__all__) <= set(t_ops.__all__)
    from videomamba_tpu_torch.ops import selective_scan

    assert inspect.isfunction(selective_scan)
    for name in ("infer_spatial_grid", "resample_bicubic_2d", "resample_linear_1d"):
        assert callable(getattr(t_ops, name))


def test_mamba_takes_scan_chunk_size_like_jax():
    """A port Mamba and a JAX Mamba with scan_chunk_size=32, weights carried
    across, agree at 1e-5 (L = 45, so the JAX chunk of 32 is ragged); the
    kernel route (here its plain version) and create_block take it too."""
    from test_torch_model import _mixer_state_dict

    jmix = JMamba(d_model=32, use_fast_path=False, scan_chunk_size=32)
    params = jax.tree.map(np.asarray, jmix.init(jax.random.PRNGKey(3)))
    x = np.random.default_rng(8).standard_normal((2, 45, 32)).astype(np.float32)
    want = jmix(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    for fast in (False, True):
        tmix = TMamba(32, use_fast_path=fast, scan_chunk_size=32, device="cpu")
        assert tmix.scan_chunk_size == 32
        tmix.load_state_dict(_mixer_state_dict(params), strict=True)
        with torch.no_grad():
            assert rel_err(tmix(torch.from_numpy(x)), want) <= TOL
    block = create_block(32, ssm_cfg={"scan_chunk_size": 32}, device="cpu")
    assert block.mixer.scan_chunk_size == 32


# ---- the seven cases of tests/test_selective_scan.py, on both packages ----

def ref_layout_inputs(seed, bsz=2, d=8, L=13, n=4, with_all=True):
    rng = np.random.default_rng(seed)
    x = dict(
        u=rng.standard_normal((bsz, d, L)).astype(np.float32),
        delta=(0.5 * rng.standard_normal((bsz, d, L))).astype(np.float32),
        A=-np.exp(0.3 * rng.standard_normal((d, n))).astype(np.float32),
        B=rng.standard_normal((bsz, n, L)).astype(np.float32),
        C=rng.standard_normal((bsz, n, L)).astype(np.float32),
    )
    if with_all:
        x.update(D=rng.standard_normal(d).astype(np.float32),
                 z=rng.standard_normal((bsz, d, L)).astype(np.float32),
                 delta_bias=np.linspace(-0.2, 0.4, d).astype(np.float32))
    return x


def both(x, **kw):
    """The reference-layout scan of both packages on the same inputs."""
    jo = j_scan_ref_layout(**{k: j(v) for k, v in x.items()}, **kw)
    to = t_scan_ref_layout(**{k: t(v) for k, v in x.items()}, **kw)
    return jo, to


@pytest.mark.parametrize("method", ["ref", "chunked"])
def test_matches_numpy_oracle(method):
    x = ref_layout_inputs(0)
    jo, to = both(x, delta_softplus=True, method=method, chunk_size=4)
    assert to.shape == (2, 8, 13)
    assert rel_err(to, jo) <= TOL


@pytest.mark.parametrize("method", ["ref", "chunked"])
def test_initial_state_and_last_state(method):
    x = ref_layout_inputs(1)
    x["initial_state"] = np.random.default_rng(9).standard_normal((2, 8, 4)).astype(np.float32)
    (jy, jh), (ty, th) = both(x, delta_softplus=True, return_last_state=True, method=method,
                              chunk_size=5)
    assert th.dtype == torch.float32 and th.shape == (2, 8, 4)
    assert rel_err(ty, jy) <= TOL and rel_err(th, jh) <= TOL


def test_chunked_equals_ref_when_length_not_divisible():
    x = ref_layout_inputs(2, L=13)
    (jy, jh), (ty, th) = both(x, delta_softplus=True, return_last_state=True,
                              method="chunked", chunk_size=8)
    ry, rh = t_scan_ref_layout(**{k: t(v) for k, v in x.items()}, delta_softplus=True,
                               return_last_state=True, method="ref")
    assert rel_err(ty, jy) <= TOL and rel_err(th, jh) <= TOL
    assert rel_err(ty, ry) <= TOL and rel_err(th, rh) <= TOL


def test_streaming_split_equals_full():
    x = ref_layout_inputs(3, L=12)
    split = 5
    kw = dict(delta_softplus=True, method="chunked", chunk_size=4)
    jfull, tfull = both(x, **kw)
    first = {k: (v[..., :split] if k in ("u", "delta", "B", "C", "z") else v)
             for k, v in x.items()}
    rest = {k: (v[..., split:] if k in ("u", "delta", "B", "C", "z") else v)
            for k, v in x.items()}
    ty1, th = t_scan_ref_layout(**{k: t(v) for k, v in first.items()},
                                return_last_state=True, **kw)
    ty2 = t_scan_ref_layout(**{k: t(v) for k, v in rest.items()}, initial_state=th, **kw)
    stitched = torch.cat([ty1, ty2], dim=-1)
    assert rel_err(stitched, tfull) <= TOL and rel_err(stitched, jfull) <= TOL


def test_gradients_flow_through_state():
    """Gradients of a two-piece scan with carried state (with respect to u
    and h0) against jax.grad of the same function."""
    x = ref_layout_inputs(4, L=10)
    h0 = np.zeros((2, 8, 4), np.float32)
    common = ("A", "D", "delta_bias")

    def pieces(scan, conv, u_, h0_):
        xs = {k: conv(v) for k, v in x.items() if k != "u"}
        head = {k: (xs[k][..., :4] if k not in common else xs[k]) for k in xs}
        tail = {k: (xs[k][..., 4:] if k not in common else xs[k]) for k in xs}
        y1, h = scan(u=u_[..., :4], **head, delta_softplus=True, initial_state=h0_,
                     return_last_state=True)
        y2 = scan(u=u_[..., 4:], **tail, delta_softplus=True, initial_state=h)
        return y1.sum() + y2.sum()

    jgu, jgh = jax.grad(lambda u_, h_: pieces(j_scan_ref_layout, j, u_, h_),
                        argnums=(0, 1))(j(x["u"]), j(h0))
    tu, th0 = t(x["u"]).requires_grad_(True), t(h0).requires_grad_(True)
    pieces(t_scan_ref_layout, t, tu, th0).backward()
    assert torch.isfinite(tu.grad).all() and torch.isfinite(th0.grad).all()
    assert float(tu.grad[..., 0].abs().sum()) > 0.0
    assert rel_err(tu.grad, jgu) <= TOL and rel_err(th0.grad, jgh) <= TOL


def test_bld_layout_agrees_with_reference_layout():
    x = ref_layout_inputs(5)
    jo, to = both(x, delta_softplus=True)
    bld = {k: (np.swapaxes(v, 1, 2) if k in ("u", "delta", "B", "C", "z") else v)
           for k, v in x.items()}
    tb = t_scan(**{k: t(v) for k, v in bld.items()}, delta_softplus=True)
    assert rel_err(tb.transpose(1, 2), to) <= 1e-6
    assert rel_err(to, jo) <= TOL


def test_state_update_matches_length_one_scan():
    x = ref_layout_inputs(6, L=1)
    h0 = np.random.default_rng(7).standard_normal((2, 8, 4)).astype(np.float32)
    x["initial_state"] = h0
    (jy, jh), (ty, th) = both(x, delta_softplus=True, return_last_state=True)
    step = dict(x=x["u"][..., 0], dt=x["delta"][..., 0], A=x["A"], B=x["B"][..., 0],
                C=x["C"][..., 0], D=x["D"], z=x["z"][..., 0], dt_bias=x["delta_bias"])
    ty1, th1 = t_state_update(t(h0), **{k: t(v) for k, v in step.items()}, dt_softplus=True)
    jy1, jh1 = j_state_update(j(h0), **{k: j(v) for k, v in step.items()}, dt_softplus=True)
    assert rel_err(ty1, ty[..., 0]) <= TOL and rel_err(th1, th) <= TOL
    assert rel_err(ty1, jy1) <= TOL and rel_err(th1, jh1) <= TOL
    assert rel_err(ty, jy) <= TOL and rel_err(th, jh) <= TOL


@pytest.mark.parametrize("d,n", [(128, 16), (13, 5), (96, 16), (64, 200), (32, 520)])
def test_kernel_methods_reach_k1_where_the_jax_gate_refuses(d, n, monkeypatch):
    """"chunked", "pallas" and "kernel" launch K1 at every shape, those the
    JAX gate (``pallas_scan_supported``) refuses included (d not a multiple
    of 128, n not a multiple of 8, n above 512): the wrappers' own checks
    run on CPU tensors with the route forced to the kernel and a library
    that does nothing, and none of them refuses, so no method falls back."""
    from videomamba_tpu.ops.pallas.scan import pallas_scan_supported
    from videomamba_tpu_torch.ops import dispatch
    from videomamba_tpu_torch.ops.kernels import _build
    from videomamba_tpu_torch.ops.kernels import scan as k1

    class Library:
        def __getattr__(self, name):
            return lambda *args: 1 if name in _build.SIZE_QUERIES else 0

    monkeypatch.setattr(dispatch, "runs_plain", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: Library())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    x = {k: t(v) for k, v in bld_inputs(b=1, L=9, d=d, n=n).items()}
    slices = -(-n // k1.WALK_STATE)
    for method in ("chunked", "pallas", "kernel"):
        before = k1.selective_scan.launches
        t_scan(**x, delta_softplus=True, method=method)
        assert k1.selective_scan.launches - before == slices, (method, d, n)
    assert pallas_scan_supported(d, n) == (d % 128 == 0 and n % 8 == 0 and n <= 512)
