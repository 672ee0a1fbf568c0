"""K4 (whole Block), the bf16 serving path and K2 at bf16 vs videomamba_tpu.

On the CPU the port's wrappers run their plain versions; the JAX package
runs its Pallas kernels in interpret mode (VIDEOMAMBA_PALLAS_INTERPRET=1, as
tests/test_model_fast_path.py does), so its Blocks take the whole-block route
as they do on the TPU. Inputs come from numpy seeds. rel_err is
max|a - b| / max|b|. Bars: 1e-5 at fp32 (the JAX kernels' own), 1e-2 at bf16
(tests/test_remat_and_precision.py:52-66; one bf16 ulp is 2^-8 of the
largest element).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videomamba_tpu.models.block import create_block as j_create_block
from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.ops.pallas.block_fused import block_fused_pallas
from videomamba_tpu.ops.pallas.fused_add_norm import fused_add_norm_pallas
from videomamba_tpu.ops.pallas.mixer_fused import pack_weights
from videomamba_tpu.runtime import StreamingSession as JSession
from videomamba_tpu.utils.precision import cast_params_for_compute
from videomamba_tpu_torch.checkpoint import load_state_dict, params_from_jax
from videomamba_tpu_torch.models.block import create_block as t_create_block
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.ops.kernels.block_fused import block_fused_plain
from videomamba_tpu_torch.ops.kernels.fused_add_norm import fused_add_norm_plain
from videomamba_tpu_torch.runtime import StreamingSession as TSession
from videomamba_tpu_torch.utils.precision import cast_module_for_compute

TOL = {"fp32": 1e-5, "bf16": 1e-2}
JDTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
GEOM = dict(img_size=16, patch_size=8, depth=2, embed_dim=64, channels=3,
            kernel_size=1, num_frames=4, pool_type="avg")


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("VIDEOMAMBA_PALLAS_INTERPRET", "1")


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)  # numpy or JAX, fp32 or bf16


def rel_err(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def block_inputs(seed, b=2, L=37, e=64, di=128, n=16, r=4, w=4):
    """Block operands in the JAX layouts, fp32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def normal(shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f)

    return dict(
        hidden=normal((b, L, e)), residual=normal((b, L, e)),
        norm_w=(1 + normal((e,), 0.1)), norm_b=normal((e,), 0.1),
        win=normal((e, 2 * di), e ** -0.5), wout=normal((di, e), di ** -0.5),
        conv_w=normal((w, di), 0.5), conv_b=normal((di,), 0.1),
        wx=normal((di, r + 2 * n), di ** -0.5), wdt=normal((r, di), 0.3),
        A=-np.exp(normal((di, n), 0.3)), D=normal((di,)),
        dt_bias=np.linspace(-2.0, 0.5, di).astype(f),
        h0=normal((b, di, n), 0.2), conv_state=normal((b, di, w)),
    )


@pytest.mark.parametrize("residual_fp32", [True, False])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_block_fused_plain_matches_pallas(dtype, norm_type, residual_fp32):
    """L = 37 with block_l = 16: the JAX kernel walks three time blocks and
    carries the conv context between them."""
    p = block_inputs(seed=11)
    r, n = p["wdt"].shape[0], p["A"].shape[1]
    jd, td = JDTYPE[dtype], TDTYPE[dtype]
    res_dtype = "fp32" if residual_fp32 else dtype
    cast = ("hidden", "win", "wout", "conv_w", "conv_b", "wx", "wdt")
    j = {k: jnp.asarray(v).astype(jd if k in cast else jnp.float32) for k, v in p.items()}
    j["residual"] = j["residual"].astype(JDTYPE[res_dtype])
    norm_b = j["norm_b"] if norm_type == "layer" else None
    wx_pack, wdt_pack = pack_weights(j["wx"], j["wdt"], r, n)
    jout, jres, jh = block_fused_pallas(
        j["hidden"], j["residual"], j["norm_w"], norm_b, j["win"], j["wout"],
        j["conv_w"], j["conv_b"], wx_pack, wdt_pack, j["A"], j["D"], j["dt_bias"],
        j["h0"], j["conv_state"], norm_rms=norm_type == "rms", eps=1e-5,
        residual_fp32=residual_fp32, block_l=16, interpret=True,
        highest=dtype == "fp32",
    )

    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    t = {k: v.to(td) if k in cast else v for k, v in t.items()}
    t["residual"] = t["residual"].to(TDTYPE[res_dtype])
    # The port takes torch layouts: in (2Di, E), out (E, Di), conv (Di, W),
    # x_proj (R+2N, Di), dt_proj (Di, R).
    out, res_out, h_last = block_fused_plain(
        t["hidden"], t["residual"], t["norm_w"], t["norm_b"] if norm_type == "layer" else None,
        t["win"].t().contiguous(), t["wout"].t().contiguous(), t["conv_w"].t().contiguous(),
        t["conv_b"], t["wx"].t().contiguous(), t["wdt"].t().contiguous(), t["dt_bias"],
        t["A"], t["D"], t["h0"], t["conv_state"], norm_type=norm_type, eps=1e-5,
        residual_fp32=residual_fp32,
    )
    assert out.dtype == td and out.shape == jout.shape
    assert res_out.dtype == (torch.float32 if residual_fp32 else td)
    assert h_last.dtype == torch.float32
    tol = TOL[dtype]
    assert rel_err(out, jout) <= tol
    assert rel_err(res_out, jres) <= tol
    assert rel_err(h_last, jh) <= tol


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("embed_dim", [192, 384, 576, 768])
def test_block_route_follows_jax(embed_dim, dtype):
    """Tiny/Small/Middle/Base widths: K4 everywhere except fp32 Base."""
    jblock = j_create_block(embed_dim)
    jparams = jblock.init(jax.random.PRNGKey(0), dtype=JDTYPE[dtype])
    tblock = t_create_block(embed_dim, dtype=TDTYPE[dtype], device="cpu").eval()
    want = jblock._use_block_fused(jparams)
    assert tblock._use_block_fused() == want
    assert want == (dtype == "bf16" or embed_dim != 768)


def video(frames=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, 3, frames, 16, 16)).astype(np.float32)


_MODELS = {}


def tiny_pair(dtype):
    """(JAX model, port model) on the same weights, JAX bf16 weights from
    cast_params_for_compute and the port's from cast_module_for_compute."""
    if dtype not in _MODELS:
        jm = JModel(**GEOM, rng=0)
        tm = TModel(**GEOM, device="cpu").eval()
        load_state_dict(tm, params_from_jax(jax.tree.map(np.asarray, jm.params), tm))
        if dtype == "bf16":
            jm = JModel(**GEOM, params=cast_params_for_compute(jm.params, jnp.bfloat16),
                        dtype=jnp.bfloat16)
            cast_module_for_compute(tm, torch.bfloat16)
        assert all(layer._use_block_fused() for layer in tm.layers)
        _MODELS[dtype] = (jm, tm)
    return _MODELS[dtype]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_tiny_model_on_block_route_matches_jax(dtype):
    jm, tm = tiny_pair(dtype)
    x = video()
    jv, jp = jm(jnp.asarray(x))
    with torch.no_grad():
        tv, tp = tm(torch.from_numpy(x))
    assert tv.dtype == TDTYPE[dtype] and tv.shape == jv.shape
    assert rel_err(tv, jv) <= TOL[dtype] and rel_err(tp, jp) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_tiny_streaming_on_block_route_matches_jax(dtype):
    """Two 2-frame chunks: chunk 0 carries CLS, chunk 1 the conv window and
    SSM state that the whole-block route returns; states stay fp32."""
    jm, tm = tiny_pair(dtype)
    x = video(seed=3)
    js, ts = JSession(jm, batch_size=2), TSession(tm, batch_size=2)
    for c in range(2):
        chunk = x[:, :, 2 * c:2 * c + 2]
        jv, jp = js.process(jnp.asarray(chunk))
        tv, tp = ts.process(torch.from_numpy(chunk))
        assert rel_err(tv, jv) <= TOL[dtype] and rel_err(tp, jp) <= TOL[dtype]
        for (jc, jss), (tc, tss) in zip(js.state, ts.state):
            assert tc.dtype == torch.float32 and tss.dtype == torch.float32
            assert rel_err(tc, jc) <= TOL[dtype] and rel_err(tss, jss) <= TOL[dtype]


@pytest.mark.parametrize("prenorm,residual_in_fp32,res_dtype",
                         [(True, True, "fp32"), (False, True, "fp32"),
                          (True, False, "bf16"), (False, False, "bf16")])
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
def test_fused_add_norm_plain_bf16_matches_pallas(norm_type, prenorm, residual_in_fp32,
                                                  res_dtype):
    """x in bf16 (a K4 output), the residual fp32 (residual_in_fp32) or bf16."""
    rng = np.random.default_rng(7)
    m, d = 37, 128
    x = rng.standard_normal((m, d)).astype(np.float32)
    res = rng.standard_normal((m, d)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32) if norm_type == "layer" else None
    kw = dict(prenorm=prenorm, residual_in_fp32=residual_in_fp32, eps=1e-5,
              norm_type=norm_type)
    j = fused_add_norm_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias),
        residual=jnp.asarray(res, JDTYPE[res_dtype]), interpret=True, **kw,
    )
    p = fused_add_norm_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
        None if bias is None else torch.from_numpy(bias),
        residual=torch.from_numpy(res).to(TDTYPE[res_dtype]), **kw,
    )
    normed, jnormed = (p[0], j[0]) if prenorm else (p, j)
    assert normed.dtype == torch.bfloat16
    assert rel_err(normed, jnormed) <= TOL["bf16"]
    if prenorm:
        assert p[1].dtype == (torch.float32 if residual_in_fp32 else torch.bfloat16)
        assert rel_err(p[1], j[1]) <= TOL["bf16"]


def _jax_names(tree):
    """Torch state_dict names of a JAX parameter tree's leaves."""
    names = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        path = path.replace("patch_embed.", "patch_embed.proj.").replace(".kernel", ".weight")
        names[path] = leaf.dtype
    return names


def test_cast_module_keeps_the_leaves_jax_keeps_fp32():
    jm = JModel(**GEOM, rng=0)
    tm = cast_module_for_compute(TModel(**GEOM, device="cpu"), torch.bfloat16)
    jnames = _jax_names(cast_params_for_compute(jm.params, jnp.bfloat16))
    tnames = dict(tm.named_parameters())
    assert set(jnames) == set(tnames)
    j_fp32 = {k for k, dt in jnames.items() if dt == jnp.float32}
    t_fp32 = {k for k, p in tnames.items() if p.dtype == torch.float32}
    assert j_fp32 == t_fp32
    assert len(t_fp32) == 11  # A_log, D, dt_proj.bias, norm x 2 layers; norm; pool_norm x 2
    assert all(p.dtype == torch.bfloat16 for k, p in tnames.items() if k not in t_fp32)


def test_params_from_jax_loads_a_bf16_tree_into_a_bf16_model():
    """A bf16 JAX tree loads into a model built at bf16 exactly as the fp32
    weights cast for serving do."""
    jm, tm = tiny_pair("bf16")
    built = TModel(**GEOM, dtype=torch.bfloat16, device="cpu").eval()
    load_state_dict(built, params_from_jax(jax.tree.map(np.asarray, jm.params), built))
    want = tm.state_dict()
    for k, v in built.state_dict().items():
        assert v.dtype == want[k].dtype, k
        assert torch.equal(v, want[k]), k
