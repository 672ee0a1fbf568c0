"""The port's mesh and sharding rules (parallel/mesh.py) vs videomamba_tpu's.

An 8-rank world of torch's in-process fake process group (no collective
runs) carries ``make_mesh({"dp": 1, "fsdp": 4, "tp": 2})``; the JAX side is
its mesh over the 8 virtual CPU devices of tests/conftest.py (a mesh and
its specs need no compile). For every parameter of the JAX test's small
models (tests/test_parallel_train.py:45-52 and its Mamba-2 twin), the
port's placements equal JAX ``param_shardings`` translated to torch's
layouts: each JAX spec dim is found in the torch parameter through
``params_from_jax`` of a tree of element indices, and the shard sizes
match. Then the divisibility fallback, ``batch_sharding``, both hybrid
mesh orderings against ``create_hybrid_device_mesh`` on fake multi-slice
devices, the size check, the exports, and the DTensor refusal of the
kernel wrappers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import PartitionSpec as P

from videomamba_tpu.models.videomamba import PretrainVideoMamba as JModel
from videomamba_tpu.parallel import make_hybrid_mesh as j_make_hybrid_mesh
from videomamba_tpu.parallel import make_mesh as j_make_mesh
from videomamba_tpu.parallel import param_shardings as j_param_shardings
from videomamba_tpu_torch.checkpoint import params_from_jax
from videomamba_tpu_torch.models.videomamba import PretrainVideoMamba as TModel
from videomamba_tpu_torch.parallel import mesh as mesh_lib

from test_parallel_train import _FakeSliceDevice  # a multi-slice device stand-in

EMBED = 64
AXES = {"dp": 1, "fsdp": 4, "tp": 2}


def geom(m2):
    ssm = ({"layer": "Mamba2", "headdim": 32, "d_state": 16, "chunk_size": 8} if m2
           else {"use_fast_path": True})
    return dict(img_size=16, patch_size=8, depth=2, embed_dim=EMBED, channels=3, ssm_cfg=ssm,
                kernel_size=1, num_frames=4, add_pool_norm=False)


@pytest.fixture(scope="module")
def world():
    """An 8-rank fake process group in this process, torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def _torch_dim(index: np.ndarray, jshape, jdim: int) -> int:
    """The torch dim along which the JAX flat index steps along JAX dim
    ``jdim`` (the outermost such dim when a JAX dim was split)."""
    strides = np.cumprod((1,) + tuple(jshape[::-1]))[::-1][1:]
    for d in range(index.ndim):
        if index.shape[d] < 2:
            continue
        at = [0] * index.ndim
        step = index[tuple(at[:d] + [1] + at[d + 1:])] - index[tuple(at)]
        owner = next(j for j, s in enumerate(strides) if step >= s and step % s == 0)
        if owner == jdim:
            return d
    raise AssertionError(f"JAX dim {jdim} has no torch dim")


@pytest.mark.parametrize("m2", [False, True], ids=["mamba", "mamba2"])
def test_placements_equal_jax_param_shardings(world, m2):
    jm = JModel(**geom(m2), rng=0)
    tm = TModel(**geom(m2), device="cpu")
    jmesh = j_make_mesh(AXES, devices=jax.devices()[:8])
    jspecs = jax.tree_util.tree_leaves(j_param_shardings(jm.params, jmesh))
    leaves, treedef = jax.tree_util.tree_flatten(jm.params)
    # Every JAX element gets its own number (exact in fp32 below 2^24), so a
    # torch parameter from params_from_jax names its leaf and its elements.
    offsets = np.cumsum([0] + [leaf.size for leaf in leaves])
    assert offsets[-1] < 2 ** 24
    index_sd = params_from_jax(jax.tree_util.tree_unflatten(treedef, [
        np.arange(o, o + leaf.size, dtype=np.float64).reshape(leaf.shape)
        for o, leaf in zip(offsets, leaves)]), tm)

    tmesh = mesh_lib.make_mesh(AXES, "cpu")
    placements = mesh_lib.param_shardings(tm, tmesh)
    assert set(placements) == set(index_sd) == {n for n, _ in tm.named_parameters()}
    for name, index in index_sd.items():
        index = index.numpy().astype(np.int64)
        leaf = int(np.searchsorted(offsets, index.min(), side="right")) - 1
        index = index - offsets[leaf]
        jshape, jsharding = leaves[leaf].shape, jspecs[leaf]
        want = []
        for axis in tmesh.mesh_dim_names:
            jdim = next((j for j, a in enumerate(jsharding.spec) if a == axis), None)
            want.append(None if jdim is None else _torch_dim(index, jshape, jdim))
        got = [p.dim if isinstance(p, mesh_lib.Shard) else None for p in placements[name]]
        assert got == want, (name, got, want, jsharding.spec)
        tshard = mesh_lib.shard_shape(index.shape, tmesh, placements[name])
        assert int(np.prod(tshard)) == int(np.prod(jsharding.shard_shape(jshape))), name


def test_divisibility_fallback_replicates(world):
    """A (3, 5) in_proj kernel (torch (5, 3)): neither dim divides its axis,
    so both replicate, as JAX P(None, None) (mesh.py:127-146)."""
    jmesh = j_make_mesh(AXES, devices=jax.devices()[:8])
    toy = {"layers": [{"mixer": {"in_proj": {"kernel": np.zeros((3, 5))}}}]}
    assert j_param_shardings(toy, jmesh)["layers"][0]["mixer"]["in_proj"]["kernel"].spec == \
        P(None, None)
    tmesh = mesh_lib.make_mesh(AXES, "cpu")
    got = mesh_lib.placements_for("layers.0.mixer.in_proj.weight", (5, 3), tmesh)
    assert all(isinstance(p, mesh_lib.Replicate) for p in got)


def test_mamba2_head_parameters_shard_over_tp_when_heads_divide(world):
    """Mamba-2's (H,) A_log and D take the (Di, N) rule truncated to one
    dim: sharded over tp when tp divides H, else replicated."""
    tmesh = mesh_lib.make_mesh(AXES, "cpu")
    for name in ("layers.0.mixer.A_log", "layers.0.mixer.D"):
        got = mesh_lib.placements_for(name, (4,), tmesh)
        assert got == (mesh_lib.Replicate(), mesh_lib.Replicate(), mesh_lib.Shard(0))
        got = mesh_lib.placements_for(name, (3,), tmesh)
        assert got == (mesh_lib.Replicate(),) * 3
    got = mesh_lib.placements_for("layers.0.mixer.dt_bias", (4,), tmesh)
    assert got == (mesh_lib.Replicate(),) * 3  # no JAX rule names dt_bias


def test_batch_sharding_covers_data_axes(world):
    jmesh = j_make_mesh({"dp": 2, "fsdp": 2, "tp": 2}, devices=jax.devices()[:8])
    from videomamba_tpu.parallel import batch_sharding as j_batch_sharding

    assert j_batch_sharding(jmesh, "dp", "fsdp").spec == P(("dp", "fsdp"))
    tmesh = mesh_lib.make_mesh({"dp": 2, "fsdp": 2, "tp": 2}, "cpu")
    got = mesh_lib.batch_sharding(tmesh, "dp", "fsdp")
    assert got == (mesh_lib.Shard(0), mesh_lib.Shard(0), mesh_lib.Replicate())
    assert mesh_lib.shard_shape((8, 4), tmesh, got) == (2, 4)
    assert mesh_lib.batch_rows(tmesh, 8) == slice(0, 2)  # rank 0: dp 0, fsdp 0
    assert mesh_lib.replicated(tmesh) == (mesh_lib.Replicate(),) * 3
    with pytest.raises(ValueError, match="divisible"):
        mesh_lib.batch_rows(tmesh, 6)


@pytest.mark.parametrize("factors,per_node", [
    ({"dp": (2, 1), "fsdp": (1, 2), "tp": (1, 2)}, 4),  # 2 nodes x 4
    ({"dp": (4, 1), "tp": (1, 2)}, 2),                  # 4 nodes x 2, all-dcn dp
], ids=["dcn_factoring", "ici_axes_inside_nodes"])
def test_hybrid_mesh_orders_ranks_like_jax(factors, per_node):
    """Synthetic node counts: the dp rows of the rank array are whole
    nodes, and the array equals JAX's device-id array for slices of the
    same size."""
    devs = [_FakeSliceDevice(i, i // per_node) for i in range(8)]
    jmesh = j_make_hybrid_mesh(factors, devices=devs)
    want = np.vectorize(lambda d: d.id)(np.asarray(jmesh.devices))
    dcn = [f[0] for f in factors.values()]
    ici = [f[1] for f in factors.values()]
    got = mesh_lib.hybrid_mesh_ranks(dcn, ici, 8 // per_node, 8)
    np.testing.assert_array_equal(got, want)
    for i in range(got.shape[0]):
        assert {r // per_node for r in got[i].ravel()} == {i}
    assert sorted(got.ravel().tolist()) == list(range(8))


def test_hybrid_mesh_rejects_a_dcn_factoring_that_misses_the_nodes():
    with pytest.raises(ValueError):
        mesh_lib.hybrid_mesh_ranks([4, 1, 1], [1, 1, 2], 2, 8)


def test_hybrid_mesh_on_one_node_is_the_product_mesh(world):
    tmesh = mesh_lib.make_hybrid_mesh({"dp": (2, 1), "fsdp": (1, 2), "tp": (1, 2)}, "cpu",
                                      num_nodes=1)
    assert tmesh.mesh_dim_names == ("dp", "fsdp", "tp")
    assert tuple(tmesh.shape) == (2, 2, 2)


def test_make_mesh_size_must_match_the_world(world):
    with pytest.raises(ValueError) as port:
        mesh_lib.make_mesh({"dp": 2}, "cpu")
    with pytest.raises(ValueError) as jax_err:
        j_make_mesh({"dp": 2}, devices=jax.devices()[:8])
    assert str(port.value) == str(jax_err.value)


def test_parallel_exports_cover_the_jax_package():
    import videomamba_tpu.parallel
    import videomamba_tpu_torch.parallel

    missing = set(videomamba_tpu.parallel.__all__) - set(videomamba_tpu_torch.parallel.__all__)
    assert not missing


def test_kernel_wrappers_refuse_a_dtensor(world):
    """shard_params gives DTensors; a wrapper raises on one, on either
    route, instead of converting it."""
    from videomamba_tpu_torch.ops import dispatch
    from videomamba_tpu_torch.ops.kernels import _build
    from videomamba_tpu_torch.ops.kernels.scan import selective_scan

    tm = TModel(**geom(False), device="cpu")
    tmesh = mesh_lib.make_mesh(AXES, "cpu")
    sharded = mesh_lib.shard_params(tm, tmesh)
    d = sharded["layers.0.mixer.D"]
    assert type(d).__name__ == "DTensor"
    with pytest.raises(TypeError, match="DTensor"):
        dispatch.runs_plain(d)
    with pytest.raises(TypeError, match="DTensor"):
        _build.check_operands("k", torch.device("cpu"), {"D": (d, tuple(d.shape))})
    u = torch.zeros(1, 4, 128)
    with pytest.raises(TypeError, match="DTensor"):
        selective_scan(sharded["layers.0.mixer.x_proj.weight"], u, torch.zeros(128, 16),
                       u[..., :16], u[..., :16], None, None, None, torch.zeros(1, 128, 16))
