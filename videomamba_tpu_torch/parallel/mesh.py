"""Device mesh and sharding rules over ``torch.distributed``.

Port of videomamba_tpu/parallel/mesh.py. A mesh is a named
``torch.distributed.device_mesh.DeviceMesh`` over the process group, one
rank a card; its axes keep the JAX package's names and roles:

  dp    pure data parallelism (batch rows; gradients averaged)
  fsdp  ZeRO-3 parameter sharding (also carries batch rows): FSDP2's
        ``fully_shard`` all-gathers a Block's parameters before its forward
        and reduce-scatters its gradients (parallel/train_step.py)
  tp    tensor parallelism over d_inner: a Mamba-1 mixer holds its d_inner /
        tp channels, column-parallel in_proj, conv, dt_proj, A_log and D,
        row-parallel x_proj and out_proj, with explicit all-reduces
        (models/mamba.py)

:func:`param_shardings` gives each parameter its placements, one
``Shard(dim)`` or ``Replicate()`` a mesh axis: the JAX rules (mesh.py:
92-107) in torch's layouts, where a product's weight is (out, in), so the
JAX ``kernel`` (in, out) specs transpose.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

Placements = Tuple[object, ...]


def make_mesh(axis_sizes: Dict[str, int], device_type: str = "cuda") -> DeviceMesh:
    """A named mesh over every rank, e.g. ``make_mesh({"dp": 2, "fsdp": 2,
    "tp": 2})``; axes in insertion order, sizes multiplying to the world
    size. Put the axis that talks most (tp) last: neighbouring ranks, the
    cards of one node. ``device_type="cpu"`` for a gloo group."""
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(v) for v in axis_sizes.values())
    n = int(np.prod(sizes))
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"Mesh size {n} ({dict(axis_sizes)}) != device count {world}.")
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def hybrid_mesh_ranks(dcn: Sequence[int], ici: Sequence[int], num_nodes: int,
                      world: int) -> np.ndarray:
    """The ranks of a multi-node mesh, shaped (dcn_i * ici_i, ...): node s
    holds ranks s * per_node ... (s + 1) * per_node - 1 (torchrun's and
    SLURM's block placement); each axis index is dcn_index * ici_i +
    ici_index, so the dcn part of an axis spans nodes and its ici part stays
    inside one (``mesh_utils.create_hybrid_device_mesh``)."""
    if int(np.prod(dcn)) != num_nodes:
        raise ValueError(
            f"Number of nodes {num_nodes} must equal the product of the dcn factors {tuple(dcn)}")
    if world % num_nodes or int(np.prod(ici)) != world // num_nodes:
        raise ValueError(
            f"{world} ranks over {num_nodes} nodes do not fill the ici factors {tuple(ici)}")
    nd = len(dcn)
    arr = np.arange(world).reshape(tuple(dcn) + tuple(ici))
    order = [i for pair in zip(range(nd), range(nd, 2 * nd)) for i in pair]
    return arr.transpose(order).reshape(tuple(d * i for d, i in zip(dcn, ici)))


def _num_nodes(world: int) -> int:
    """Nodes of this job: the world over torchrun's LOCAL_WORLD_SIZE, else
    SLURM_NNODES, else 1."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return world // int(os.environ["LOCAL_WORLD_SIZE"])
    return int(os.environ.get("SLURM_NNODES", 1))


def make_hybrid_mesh(axis_factors: Dict[str, Tuple[int, int]], device_type: str = "cuda",
                     num_nodes: Optional[int] = None) -> DeviceMesh:
    """Multi-node mesh: per-axis (dcn, ici) factors, (across nodes, within
    a node), e.g. ``make_hybrid_mesh({"dp": (2, 1), "fsdp": (1, 4), "tp":
    (1, 2)})`` for 2 nodes of 8 cards. Put only low-bandwidth collectives
    across nodes (dp: one gradient reduction a step). On one node it is the
    mesh of the factors' products. ``num_nodes`` defaults to the job's
    (:func:`_num_nodes`)."""
    names = tuple(axis_factors.keys())
    dcn = tuple(int(v[0]) for v in axis_factors.values())
    ici = tuple(int(v[1]) for v in axis_factors.values())
    world = dist.get_world_size()
    nodes = _num_nodes(world) if num_nodes is None else int(num_nodes)
    if nodes <= 1:
        return make_mesh({n: d * i for n, d, i in zip(names, dcn, ici)}, device_type)
    ranks = hybrid_mesh_ranks(dcn, ici, nodes, world)
    return DeviceMesh(device_type, torch.from_numpy(ranks), mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of mesh axis ``name``; 1 for an axis the mesh does not have."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(name)] if name in names else 1


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on axis ``name``; 0 for an absent axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0


# Parameter-name pattern -> (tp dim, fsdp dim) in torch's layout, matched
# against ``named_parameters`` names (e.g. "layers.3.mixer.in_proj.weight").
# The JAX rule beside each: a kernel (in, out) is a weight (out, in) here.
MIXER_RULES = (
    (r"mixer\.in_proj\.weight$", 0, 1),   # (2Di, E); JAX (E, 2Di) P(fsdp, tp)
    (r"mixer\.in_proj\.bias$", 0, None),
    (r"mixer\.conv1d\.weight$", 0, None),  # (Di, 1, W); JAX (W, Di) P(None, tp)
    (r"mixer\.conv1d\.bias$", 0, None),
    (r"mixer\.x_proj\.weight$", 1, None),  # (R + 2N, Di); JAX (Di, R + 2N) P(tp, None)
    (r"mixer\.dt_proj\.weight$", 0, None),  # (Di, R); JAX (R, Di) P(None, tp)
    (r"mixer\.dt_proj\.bias$", 0, None),
    (r"mixer\.A_log$", 0, None),          # (Di, N), or Mamba-2's (H,)
    (r"mixer\.D$", 0, None),
    (r"mixer\.out_proj\.weight$", 1, 0),  # (E, Di); JAX (Di, E) P(tp, fsdp)
    (r"mixer\.out_proj\.bias$", None, None),
    (r"patch_embed\.proj\.weight$", None, 0),  # (E, C, k, p, p); JAX (K, E) P(None, fsdp)
    (r"patch_embed\.proj\.bias$", None, None),
)


def rule_dims(name: str) -> Tuple[Optional[int], Optional[int]]:
    """(tp dim, fsdp dim) of a parameter name; (None, None) when no rule
    matches (replicated: norms, embeddings, the CLS token)."""
    for pattern, tp_dim, fsdp_dim in MIXER_RULES:
        if re.search(pattern, name):
            return tp_dim, fsdp_dim
    return None, None


def placements_for(name: str, shape: Sequence[int], mesh: DeviceMesh,
                   fsdp_axis: str = "fsdp", tp_axis: str = "tp") -> Placements:
    """One parameter's placements on ``mesh``. An axis of size 1, a dim the
    parameter does not have (the rank truncation of Mamba-2's (H,)
    parameters) and a dim the axis does not divide are dropped: that axis
    replicates (mesh.py:127-146)."""
    tp_dim, fsdp_dim = rule_dims(name)
    want = {fsdp_axis: fsdp_dim, tp_axis: tp_dim}
    out = []
    for axis in mesh.mesh_dim_names or ():
        dim, size = want.get(axis), axis_size(mesh, axis)
        if dim is not None and size > 1 and dim < len(shape) and shape[dim] % size == 0:
            out.append(Shard(dim))
        else:
            out.append(Replicate())
    return tuple(out)


def param_shardings(model: nn.Module, mesh: DeviceMesh, fsdp_axis: str = "fsdp",
                    tp_axis: str = "tp") -> Dict[str, Placements]:
    """Placements of every parameter of ``model`` (its full, unsharded
    shapes), by ``named_parameters`` name: the mixer products and the
    patch embedding by :data:`MIXER_RULES`, everything else replicated."""
    return {name: placements_for(name, tuple(p.shape), mesh, fsdp_axis, tp_axis)
            for name, p in model.named_parameters()}


def shard_shape(shape: Sequence[int], mesh: DeviceMesh, placements: Placements) -> Tuple[int, ...]:
    """The shape of one rank's shard under ``placements``."""
    out = list(shape)
    for axis, placement in enumerate(placements):
        if isinstance(placement, Shard):
            out[placement.dim] //= mesh.shape[axis]
    return tuple(out)


def batch_sharding(mesh: DeviceMesh, *data_axes: str) -> Placements:
    """Placements of a batch: dim 0 over the data axes (dp and fsdp by
    default) of size above 1, dp major; replicated over the others."""
    axes = tuple(a for a in (data_axes or ("dp", "fsdp")) if axis_size(mesh, a) > 1)
    return tuple(Shard(0) if a in axes else Replicate() for a in mesh.mesh_dim_names or ())


def replicated(mesh: DeviceMesh) -> Placements:
    return tuple(Replicate() for _ in mesh.mesh_dim_names or ())


def shard_params(model: nn.Module, mesh: DeviceMesh, **kw) -> Dict[str, torch.Tensor]:
    """``DTensor`` copies of ``model``'s parameters placed by
    :func:`param_shardings` (for checkpoints and inspection; no kernel takes
    a ``DTensor``: the training path shards through
    ``init_train_state``)."""
    shardings = param_shardings(model, mesh, **kw)
    return {name: distribute_tensor(p.detach(), mesh, list(shardings[name]))
            for name, p in model.named_parameters()}


def data_rank(mesh: DeviceMesh, *data_axes: str) -> Tuple[int, int]:
    """(this rank's index among the data shards, the number of shards):
    the data axes' coordinates, dp major."""
    index, count = 0, 1
    for axis in data_axes or ("dp", "fsdp"):
        size = axis_size(mesh, axis)
        index, count = index * size + axis_index(mesh, axis), count * size
    return index, count


def batch_rows(mesh: DeviceMesh, batch_size: int, *data_axes: str) -> slice:
    """This rank's rows of a global batch of ``batch_size``: a contiguous
    slice, as :func:`batch_sharding` lays the batch out. Raises unless the
    data shards divide the batch."""
    index, count = data_rank(mesh, *data_axes)
    if batch_size % count:
        raise ValueError(f"global batch {batch_size} is not divisible by {count} data shards")
    per = batch_size // count
    return slice(index * per, (index + 1) * per)


def canonical_mesh(mesh: DeviceMesh, axes: Sequence[str] = ("dp", "fsdp", "tp")) -> DeviceMesh:
    """``mesh`` with exactly the axes ``axes``, in that order: ``mesh``
    itself when it has them, else a new mesh over the same ranks with the
    missing axes of size 1. Raises for an axis outside ``axes``. Every rank
    must call it (a new mesh makes process groups)."""
    have = tuple(mesh.mesh_dim_names or ())
    extra = [n for n in have if n not in axes]
    if extra:
        raise ValueError(f"mesh axes {extra} are not among {tuple(axes)}")
    if have == tuple(axes):
        return mesh
    ranks = mesh.mesh.permute([have.index(n) for n in axes if n in have])
    ranks = ranks.reshape([axis_size(mesh, n) for n in axes])
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=tuple(axes))
