"""Training step — port of videomamba_tpu/parallel/train_step.py (29-146).

The default objective is feature regression: the fp32 MSE of the encoder's
visible tokens against ``batch["target"]`` (pixels, teacher features, ...),
with a VideoMAE mask from ``batch["mask"]`` when the batch has one.
With ``compute_dtype`` every Block, and the model for the parameters
outside its Blocks, casts its own parameters inside its forward
(:func:`install_compute_cast`; the same units as FSDP2's under a mesh, and
without one), by ``utils.precision.keep_fp32``'s rule, so the fp32 masters
the optimizer holds receive fp32 gradients through the cast (bf16 compute
over fp32 master weights, the JAX package's mixed-precision recipe). The
model
runs in training mode, on the hand-written kernels' training route (K3 / K6
per mixer, K2 and autograd or K8 per norm; ops/kernels).

Under a mesh (``init_train_state(model, optimizer, mesh)``, axes dp, fsdp
and tp of parallel/mesh.py; one process a card, NCCL, or gloo on the CPU):

* tp > 1: every Mamba-1 mixer keeps its d_inner / tp channels
  (``Mamba.shard_channels``: explicit all-reduces around the unfused
  branch, K1 forward and K5 backward; no K3, K4). A Mamba-2 Block's
  parameters are only stored sharded over tp: they join the fsdp sharding
  (FSDP2 over the flattened fsdp x tp ranks), are gathered whole before the
  Block's forward and reduce-scattered after its backward, so K12 and K13
  see whole weights. Storage-only tensor parallelism: it divides the
  Block's memory, not its work.
* FSDP2 ``fully_shard`` per Block and at the root over the (dp, fsdp) ranks
  (HSDP when both are above 1), each parameter's shard on its fsdp dim of
  ``mesh.MIXER_RULES`` where the ranks divide it, else on dim 0.
* the step: each data rank (dp x fsdp) takes its rows of the global batch,
  the tp ranks of a data rank the same rows; FSDP2 averages the gradients
  over the data ranks, so they are the global mean's; the loss metric is
  the global mean, ``grad_norm`` the global norm (each element once).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, FrozenSet, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from videomamba_tpu_torch.parallel import mesh as mesh_lib
from videomamba_tpu_torch.utils.distributed import all_reduce_mean
from videomamba_tpu_torch.utils.precision import keep_fp32
from videomamba_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor


def default_loss_fn(model: nn.Module, batch: Dict[str, Tensor],
                    generator: Optional[torch.Generator] = None):
    """MSE of x_vis (fp32) against ``batch["target"]``; returns (loss, metrics).

    With ``batch["mask"]`` (True = hidden, the model's mask contract) the
    encoder runs on the visible tokens only and the target holds one row per
    visible patch token: VideoMAE-style masked feature regression (JAX
    examples/train_masked_pretrain.py). A NumPy mask stays on the host; a
    tensor mask is copied there once. The compute dtype is the step's
    (:func:`make_train_step`), not an argument here."""
    out = model(batch["video"], mask=batch.get("mask"), generator=generator)
    x_vis = out[0] if isinstance(out, tuple) else out
    loss = (x_vis.float() - batch["target"].float()).square().mean()
    return loss, {"loss": loss.detach()}


def global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


@dataclasses.dataclass
class TrainMesh:
    """What ``init_train_state`` placed, read by ``make_train_step``: the
    (dp, fsdp, tp) mesh, the (dp, fsdp x tp) mesh of the Blocks stored
    sharded over tp (None without them), and which parameters a tp rank
    holds a part of (``tp_local``: Mamba-1 mixers' channels; ``tp_stored``:
    those Blocks')."""

    mesh: object
    stored_mesh: Optional[object]
    tp_local: FrozenSet[str]
    tp_stored: FrozenSet[str]


def _blocks(model: nn.Module):
    from videomamba_tpu_torch.models.block import Block

    return [(name, m) for name, m in model.named_modules() if isinstance(m, Block)]


def _placement_fn(names: Dict[int, str], shard_ranks: int, prefer_tp: bool):
    """FSDP2's ``shard_placement_fn``: the table's fsdp dim (for a Mamba-2
    Block under tp, its tp dim first) where ``shard_ranks`` divides it, else
    FSDP2's dim 0, which may be uneven."""
    from torch.distributed.tensor import Shard

    def fn(param):
        tp_dim, fsdp_dim = mesh_lib.rule_dims(names[id(param)])
        for dim in ((tp_dim, fsdp_dim) if prefer_tp else (fsdp_dim,)):
            if dim is not None and dim < param.ndim and param.shape[dim] % shard_ranks == 0:
                return Shard(dim)
        return None

    return fn


def _cast_pre_hook(unit: nn.Module, args) -> None:
    dtype = unit._compute_dtype
    ctx = None
    if dtype is not None:
        from torch.nn.utils.stateless import _reparametrize_module

        with annotate("vmt.train.cast"):
            cast = {name: p.to(dtype) for name, p in unit.named_parameters()
                    if not name.startswith(unit._compute_cast_skip)
                    and p.dtype == torch.float32 and not keep_fp32(name)}
            ctx = _reparametrize_module(unit, cast)
            ctx.__enter__()
    unit._compute_cast_ctx.append(ctx)


def _cast_post_hook(unit: nn.Module, args, output) -> None:
    ctx = unit._compute_cast_ctx.pop()
    if ctx is not None:
        ctx.__exit__(None, None, None)


def install_compute_cast(model: nn.Module):
    """Give every Block of ``model``, and ``model`` itself for the rest of
    its parameters, a cast of its own parameters to its ``_compute_dtype``
    (None: no cast) for the length of its forward (``keep_fp32``'s rule).
    Under a mesh these are FSDP2's units: the cast runs after the gather,
    and autograd carries its gradient back to the gathered fp32 parameters
    that FSDP2 reduce-scatters. Hooks (the undo runs if the forward raises);
    a unit that has them is left as it is. Returns the units."""
    blocks = _blocks(model)
    units = [(block, ()) for _, block in blocks]
    units.append((model, tuple(name + "." for name, _ in blocks)))
    for unit, skip in units:
        if hasattr(unit, "_compute_cast_skip"):
            continue
        unit._compute_cast_skip, unit._compute_dtype, unit._compute_cast_ctx = skip, None, []
        unit.register_forward_pre_hook(_cast_pre_hook)
        unit.register_forward_hook(_cast_post_hook, prepend=True, always_call=True)
    return [unit for unit, _ in units]


def init_train_state(model: nn.Module, optimizer: torch.optim.Optimizer, mesh=None):
    """(parameters by name, optimizer state, step 0); sharded when a mesh
    (parallel/mesh.py ``make_mesh``) is given.

    Under a mesh every rank calls it: the tp split, then FSDP2 (module
    docstring). Sharding makes new parameters, so ``optimizer`` (not yet
    stepped) is re-pointed in place at them, its groups and settings kept:
    its state then mirrors the sharded parameters. The returned parameters
    are FSDP2's ``DTensor`` shards; ``full_state_dict`` gathers them whole.
    """
    if mesh is None:
        return dict(model.named_parameters()), optimizer.state_dict(), 0
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"init_train_state: mesh must be a DeviceMesh (parallel.make_mesh), "
                        f"got {type(mesh).__name__}")
    if optimizer.state:
        raise ValueError("init_train_state: the optimizer has stepped; give it a fresh one")

    from videomamba_tpu_torch.models.mamba import Mamba

    before = {id(p): n for n, p in model.named_parameters()}
    groups = [[before[id(p)] for p in g["params"]] for g in optimizer.param_groups]
    mesh3 = mesh_lib.canonical_mesh(mesh)
    dp, fsdp, tp = (mesh_lib.axis_size(mesh3, a) for a in ("dp", "fsdp", "tp"))
    data_mesh = mesh3["dp", "fsdp"]
    stored_mesh, tp_local, tp_stored, stored_blocks = None, set(), set(), set()
    blocks = _blocks(model)
    if tp > 1:
        tp_group = mesh3.get_group("tp")
        for name, block in blocks:
            if isinstance(block.mixer, Mamba):
                block.mixer.shard_channels(tp_group)
                tp_local.update(f"{name}.mixer.{n}" for n, _ in block.mixer.named_parameters()
                                if n != "out_proj.bias")
            else:
                stored_blocks.add(name)
                tp_stored.update(f"{name}.{n}" for n, _ in block.named_parameters())
        if stored_blocks:
            stored_mesh = DeviceMesh(mesh3.device_type, mesh3.mesh.reshape(dp, fsdp * tp),
                                     mesh_dim_names=("dp", "fsdp_tp"))
    names = {id(p): n for n, p in model.named_parameters()}
    for name, block in blocks:
        stored = name in stored_blocks
        fully_shard(block, mesh=stored_mesh if stored else data_mesh,
                    shard_placement_fn=_placement_fn(names, fsdp * tp if stored else fsdp,
                                                     stored))
    fully_shard(model, mesh=data_mesh, shard_placement_fn=_placement_fn(names, fsdp, False))
    params = dict(model.named_parameters())
    for g, group_names in zip(optimizer.param_groups, groups):
        g["params"] = [params[n] for n in group_names]
    model.train_mesh = TrainMesh(mesh3, stored_mesh, frozenset(tp_local), frozenset(tp_stored))
    return params, optimizer.state_dict(), 0


def _group_sum(value: Tensor, group) -> Tensor:
    if dist.get_world_size(group) > 1:
        dist.all_reduce(value, group=group)
    return value


def sharded_global_norm(model: nn.Module, plan: TrainMesh) -> Tensor:
    """The global L2 norm of the gradients under a mesh, each element
    counted once: every rank's squares summed over the ranks that hold
    other parts of the same parameters (fsdp; fsdp and tp for a Mamba-1
    mixer's channels; fsdp x tp for a Mamba-2 Block's storage), never over
    dp, whose ranks hold copies."""
    sums = {"fsdp": [], "tp": [], "stored": []}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
        sq = g.float().square().sum()
        key = "stored" if name in plan.tp_stored else "tp" if name in plan.tp_local else "fsdp"
        sums[key].append(sq)
    dev = next(model.parameters()).to_local().device
    total = {k: torch.stack(v).sum() if v else torch.zeros((), device=dev)
             for k, v in sums.items()}
    tp_part = _group_sum(total["tp"], plan.mesh.get_group("tp"))
    data = _group_sum(total["fsdp"] + tp_part, plan.mesh.get_group("fsdp"))
    if plan.stored_mesh is not None:
        data = data + _group_sum(total["stored"], plan.stored_mesh.get_group("fsdp_tp"))
    return data.sqrt()


def _rows(batch: Dict[str, object], rows: slice, size: int) -> Dict[str, object]:
    """This rank's rows of every array of the global batch."""
    return {k: v[rows] if isinstance(v, (Tensor, np.ndarray)) and v.shape[:1] == (size,) else v
            for k, v in batch.items()}


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Optional[Callable] = None,
                    compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """Build ``step(batch, generator=None) -> metrics``.

    One step: the model in training mode, the loss and its gradients, the
    optimizer's update. A learning-rate schedule (``utils.scheduler``) is
    stepped by the caller after each step. ``loss_fn`` takes (batch,
    generator) and returns (loss, metrics); the default is
    :func:`default_loss_fn`. The batch's tensors are moved to the model's
    device. Metrics: the loss function's, plus ``grad_norm``, the global L2
    norm of the unclipped gradients. ``compute_dtype`` runs the model's
    forward (and a recompute in its backward) in that dtype over fp32
    masters, whatever the loss function (:func:`install_compute_cast`;
    the same parameters as ``utils.precision.cast_params_for_compute``
    casts).

    After ``init_train_state(..., mesh)`` every rank calls ``step`` with the
    same global batch: it takes its rows, and the metrics are global (tensor
    metrics averaged over the data ranks, ``grad_norm`` by
    :func:`sharded_global_norm`). ``generator`` draws each rank's own
    stochastic-depth masks.
    """
    plan: Optional[TrainMesh] = getattr(model, "train_mesh", None)
    first = next(model.parameters())
    device = first.to_local().device if plan is not None else first.device
    if loss_fn is None:
        loss_fn = functools.partial(default_loss_fn, model)
    cast_units = install_compute_cast(model) if compute_dtype is not None else []

    def set_compute_dtype(dtype):
        for unit in cast_units:
            unit._compute_dtype = dtype

    def step(batch: Dict[str, Tensor], generator: Optional[torch.Generator] = None):
        with annotate("vmt.train.step"):
            model.train()
            if plan is not None:
                size = len(batch["video"])
                batch = _rows(batch, mesh_lib.batch_rows(plan.mesh, size), size)
            batch = {k: v.to(device) if isinstance(v, Tensor) else v for k, v in batch.items()}
            optimizer.zero_grad(set_to_none=True)
            set_compute_dtype(compute_dtype)  # also for a recompute in the backward
            try:
                with annotate("vmt.train.forward"):
                    loss, metrics = loss_fn(batch, generator)
                with annotate("vmt.train.backward"):
                    loss.backward()
            finally:
                set_compute_dtype(None)
            metrics = dict(metrics)
            if plan is not None:
                for k, v in metrics.items():
                    if isinstance(v, Tensor):
                        v = all_reduce_mean(v, plan.mesh.get_group("dp"))
                        metrics[k] = all_reduce_mean(v, plan.mesh.get_group("fsdp"))
            with annotate("vmt.train.grad_norm"):
                if plan is None:
                    grads = [p.grad for p in model.parameters() if p.grad is not None]
                    metrics["grad_norm"] = global_norm(grads).detach()
                else:
                    metrics["grad_norm"] = sharded_global_norm(model, plan).detach()
            with annotate("vmt.train.optimizer"):
                optimizer.step()
            return metrics

    return step


def full_state_dict(model: nn.Module) -> Dict[str, Tensor]:
    """The whole parameters of a model placed by ``init_train_state``, by
    name, on every rank (:func:`full_tensors` of its parameters). Every
    rank must call it. A model with no mesh gives its parameters."""
    return full_tensors(model, {n: p.detach() for n, p in model.named_parameters()})


def _tp_mixers(model: nn.Module):
    """(prefix, mixer) of every Mamba-1 mixer split over tensor-parallel
    ranks, and the tp group; empty without tp."""
    plan: Optional[TrainMesh] = getattr(model, "train_mesh", None)
    if plan is None or mesh_lib.axis_size(plan.mesh, "tp") == 1:
        return [], None
    from videomamba_tpu_torch.models.mamba import Mamba

    mixers = [(f"{name}.mixer.", block.mixer) for name, block in _blocks(model)
              if isinstance(block.mixer, Mamba)]
    return mixers, plan.mesh.get_group("tp")


def _whole_copy(t: Tensor) -> Tensor:
    """A copy of ``t``, whole: a ``DTensor``'s shards gathered. Over one
    rank the gather hands back the shard itself, the live parameter's
    storage, so that is copied."""
    if not hasattr(t, "full_tensor"):
        return t.detach().clone()
    whole = t.detach().full_tensor()
    if whole.untyped_storage().data_ptr() == t.to_local().untyped_storage().data_ptr():
        whole = whole.clone()
    return whole


def full_tensors(model: nn.Module, tensors: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Copies of ``tensors`` (by parameter name: the parameters, or an
    optimizer's state shaped like them) whole on every rank: FSDP2's shards gathered,
    then each Mamba-1 mixer's tp channels joined in the JAX order
    (``Mamba.join_channel_slices``). Every rank must call it with the same
    names."""
    out = {name: _whole_copy(t) for name, t in tensors.items()}
    mixers, tp_group = _tp_mixers(model)
    if not mixers:
        return out
    from videomamba_tpu_torch.models.mamba import Mamba

    size = dist.get_world_size(tp_group)
    for prefix, _ in mixers:
        local = {n[len(prefix):]: t for n, t in out.items() if n.startswith(prefix)}
        gathered = [dict() for _ in range(size)]
        for n, t in local.items():
            parts = [torch.empty_like(t) for _ in range(size)]
            dist.all_gather(parts, t.contiguous(), group=tp_group)
            for g, part in zip(gathered, parts):
                g[n] = part
        for n, t in Mamba.join_channel_slices(gathered).items():
            out[prefix + n] = t
    return out


def local_tensors(model: nn.Module, whole: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The inverse of :func:`full_tensors`' tp join: each Mamba-1 mixer's
    tensors cut to this rank's tp channels (``Mamba.slice_channels``), the
    rest as given. The result is still whole over the data ranks (FSDP2's
    placements cut it, ``checkpoint`` does)."""
    mixers, tp_group = _tp_mixers(model)
    out = dict(whole)
    if not mixers:
        return out
    from videomamba_tpu_torch.models.mamba import Mamba

    rank, size = dist.get_rank(tp_group), dist.get_world_size(tp_group)
    for prefix, mixer in mixers:
        part = {n[len(prefix):]: t for n, t in whole.items() if n.startswith(prefix)}
        for n, t in Mamba.slice_channels(part, mixer.d_inner, rank, size).items():
            out[prefix + n] = t
    return out
