"""Multi-process init and collectives over ``torch.distributed``.

Port of videomamba_tpu/utils/distributed.py, which keeps the reference's
surface (rank discovery from torchrun or SLURM, including the
SLURM_TASKS_PER_NODE grammar, master-only logging, port probing, batch
all-gathers) over ``jax.distributed``. Here the surface is the reference's
own layer again: an NCCL process group on the card, one process a card.
A CPU run asks for gloo (``args.device == "cpu"``); NCCL that fails to start
raises, nothing carries on over gloo.

The JAX functions name a mesh axis (``axis_name: str``); here a collective
takes a ``torch.distributed`` process group, ``group``, default the world
group (a ``DeviceMesh`` gives one per axis: ``mesh.get_group("tp")``). The
autograd Functions at the end are the collectives the sequence- and
tensor-parallel layers differentiate through.
"""

from __future__ import annotations

import logging
import os
import re

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

Tensor = torch.Tensor


def _parse_slurm_tasks_per_node(spec: str) -> int:
    """Parse SLURM_TASKS_PER_NODE (e.g. '8', '16(x2),8') into a task count."""
    total = 0
    for chunk in spec.split(","):
        value = chunk.strip()
        match = re.fullmatch(r"(\d+)(?:\(x(\d+)\))?", value)
        if match is None:
            raise ValueError(f"Unsupported SLURM_TASKS_PER_NODE value: {spec}")
        tasks = int(match.group(1))
        repeats = int(match.group(2)) if match.group(2) is not None else 1
        total += tasks * repeats
    return total


def setup_for_distributed(is_master: bool) -> None:
    """Master-only warnings and logging (reference distributed.py:30-45)."""
    import warnings

    builtin_warn = warnings.warn

    def warn(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_warn(*args, **kwargs)

    warnings.warn = warn
    warnings.simplefilter("once", UserWarning)

    if not is_master:
        logging.disable()


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None) -> int:
    """Ranks in ``group`` (the world by default); 1 without a process group."""
    return dist.get_world_size(group) if is_dist_avail_and_initialized() else 1


def get_rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    return dist.get_rank(group) if is_dist_avail_and_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def save_on_master(save_fn, *args, **kwargs):
    """Run a save callable on the master process only, e.g.
    ``save_on_master(torch.save, state, path)``; returns its result there and
    None elsewhere."""
    if is_main_process():
        return save_fn(*args, **kwargs)
    return None


def is_port_in_use(port: int) -> bool:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        return s.connect_ex(("localhost", port)) == 0


def _probe_dist_url(dist_url: str) -> str:
    """A ``tcp://host:port`` URL with its port moved up in steps of 10 past
    any port in use (SLURM may colocate programs on a node; reference
    distributed.py:114-118)."""
    dist_port = int(dist_url.split(":")[-1])
    while is_port_in_use(dist_port):
        dist_port += 10
    return ":".join(dist_url.split(":")[:-1] + [str(dist_port)])


def init_distributed_mode(args) -> None:
    """Discover ranks from torchrun- or SLURM-style environment variables
    and start the process group.

    The discovery chain is the reference's (distributed.py:84-109): RANK
    and WORLD_SIZE (LOCAL_RANK the card), then SLURM_PROCID with the world
    size from SLURM_NTASKS, else SLURM_TASKS_PER_NODE, else SLURM_NNODES.
    ``args`` gains rank, world_size, gpu (the local rank) and distributed.
    A ``tcp://`` ``args.dist_url`` is probed for a free port; without one
    the group reads MASTER_ADDR and MASTER_PORT (``env://``).

    On the card: ``torch.cuda.set_device(args.gpu)`` and an NCCL group. A
    CPU run (``args.device == "cpu"``) takes gloo. No fallback: an NCCL
    group that cannot start raises.
    """
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        args.rank = int(os.environ["RANK"])
        args.world_size = int(os.environ["WORLD_SIZE"])
        args.gpu = int(os.environ.get("LOCAL_RANK", 0))
    elif "SLURM_PROCID" in os.environ:
        local_rank = int(os.environ["SLURM_LOCALID"])
        global_rank = int(os.environ["SLURM_PROCID"])
        if "SLURM_NTASKS" in os.environ:
            world_size = int(os.environ["SLURM_NTASKS"])
        elif "SLURM_TASKS_PER_NODE" in os.environ:
            world_size = _parse_slurm_tasks_per_node(os.environ["SLURM_TASKS_PER_NODE"])
        else:
            world_size = int(os.environ["SLURM_NNODES"])
        args.rank = global_rank
        args.gpu = local_rank
        args.world_size = world_size
    elif is_dist_avail_and_initialized():
        # Already started by the caller.
        args.rank = dist.get_rank()
        args.world_size = dist.get_world_size()
        args.gpu = int(os.environ.get("LOCAL_RANK", 0))
        args.distributed = True
        setup_for_distributed(args.rank == 0)
        return
    else:
        logger.info("Not using distributed mode")
        args.distributed = False
        return

    args.distributed = True
    dist_url = getattr(args, "dist_url", None)
    if dist_url and "tcp" in dist_url:
        dist_url = _probe_dist_url(dist_url)
        args.dist_url = dist_url
    init_method = dist_url or "env://"

    logger.info("| distributed init (rank %s): %s", args.rank, init_method)
    if "SLURM_JOB_ID" in os.environ:
        logger.info("SLURM_JOB_ID %s", os.environ["SLURM_JOB_ID"])

    kw = {}
    if str(getattr(args, "device", "cuda")) == "cpu":
        backend = "gloo"
    else:
        torch.cuda.set_device(args.gpu)
        backend = "nccl"
        kw["device_id"] = torch.device("cuda", args.gpu)  # binds the rank to its card
    dist.init_process_group(backend, init_method=init_method,
                            world_size=args.world_size, rank=args.rank, **kw)
    dist.barrier()
    setup_for_distributed(args.rank == 0)


def init_run_group(device):
    """The process group of a training script; returns a function that
    ends what this call started.

    A group that already exists is used as it is (the returned function
    does nothing). Under torchrun or SLURM (RANK and WORLD_SIZE, or
    SLURM_PROCID, in the environment) :func:`init_distributed_mode` starts
    it. Otherwise the run is one process: a one-rank group over a file
    rendezvous in a new temporary directory, NCCL on the card, gloo for a
    CPU ``device``, so a mesh (``parallel.make_mesh``) and FSDP2 run at
    world size 1 too.
    """
    import shutil
    import tempfile
    from types import SimpleNamespace

    if is_dist_avail_and_initialized():
        return lambda: None
    device = torch.device(device)
    if ("RANK" in os.environ and "WORLD_SIZE" in os.environ) or "SLURM_PROCID" in os.environ:
        init_distributed_mode(SimpleNamespace(device=device.type, dist_url=None))
        return dist.destroy_process_group
    root = tempfile.mkdtemp(prefix="vmt_group_")
    kw = {}
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="file://" + os.path.join(root, "rendezvous"),
                            world_size=1, rank=0, **kw)

    def close():
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)

    return close


# ------------------------------------------------------------- collectives

class _GatherLayer(torch.autograd.Function):
    """All-gather along ``dim`` whose backward is a reduce-scatter: the
    gathered cotangents are summed over the ranks (every rank used the
    gathered tensor) and this rank keeps its own slice (reference
    distributed.py:149-177, the transpose of the JAX ``all_gather``)."""

    @staticmethod
    def forward(ctx, tensor, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank = dist.get_rank(group)
        parts = [tensor.new_empty(tensor.shape) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, tensor.contiguous(), group=group)
        ctx.length = tensor.shape[dim]
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.rank * ctx.length, ctx.length).contiguous(), None, None


def gather_tensor_along_batch_with_backward(tensor: Tensor, group=None, dim: int = 0) -> Tensor:
    """Differentiable all-gather along ``dim`` (the ranks' tensors, each of
    the same shape, concatenated in rank order). Without a process group it
    returns ``tensor``; a group of one rank still runs the collective."""
    if not is_dist_avail_and_initialized():
        return tensor
    return _GatherLayer.apply(tensor, group, dim)


@torch.no_grad()
def gather_tensor_along_batch(tensor: Tensor, group=None, dim: int = 0) -> Tensor:
    """All-gather along ``dim`` with no gradient."""
    if not is_dist_avail_and_initialized():
        return tensor.detach()
    parts = [tensor.new_empty(tensor.shape) for _ in range(get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def all_reduce_mean(tensor: Tensor, group=None) -> Tensor:
    """The mean of ``tensor`` over the ranks of ``group`` (metric sync;
    reference basic_utils.py:44-47). Returns a new tensor."""
    out = tensor.detach().clone()
    if get_world_size(group) == 1:
        return out
    dist.all_reduce(out, group=group)
    return out / get_world_size(group)


def gather_stacked(tensor: Tensor, group=None) -> Tensor:
    """Differentiable all-gather of equal-shaped tensors into a new leading
    axis (K, ...), in rank order: ``lax.all_gather`` without ``tiled``."""
    return gather_tensor_along_batch_with_backward(tensor.unsqueeze(0), group, 0)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f): a replicated
    input that each rank consumes with its own slice of the weights."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward; the backward is the identity (Megatron's g) or,
    with ``reduce_grad``, an all-reduce too: for a sum whose consumers are
    rank-specific, so each rank's cotangent is a part of the whole."""

    @staticmethod
    def forward(ctx, tensor, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        out = tensor.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_grad:
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


def copy_to_group(tensor: Tensor, group=None) -> Tensor:
    """Megatron's f over ``group``: the identity, whose gradient is summed
    over the group's ranks."""
    if get_world_size(group) == 1:
        return tensor
    return _CopyToGroup.apply(tensor, group)


def reduce_from_group(tensor: Tensor, group=None, reduce_grad: bool = False) -> Tensor:
    """The sum of ``tensor`` over ``group``'s ranks; its gradient passes
    through unchanged (Megatron's g) or, with ``reduce_grad``, is summed over
    the ranks as well."""
    if get_world_size(group) == 1:
        return tensor
    return _ReduceFromGroup.apply(tensor, group, reduce_grad)


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` of ``group``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _shift(tensor: Tensor, group, forward: bool) -> Tensor:
    """Send ``tensor`` one rank up (``forward``) or down the group and return
    what arrived from the other side; the end that receives nothing gets
    zeros."""
    k, num = dist.get_rank(group), dist.get_world_size(group)
    dst, src = (k + 1, k - 1) if forward else (k - 1, k + 1)
    out = tensor.new_zeros(tensor.shape)
    ops = []
    if 0 <= dst < num:
        ops.append(dist.P2POp(dist.isend, tensor.contiguous(), _peer(group, dst), group))
    if 0 <= src < num:
        ops.append(dist.P2POp(dist.irecv, out, _peer(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _ShiftToNext(torch.autograd.Function):
    """Rank k's tensor arrives at rank k + 1 (rank 0 gets zeros); the
    backward sends each cotangent back to the rank it came from."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return _shift(tensor, group, forward=True)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, forward=False), None


def shift_to_next(tensor: Tensor, group=None) -> Tensor:
    """Differentiable one-hop shift up the group (``lax.ppermute`` with the
    pairs (i, i + 1)): each rank gets its predecessor's tensor, rank 0
    zeros."""
    if get_world_size(group) == 1:
        return torch.zeros_like(tensor)
    return _ShiftToNext.apply(tensor, group)
