"""Training step — port of videomamba_tpu/parallel/train_step.py (29-125).

The default objective is feature regression: the fp32 MSE of the encoder's
visible tokens against ``batch["target"]`` (pixels, teacher features, ...),
with a VideoMAE mask from ``batch["mask"]`` when the batch has one.
With ``compute_dtype`` the loss runs the model through
``torch.func.functional_call`` on parameters cast by
``utils.precision.cast_params_for_compute``, so the fp32 masters the
optimizer holds receive fp32 gradients through the cast (bf16 compute over
fp32 master weights, the JAX package's mixed-precision recipe). The model
runs in training mode, on the hand-written kernels' training route (K3 / K6
per mixer, K2 and autograd or K8 per norm; ops/kernels).

Distribution (a device mesh) is a later slice; ``init_train_state`` raises
when given one.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
from torch import nn

from videomamba_tpu_torch.utils.precision import cast_params_for_compute

Tensor = torch.Tensor


def default_loss_fn(model: nn.Module, batch: Dict[str, Tensor],
                    generator: Optional[torch.Generator] = None,
                    compute_dtype: Optional[torch.dtype] = None):
    """MSE of x_vis (fp32) against ``batch["target"]``; returns (loss, metrics).

    With ``batch["mask"]`` (True = hidden, the model's mask contract) the
    encoder runs on the visible tokens only and the target holds one row per
    visible patch token: VideoMAE-style masked feature regression (JAX
    examples/train_masked_pretrain.py). A NumPy mask stays on the host; a
    tensor mask is copied there once."""
    video = batch["video"]
    kwargs = {"mask": batch.get("mask"), "generator": generator}
    if compute_dtype is None:
        out = model(video, **kwargs)
    else:
        params = cast_params_for_compute(model, compute_dtype)
        out = torch.func.functional_call(model, params, (video,), kwargs)
    x_vis = out[0] if isinstance(out, tuple) else out
    loss = (x_vis.float() - batch["target"].float()).square().mean()
    return loss, {"loss": loss.detach()}


def global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


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
    norm of the unclipped gradients."""
    device = next(model.parameters()).device
    if loss_fn is None:
        loss_fn = functools.partial(default_loss_fn, model, compute_dtype=compute_dtype)

    def step(batch: Dict[str, Tensor], generator: Optional[torch.Generator] = None):
        model.train()
        batch = {k: v.to(device) if isinstance(v, Tensor) else v for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, generator)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads).detach()
        optimizer.step()
        return metrics

    return step


def init_train_state(model: nn.Module, optimizer: torch.optim.Optimizer, mesh=None):
    """(parameters by name, optimizer state, step 0). A mesh raises: sharded
    training belongs to the distribution slice of the port."""
    if mesh is not None:
        raise NotImplementedError("sharded training (a mesh) is not ported yet")
    return dict(model.named_parameters()), optimizer.state_dict(), 0
