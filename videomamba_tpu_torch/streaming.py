"""Versioned streaming-state contract (model-agnostic), PyTorch port.

Port of videomamba_tpu/streaming.py, frozen at contract version "1.0.0":
per-layer ``(conv_state, ssm_state)`` tensors shaped ``(B, d_inner, d_conv)``
and ``(B, d_inner, d_state)`` (a Mamba-2 mixer's ``state_shapes``: ``(B,
conv_dim, d_conv)`` and ``(B, nheads, headdim, d_state)``), allocate / shape /
validate functions for any model exposing ``layers[i].mixer``, and the
frozen forward-return strings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Protocol, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor

STREAMING_CONTRACT_VERSION = "1.0.0"

LayerState = Tuple[Tensor, Tensor]
StreamingState = Union[List[LayerState], Tuple[LayerState, ...], Dict[int, LayerState]]


@dataclass(frozen=True)
class StateShape:
    conv_state: Tuple[int, ...]
    ssm_state: Tuple[int, ...]


@dataclass(frozen=True)
class ForwardReturnSemantics:
    without_state: str
    with_state: str


_FORWARD_RETURN_SEMANTICS_BY_POOL_NORM = {
    True: ForwardReturnSemantics(
        without_state="(x_vis, x_pool)",
        with_state="(x_vis, x_pool, next_state)",
    ),
    False: ForwardReturnSemantics(
        without_state="x_vis",
        with_state="(x_vis, next_state)",
    ),
}


class _LayerLike(Protocol):
    mixer: object


class _ModelLike(Protocol):
    layers: Sequence[_LayerLike]
    add_pool_norm: bool


def forward_return_semantics(add_pool_norm: bool) -> ForwardReturnSemantics:
    return _FORWARD_RETURN_SEMANTICS_BY_POOL_NORM[bool(add_pool_norm)]


def expected_state_shapes(model: _ModelLike, batch_size: int) -> Dict[int, StateShape]:
    """Per-layer expected state shapes."""
    if batch_size <= 0:
        raise ValueError("batch_size must be a positive integer.")
    shapes: Dict[int, StateShape] = {}
    for idx, layer in enumerate(model.layers):
        mixer = getattr(layer, "mixer", None)
        if mixer is None:
            raise TypeError(f"Layer {idx} does not expose a mixer attribute.")
        # Mixers with another state layout (Mamba2's 4-D SSM state) publish
        # their shapes; the d_inner-based shapes stay the Mamba-1 contract.
        state_shapes = getattr(mixer, "state_shapes", None)
        if callable(state_shapes):
            conv_shape, ssm_shape = state_shapes(batch_size)
            shapes[idx] = StateShape(conv_state=tuple(conv_shape), ssm_state=tuple(ssm_shape))
            continue
        try:
            d_inner = int(getattr(mixer, "d_inner"))
            d_conv = int(getattr(mixer, "d_conv"))
            d_state = int(getattr(mixer, "d_state"))
        except (AttributeError, TypeError, ValueError) as exc:
            raise TypeError(
                f"Layer {idx} mixer does not expose integer d_inner/d_conv/d_state."
            ) from exc
        shapes[idx] = StateShape(
            conv_state=(batch_size, d_inner, d_conv),
            ssm_state=(batch_size, d_inner, d_state),
        )
    return shapes


def allocate_state(
    model: object,
    batch_size: int,
    dtype=None,
    device=None,
    as_dict: bool = False,
) -> StreamingState:
    """Duck-typed dispatch to the model's ``allocate_state``."""
    allocate_fn = getattr(model, "allocate_state", None)
    if not callable(allocate_fn):
        raise TypeError("Model does not expose allocate_state(...).")
    return allocate_fn(batch_size, dtype=dtype, device=device, as_dict=as_dict)


def validate_state(model: _ModelLike, state: StreamingState, batch_size: int) -> None:
    """Shape and type validation of a streaming state collection."""
    shapes = expected_state_shapes(model, batch_size)
    depth = len(shapes)

    if isinstance(state, dict):
        keys = set(state.keys())
        expected_keys = set(range(depth))
        if keys != expected_keys:
            raise ValueError(
                f"State dict keys mismatch: expected {sorted(expected_keys)}, "
                f"got {sorted(keys)}."
            )
        items = [state[idx] for idx in range(depth)]
    elif isinstance(state, (list, tuple)):
        if len(state) != depth:
            raise ValueError(
                f"State length mismatch: expected {depth}, got {len(state)}."
            )
        items = list(state)
    else:
        raise TypeError("State must be a list, tuple, or dict indexed by layer id.")

    for idx, layer_state in enumerate(items):
        if not isinstance(layer_state, (list, tuple)) or len(layer_state) != 2:
            raise TypeError(
                "Each layer state must be a 2-tuple: (conv_state, ssm_state)."
            )
        conv_state, ssm_state = layer_state
        if not isinstance(conv_state, Tensor) or not isinstance(ssm_state, Tensor):
            raise TypeError("conv_state and ssm_state must both be torch tensors.")
        expected = shapes[idx]
        conv_shape = tuple(conv_state.shape)
        ssm_shape = tuple(ssm_state.shape)
        if conv_shape != expected.conv_state:
            raise ValueError(
                f"Layer {idx} conv_state shape mismatch: expected "
                f"{expected.conv_state}, got {conv_shape}."
            )
        if ssm_shape != expected.ssm_state:
            raise ValueError(
                f"Layer {idx} ssm_state shape mismatch: expected "
                f"{expected.ssm_state}, got {ssm_shape}."
            )
