"""Versioned streaming-state contract (model-agnostic), PyTorch port.

Port of videomamba_tpu/streaming.py, frozen at contract version "1.0.0":
per-layer ``(conv_state, ssm_state)`` tensors shaped ``(B, d_inner, d_conv)``
and ``(B, d_inner, d_state)`` (a Mamba-2 mixer's ``state_shapes``: ``(B,
conv_dim, d_conv)`` and ``(B, nheads, headdim, d_state)``), allocate / shape /
validate functions for any model exposing ``layers[i].mixer``, and the
frozen forward-return strings.

A second kind of layer state sits beside it for attention layers (the
hybrid language model, ``models/hybrid_lm.py``): a :class:`KVCache`, a
preallocated key and value cache ``(B, n_kv_heads, max_len, head_dim)`` and
the number of positions filled. Its size grows with ``max_len``, so its
shape is known only with ``max_len`` (:func:`expected_state_shapes`); the
video models' entries are unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Protocol, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor

STREAMING_CONTRACT_VERSION = "1.0.0"


class KVCache(NamedTuple):
    """An attention layer's streaming state: ``key`` and ``value`` (B,
    n_kv_heads, max_len, head_dim), preallocated, of which the first
    ``length`` positions are filled. A chunk writes its keys and values into
    the buffers in place and returns the entry with the new length."""

    key: Tensor
    value: Tensor
    length: int

    def emptied(self) -> "KVCache":
        """The same buffers with nothing filled (a reset)."""
        return self._replace(length=0)


LayerState = Tuple[Tensor, Tensor]
StreamingState = Union[List[Union[LayerState, KVCache]], Tuple[Union[LayerState, KVCache], ...],
                       Dict[int, Union[LayerState, KVCache]]]


@dataclass(frozen=True)
class StateShape:
    conv_state: Tuple[int, ...]
    ssm_state: Tuple[int, ...]


@dataclass(frozen=True)
class KVStateShape:
    """An attention layer's :class:`KVCache` buffers' shape (both alike)."""

    key: Tuple[int, ...]
    value: Tuple[int, ...]


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


def model_forward_return_semantics(model: _ModelLike) -> ForwardReturnSemantics:
    return forward_return_semantics(bool(getattr(model, "add_pool_norm", True)))


def expected_state_shapes(model: _ModelLike, batch_size: int,
                          max_len: Optional[int] = None) -> Dict[int, Union[StateShape,
                                                                             KVStateShape]]:
    """Per-layer expected state shapes; an attention layer's (a mixer with
    ``kv_state_shape``) needs ``max_len``, the cache's length."""
    if batch_size <= 0:
        raise ValueError("batch_size must be a positive integer.")
    shapes: Dict[int, Union[StateShape, KVStateShape]] = {}
    for idx, layer in enumerate(model.layers):
        mixer = getattr(layer, "mixer", None)
        if mixer is None:
            raise TypeError(f"Layer {idx} does not expose a mixer attribute.")
        kv_state_shape = getattr(mixer, "kv_state_shape", None)
        if callable(kv_state_shape):
            if max_len is None:
                raise ValueError(
                    f"Layer {idx} is an attention layer: its KV cache's shape needs max_len.")
            shape = tuple(kv_state_shape(batch_size, max_len))
            shapes[idx] = KVStateShape(key=shape, value=shape)
            continue
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
    max_len: Optional[int] = None,
) -> StreamingState:
    """Duck-typed dispatch to the model's ``allocate_state`` (``max_len``,
    the KV caches' length, goes to a model with attention layers)."""
    allocate_fn = getattr(model, "allocate_state", None)
    if not callable(allocate_fn):
        raise TypeError("Model does not expose allocate_state(...).")
    kwargs = {} if max_len is None else {"max_len": max_len}
    return allocate_fn(batch_size, dtype=dtype, device=device, as_dict=as_dict, **kwargs)


def _kv_max_len(state_items) -> int:
    """The KV caches' length, read from the first :class:`KVCache` entry (0
    without one: any attention layer's entry is then found wrong)."""
    for item in state_items:
        if isinstance(item, KVCache) and isinstance(item.key, Tensor) and item.key.dim() == 4:
            return int(item.key.shape[2])
    return 0


def _validate_kv_entry(idx: int, entry, expected: KVStateShape) -> None:
    if not isinstance(entry, KVCache):
        raise TypeError(f"Layer {idx} is an attention layer: its state must be a KVCache.")
    if not isinstance(entry.key, Tensor) or not isinstance(entry.value, Tensor):
        raise TypeError("KVCache key and value must both be torch tensors.")
    for name, t, want in (("key", entry.key, expected.key),
                          ("value", entry.value, expected.value)):
        if tuple(t.shape) != want:
            raise ValueError(
                f"Layer {idx} KV cache {name} shape mismatch: expected {want}, "
                f"got {tuple(t.shape)}.")
    if not 0 <= int(entry.length) <= expected.key[2]:
        raise ValueError(
            f"Layer {idx} KV cache length {entry.length} outside [0, {expected.key[2]}].")


def validate_state(model: _ModelLike, state: StreamingState, batch_size: int) -> None:
    """Shape and type validation of a streaming state collection (an
    attention layer's cache length is read from its entry)."""
    entries = state.values() if isinstance(state, dict) else state
    max_len = _kv_max_len(entries) if isinstance(state, (dict, list, tuple)) else 0
    shapes = expected_state_shapes(model, batch_size, max_len=max_len)
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
        if isinstance(shapes[idx], KVStateShape):
            _validate_kv_entry(idx, layer_state, shapes[idx])
            continue
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
