"""Weights in and out of the PyTorch port: JAX trees, checkpoint files.

``params_from_jax`` maps a videomamba_tpu parameter tree (as NumPy arrays)
onto this package's state_dict, with the layout mapping of
videomamba_tpu/checkpoint.py:224-277 (params_to_torch_state_dict):

  Linear ``kernel (in, out)``         -> ``weight (out, in)``
  depthwise conv ``weight (W, D)``    -> ``conv1d.weight (D, 1, W)``
  patch ``kernel (C*kt*p*p, E)``      -> ``patch_embed.proj.weight (E, C, kt, p, p)``
  everything else                     -> unchanged

for both mixers: Mamba-1's in_proj, conv1d, x_proj, dt_proj, A_log, D,
out_proj and Mamba-2's in_proj, conv1d, dt_bias, A_log, D, norm, out_proj.
``refiner_params_from_jax`` does the same for a ``BiMambaRefinerBlock``.
It reads NumPy only and never imports jax. ``load_state_dict`` loads a
state_dict strictly (a missing or unexpected key raises), or, given a path
first, a checkpoint file as the JAX ``load_state_dict`` does. A bf16 tree (from
``cast_params_for_compute``) maps to fp32 tensors holding the same values,
which load exactly into a model built at bf16.

The file half follows the JAX package's (checkpoint.py:46-130, 280-472)
and the reference loader's contract:

* ``load_checkpoint`` reads a plain ``.pt`` state_dict (``weights_only=True``,
  with a ``TypeError`` fallback for an older torch; ``{"model": ...}`` /
  ``{"module": ...}`` wrappers and non-tensor entries are refused), re-grids
  the spatial pos-embed (bicubic, aspect-ratio-closest factorization) and
  resamples the temporal one (linear, driven by the required
  ``ckpt_num_frame``) with the NumPy matrices of ``ops/resample.py``, so the
  loaded values are bit-equal to the JAX package's, and loads strictly;
* ``save_torch_state_dict`` writes a reference-compatible ``.pt`` (fp32 CPU
  tensors), which the JAX package's ``load_state_dict`` reads;
* ``save_params`` / ``load_params`` and ``save_train_state`` /
  ``load_train_state`` are ``torch.save`` files of the state_dict, the
  optimizer's state and the step (the JAX package writes flax msgpack;
  cross-framework files are the ``.pt`` state_dicts); a train state of
  FSDP2 shards is gathered whole on save and cut back into each rank's
  shards on load;
* ``load_timm_npz`` maps the ViT subset of a timm ``.npz``.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from videomamba_tpu_torch.ops.resample import (
    cubic_resample_matrix,
    infer_spatial_grid,
    linear_resample_matrix,
)

logger = logging.getLogger(__name__)

Tensor = torch.Tensor

# Mixer keys in state_dict order (the JAX exporter's, checkpoint.py:246-272).
_MAMBA1_KEYS = ("in_proj", "conv1d", "x_proj", "dt_proj", "A_log", "D", "out_proj")
_MAMBA2_KEYS = ("in_proj", "conv1d", "dt_bias", "A_log", "D", "norm", "out_proj")


def _putter(sd: Dict[str, Tensor]):
    def put(name: str, v) -> None:
        sd[name] = torch.from_numpy(np.array(v, dtype=np.float32))
    return put


def _block_params(lp: Mapping[str, Any], pfx: str, put) -> None:
    """One Block's JAX tree (norm and mixer) under the key prefix ``pfx``."""
    put(pfx + "norm.weight", lp["norm"]["weight"])
    if "bias" in lp["norm"]:
        put(pfx + "norm.bias", lp["norm"]["bias"])
    mx = lp["mixer"]
    mpfx = pfx + "mixer."
    names = _MAMBA1_KEYS if "x_proj" in mx else _MAMBA2_KEYS
    for name in (n for n in names if n in mx):
        leaf = mx[name]
        if not isinstance(leaf, Mapping):  # A_log, D, dt_bias
            put(mpfx + name, leaf)
            continue
        if name == "conv1d":
            w = np.asarray(leaf["weight"], np.float32).T[:, None, :]
        elif "kernel" in leaf:
            w = np.asarray(leaf["kernel"], np.float32).T
        else:  # Mamba-2's gated-norm weight
            w = leaf["weight"]
        put(mpfx + name + ".weight", w)
        if "bias" in leaf:
            put(mpfx + name + ".bias", leaf["bias"])


def params_from_jax(tree: Mapping[str, Any], model) -> Dict[str, Tensor]:
    """State_dict (fp32 CPU tensors) for ``model`` from a JAX param tree.

    ``tree`` is ``PretrainVideoMamba.params`` of videomamba_tpu with NumPy
    leaves; ``model`` is this package's PretrainVideoMamba, which supplies the
    patch geometry the flat patch kernel does not carry.
    """
    sd: Dict[str, Tensor] = {}
    put = _putter(sd)
    e, c, kt, p1, p2 = model.patch_embed.proj.weight.shape
    put("patch_embed.proj.weight",
        np.asarray(tree["patch_embed"]["kernel"], np.float32).T.reshape(e, c, kt, p1, p2))
    put("patch_embed.proj.bias", tree["patch_embed"]["bias"])
    put("cls_token", tree["cls_token"])
    put("pos_embed", tree["pos_embed"])
    put("temporal_pos_embedding", tree["temporal_pos_embedding"])
    for i, lp in enumerate(tree["layers"]):
        _block_params(lp, f"layers.{i}.", put)
    put("norm.weight", tree["norm"]["weight"])
    if "bias" in tree["norm"]:
        put("norm.bias", tree["norm"]["bias"])
    if "pool_norm" in tree:
        put("pool_norm.weight", tree["pool_norm"]["weight"])
        put("pool_norm.bias", tree["pool_norm"]["bias"])
    return sd


def refiner_params_from_jax(tree: Mapping[str, Any], refiner=None) -> Dict[str, Tensor]:
    """State_dict (fp32 CPU tensors) for a ``BiMambaRefinerBlock`` from the
    JAX refiner's tree: both Blocks by the Block mapping, the fusion gate's
    and output projection's ``kernel (in, out)`` as ``weight (out, in)``.
    ``refiner`` is accepted for symmetry with :func:`params_from_jax`; the
    tree carries every shape."""
    del refiner
    sd: Dict[str, Tensor] = {}
    put = _putter(sd)
    for name in ("block_fwd", "block_bwd"):
        _block_params(tree[name], name + ".", put)
    for name in ("fusion_gate", "out_proj"):
        put(name + ".weight", np.asarray(tree[name]["kernel"], np.float32).T)
        put(name + ".bias", tree[name]["bias"])
    return sd


def load_state_dict(target, source=None, ckpt_num_frame: Optional[int] = None,
                    num_frames: Optional[int] = None) -> None:
    """Load weights strictly, in either of two forms:

    * ``load_state_dict(model, state_dict)``: copy ``state_dict`` (tensors or
      NumPy arrays) into ``model``; values are cast to each parameter's
      dtype and device; a missing or unexpected key raises;
    * ``load_state_dict(pretrained_path, model, ckpt_num_frame, num_frames)``:
      the JAX package's and the reference's form (JAX checkpoint.py:291), a
      ``str`` or path first: :func:`load_checkpoint`.
    """
    if isinstance(target, (str, os.PathLike)):
        load_checkpoint(target, source, ckpt_num_frame, num_frames)
        return
    sd = {
        k: v if isinstance(v, Tensor) else torch.from_numpy(np.asarray(v))
        for k, v in source.items()
    }
    target.load_state_dict(sd, strict=True)


# --------------------------------------------------------------------- files

def _torch_load_plain_state_dict(pretrained_path: str) -> Dict[str, Tensor]:
    """Read a ``.pt`` checkpoint into fp32 CPU tensors, enforcing the
    plain-dict contract."""
    try:
        checkpoint_model = torch.load(pretrained_path, map_location="cpu", weights_only=True)
    except TypeError:  # a torch without ``weights_only``
        checkpoint_model = torch.load(pretrained_path, map_location="cpu")
    if not isinstance(checkpoint_model, dict):
        raise TypeError("Expected a plain state_dict (dict) checkpoint.")
    if "model" in checkpoint_model or "module" in checkpoint_model:
        raise ValueError(
            "Checkpoint wrapper keys ('model'/'module') are not supported. "
            "Pass a plain state_dict checkpoint."
        )
    out: Dict[str, Tensor] = {}
    for k, v in checkpoint_model.items():
        if not torch.is_tensor(v):
            raise TypeError(f"Checkpoint entry {k!r} is not a tensor.")
        out[k] = v.detach().to(device="cpu", dtype=torch.float32)
    return out


def _regrid(pos: np.ndarray, old_hw, new_hw) -> np.ndarray:
    """(B, old_h*old_w, C) -> (B, new_h*new_w, C): separable bicubic, as the
    JAX package's NumPy einsums (same matrices, same order)."""
    (old_h, old_w), (new_h, new_w) = old_hw, new_hw
    grid = pos.reshape(-1, old_h, old_w, pos.shape[-1])
    grid = np.einsum("oh,bhwc->bowc", cubic_resample_matrix(old_h, new_h), grid)
    grid = np.einsum("pw,bowc->bopc", cubic_resample_matrix(old_w, new_w), grid)
    return grid.reshape(-1, new_h * new_w, pos.shape[-1])


def _interp_pos_embed(sd: Dict[str, Tensor], model, ckpt_num_frame: Optional[int],
                      num_frames: int) -> Dict[str, Tensor]:
    """Spatial re-grid and temporal resample of the checkpoint's
    embeddings (JAX checkpoint.py:80-130)."""
    pos_embed_checkpoint = sd["pos_embed"].numpy()
    num_patches = model.patch_embed.num_patches
    num_extra_tokens = model.pos_embed.shape[-2] - num_patches
    orig_token_count = pos_embed_checkpoint.shape[-2] - num_extra_tokens
    new_grid_h = model.patch_embed.img_size[0] // model.patch_embed.patch_size[0]
    new_grid_w = model.patch_embed.img_size[1] // model.patch_embed.patch_size[1]
    if new_grid_h * new_grid_w != num_patches:
        raise ValueError(
            "Model patch grid size mismatch: "
            f"{new_grid_h}x{new_grid_w} != num_patches({num_patches})."
        )
    orig_grid = infer_spatial_grid(orig_token_count, (new_grid_h, new_grid_w))
    sd = dict(sd)
    if orig_grid != (new_grid_h, new_grid_w):
        logger.info("Position interpolate from %dx%d to %dx%d",
                    *orig_grid, new_grid_h, new_grid_w)
        extra = pos_embed_checkpoint[:, :num_extra_tokens]
        pos_tokens = _regrid(pos_embed_checkpoint[:, num_extra_tokens:], orig_grid,
                             (new_grid_h, new_grid_w))
        sd["pos_embed"] = torch.from_numpy(np.concatenate([extra, pos_tokens], axis=1))

    if ckpt_num_frame is None or ckpt_num_frame <= 0:
        raise ValueError(
            "ckpt_num_frame must be a positive integer when loading pretrained weights."
        )
    orig_t = ckpt_num_frame // model.patch_embed.tubelet_size
    new_t = num_frames // model.patch_embed.tubelet_size
    if orig_t != new_t:
        logger.info("Temporal interpolate from %d to %d", orig_t, new_t)
        temporal = sd["temporal_pos_embedding"].numpy()
        sd["temporal_pos_embedding"] = torch.from_numpy(
            np.einsum("ol,blc->boc", linear_resample_matrix(orig_t, new_t), temporal))
    return sd


def load_checkpoint(pretrained_path: str, model, ckpt_num_frame: int, num_frames: int) -> None:
    """Load a reference ``.pt`` checkpoint into ``model`` strictly, with the
    pos-embed re-grid and temporal resample (the JAX package's
    ``load_state_dict(pretrained_path, model, ...)``)."""
    logger.info("Loading pretrained weights from %s", pretrained_path)
    sd = _torch_load_plain_state_dict(pretrained_path)
    sd = _interp_pos_embed(sd, model, ckpt_num_frame, num_frames)
    load_state_dict(model, sd)
    logger.info("Loaded %d checkpoint tensors.", len(sd))


def _cpu_fp32(state: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    return {k: v.detach().to(device="cpu", dtype=torch.float32).contiguous().clone()
            for k, v in state.items()}


def save_torch_state_dict(path: str, model) -> None:
    """Write a reference-compatible ``.pt`` checkpoint: the model's
    state_dict as fp32 CPU tensors."""
    torch.save(_cpu_fp32(model.state_dict()), path)


def save_params(path: str, model) -> None:
    """Save the model's state_dict (its own dtypes) with ``torch.save``."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load_params(path: str, model):
    """Load a file of :func:`save_params` into ``model`` strictly and return
    the model."""
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    return model


def _put(dst: Tensor, whole: Tensor) -> None:
    """Copy a tensor whole over the data ranks into ``dst`` in place: into
    a ``DTensor``'s own shard (cut as FSDP2 cuts it, by its placements),
    else all of it."""
    if hasattr(dst, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        whole = distribute_tensor(whole.to(device=dst.device, dtype=dst.dtype),
                                  dst.device_mesh, dst.placements).to_local()
        dst = dst.to_local()
    dst.copy_(whole)


def _param_names(model, optimizer) -> Dict[int, str]:
    """The optimizer state's integer keys -> the model's parameter names."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {i: names[id(p)]
            for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}


def _map_param_shaped(states, names, shapes, fn) -> None:
    """In an optimizer's per-parameter states, replace each state key's
    tensors shaped like their parameters (``shapes``: AdamW's moments,
    SGD's momentum; not a step count) by ``fn`` of them, a {name: tensor}
    map, one key at a time; every rank must call it alike."""
    for key in sorted({k for st in states.values() for k in st}):
        done = fn({names[i]: st[key] for i, st in states.items()
                   if isinstance(st.get(key), Tensor) and st[key].shape == shapes[i]})
        for i, st in states.items():
            if names[i] in done:
                st[key] = done[names[i]]


def save_train_state(path: str, model, optimizer: torch.optim.Optimizer, step) -> None:
    """A training checkpoint: the model's state_dict, the optimizer's state
    and the step counter, in one ``torch.save`` file of whole CPU tensors
    in the unsharded layout.

    A model placed by ``parallel.init_train_state(..., mesh)`` holds FSDP2
    shards (``DTensor``) and, at tp > 1, each Mamba-1 mixer's tp channels:
    every rank must call this; the parameters and the optimizer states
    shaped like them are gathered whole (``parallel.train_step.
    full_tensors``), the main process writes the file and every rank waits
    for it (JAX checkpoint.py:322-336: arrays gathered on save)."""
    from videomamba_tpu_torch.parallel.train_step import full_tensors
    from videomamba_tpu_torch.utils.distributed import (
        is_dist_avail_and_initialized,
        is_main_process,
    )

    def whole_cpu(tensors):
        return {k: v.cpu() for k, v in full_tensors(model, tensors).items()}

    params = whole_cpu(model.state_dict())
    opt = optimizer.state_dict()
    shapes = [p.shape for g in optimizer.param_groups for p in g["params"]]
    states = {i: {k: v.detach().cpu() if isinstance(v, Tensor) and v.shape != shapes[i] else v
                  for k, v in st.items()} for i, st in opt["state"].items()}
    _map_param_shaped(states, _param_names(model, optimizer), shapes, whole_cpu)
    if is_main_process():
        torch.save({"params": params,
                    "opt_state": {"state": states, "param_groups": opt["param_groups"]},
                    "step": int(step)}, path)
    if is_dist_avail_and_initialized():
        import torch.distributed as dist

        dist.barrier()


def load_train_state(path: str, model, optimizer: torch.optim.Optimizer) -> int:
    """Restore a file of :func:`save_train_state` into ``model`` (strictly)
    and ``optimizer``; returns the step. Into a model placed by
    ``init_train_state(..., mesh)`` (every rank calls it) each rank copies
    its own part of every parameter and of every optimizer state shaped
    like its parameter: its tp channels (``parallel.train_step.
    local_tensors``), then its FSDP2 shard (``_put``). The file's layout is
    the unsharded one, so a run resumes on another mesh or none."""
    from videomamba_tpu_torch.parallel.train_step import local_tensors

    state = torch.load(path, map_location="cpu", weights_only=True)
    own = model.state_dict(keep_vars=True)
    missing, unexpected = own.keys() - state["params"].keys(), state["params"].keys() - own.keys()
    if missing or unexpected:
        raise RuntimeError(f"load_train_state: missing keys {sorted(missing)}, "
                           f"unexpected keys {sorted(unexpected)}")
    local = local_tensors(model, state["params"])
    with torch.no_grad():
        for k, dst in own.items():
            _put(dst, local[k])

    def placed(whole):
        out = {}
        for name, t in local_tensors(model, whole).items():
            out[name] = torch.empty_like(own[name], requires_grad=False)
            _put(out[name], t)
        return out

    names = _param_names(model, optimizer)
    shapes = {i: state["params"][n].shape for i, n in names.items()}
    opt_state = state["opt_state"]
    _map_param_shaped(opt_state["state"], names, shapes, placed)
    optimizer.load_state_dict(opt_state)
    return int(state["step"])


def load_timm_npz(
    checkpoint_path: str,
    model,
    prefix: str = "",
    on_unmapped: str = "warn",
    num_prefix_tokens: Optional[int] = None,
) -> Dict[str, Tensor]:
    """The model's state_dict with the ViT subset of a timm ``.npz`` mapped
    in (JAX checkpoint.py:350-472, the reference's ``load_pretrained``).

    Mapped: the patch embedding (the 2D conv kernel broadcast over the
    tubelet axis and divided by it), the CLS token, the positional
    embedding (bicubic re-grid when the checkpoint grid differs, after
    ``num_prefix_tokens`` prefix tokens, by default the model's one CLS
    slot), and the final encoder norm. ViT blocks, the head and
    ``pre_logits`` have no VideoMamba counterpart; they are skipped and
    reported per ``on_unmapped`` ("ignore" | "warn" | "error"). Returns a new
    state_dict at the model's dtypes and device; the model is not changed
    (``PretrainVideoMamba.load_pretrained`` loads it).
    """
    w = np.load(checkpoint_path)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    consumed = set()

    def g(name):
        full = prefix + name
        if full in w:
            consumed.add(full)
            return w[full]
        return None

    def put(name, value):
        sd[name] = torch.from_numpy(np.ascontiguousarray(value)).to(
            dtype=sd[name].dtype, device=sd[name].device)

    emb = g("embedding/kernel")
    if emb is not None:
        # ViT conv kernel (p, p, C, E) -> (C, kt, p, p, E) / kt -> (E, C, kt, p, p).
        kt = model.patch_embed.tubelet_size
        k2d = np.transpose(emb, (2, 0, 1, 3))
        k3d = np.repeat(k2d[:, None], kt, axis=1) / float(kt)
        put("patch_embed.proj.weight", np.moveaxis(k3d, -1, 0))
        bias = g("embedding/bias")
        if bias is not None:
            put("patch_embed.proj.bias", bias)
    cls = g("cls")
    if cls is not None:
        put("cls_token", cls)
    pos = g("Transformer/posembed_input/pos_embedding")
    if pos is not None:
        want = tuple(model.pos_embed.shape)
        if pos.shape != want:
            # timm resize_pos_embed: keep the prefix tokens, bicubic the grid.
            extra = (num_prefix_tokens if num_prefix_tokens is not None
                     else want[-2] - model.patch_embed.num_patches)
            if not 0 <= extra <= pos.shape[-2]:
                raise ValueError(
                    f"timm npz: num_prefix_tokens={extra} out of range for a "
                    f"pos embedding with {pos.shape[-2]} tokens."
                )
            prefix_tok, grid = pos[:, :extra], pos[:, extra:]
            new_h = model.patch_embed.img_size[0] // model.patch_embed.patch_size[0]
            new_w = model.patch_embed.img_size[1] // model.patch_embed.patch_size[1]
            grid_count = grid.shape[-2]
            # A ViT grid is near-square: a factorization more than 2x off the
            # model grid's aspect means the prefix assumption is wrong.
            old_h, old_w = infer_spatial_grid(grid_count, (new_h, new_w))
            ref_ratio = new_h / new_w
            if not (ref_ratio / 2 <= old_h / old_w <= ref_ratio * 2):
                raise ValueError(
                    f"timm npz: checkpoint grid of {grid_count} tokens (after "
                    f"stripping {extra} prefix tokens) only factorizes as "
                    f"{old_h}x{old_w}, implausible vs the model grid "
                    f"{new_h}x{new_w}. The checkpoint likely uses a different "
                    "prefix-token convention; pass num_prefix_tokens "
                    "explicitly."
                )
            grid = _regrid(grid, (old_h, old_w), (new_h, new_w))
            pos = np.concatenate([prefix_tok, grid.reshape(1, new_h * new_w, -1)], axis=1)
        put("pos_embed", pos)
    scale = g("Transformer/encoder_norm/scale")
    if scale is not None:
        put("norm.weight", scale)
        bias = g("Transformer/encoder_norm/bias")
        if bias is not None and "norm.bias" in sd:
            put("norm.bias", bias)

    unmapped = sorted(
        {k.split("/")[0 if not k.startswith("Transformer/") else 1]
         for k in w.files if k not in consumed}
    )
    if unmapped and on_unmapped != "ignore":
        msg = f"timm npz: skipped key groups with no VideoMamba counterpart: {unmapped}"
        if on_unmapped == "error":
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    return sd
