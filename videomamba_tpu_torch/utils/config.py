"""File-based config system: port of videomamba_tpu/utils/config.py,
behaviour for behaviour (that module uses no JAX; this copy imports nothing
of the JAX package).

Same *surface* as the reference (``Config.get_config/from_file/merge_list``,
``eval_dict_leaf``/``eval_string``/``merge_a_into_b``): ``.py``/``.yaml``/
``.json`` config files, ``_base_`` inheritance with duplicate-key rejection
across bases, dotted-key CLI overrides, and leaf-string evaluation
(``'0.2'`` -> float, ``'[1, 2]'`` -> list, ``'${a.b}'`` reference
interpolation, ``'eval(...)'`` expressions).

Design (the JAX module's):

- per-suffix loaders live in a ``_LOADERS`` registry instead of an if/elif
  chain, so a project can register a new format without editing this file;
- ``.py`` configs get collision-proof module names from a monotonic counter
  (the reference regression: two ``cfg.py`` files in different directories
  must not share a module-cache entry);
- ``_base_`` resolution is a small recursive fold (``_resolve``), separated
  from file IO;
- the reference's bare ``eval`` (its config.py:290-305 carries the security
  TODO) is replaced by :func:`_safe_eval`: empty builtins plus a small
  arithmetic whitelist — config files can compute, not execute.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import itertools
import json
import re
import sys
from copy import deepcopy
from pathlib import Path

import yaml

from videomamba_tpu_torch.utils.easydict import EasyDict

__all__ = ["Config", "eval_dict_leaf", "eval_string", "merge_a_into_b"]

BASE_KEY = "_base_"
BASE_CONFIG: dict = {}

cfg = None  # process-wide parsed config (reference keeps the same global)

_SAFE_EVAL_NAMES = {
    "abs": abs, "min": min, "max": max, "len": len, "range": range,
    "sum": sum, "round": round, "int": int, "float": float, "str": str,
    "list": list, "tuple": tuple, "dict": dict, "bool": bool,
    "sorted": sorted, "enumerate": enumerate, "zip": zip,
}

_INTERP = re.compile(r"\$\{(.*)\}")
_module_serial = itertools.count()


def _safe_eval(expr: str, extra=None):
    """Evaluate an expression with no builtins and a small whitelist."""
    namespace = dict(_SAFE_EVAL_NAMES)
    if extra:
        namespace.update(extra)
    return eval(expr, {"__builtins__": {}}, namespace)  # noqa: S307 - sandboxed


# --------------------------------------------------------------- file loaders

def _load_py(path: Path) -> dict:
    """Execute a .py config under a unique module name.

    The serial-numbered name keeps two configs with the same stem (e.g.
    ``a/cfg.py`` and ``b/cfg.py``) from ever sharing a module-cache entry;
    the entry is dropped again right after execution either way.
    """
    name = f"_vm_cfg_{next(_module_serial)}_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, str(path))
    if spec is None or spec.loader is None:
        raise ImportError(f"Cannot import config file: {path}")
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(path.parent))
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        sys.modules.pop(name, None)
        if sys.path and sys.path[0] == str(path.parent):
            sys.path.pop(0)
    return {k: v for k, v in vars(module).items() if not k.startswith("__")}


def _load_yaml(path: Path) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def _load_json(path: Path) -> dict:
    with open(path, "r") as f:
        return json.load(f)


_LOADERS = {
    ".py": _load_py,
    ".yml": _load_yaml,
    ".yaml": _load_yaml,
    ".json": _load_json,
}


def _resolve(path: Path) -> dict:
    """Load one file and fold its ``_base_`` chain (bases may have bases).

    Bases must be key-disjoint with each other (duplicate keys across bases
    are ambiguous — rejected, same rule as the reference); the child then
    wins over the merged bases.
    """
    if not path.is_file():
        raise IOError(f"File does not exist: {path}")
    loader = _LOADERS.get(path.suffix)
    if loader is None:
        raise IOError("Only py/yml/yaml/json type are supported now!")
    raw = loader(path)

    bases = raw.pop(BASE_KEY, None)
    if bases is None:
        return raw
    if not isinstance(bases, list):
        bases = [bases]
    merged: dict = {}
    for rel in bases:
        one = _resolve((path.parent / rel).resolve())
        clash = merged.keys() & one.keys()
        if clash:
            raise KeyError(f"Duplicate key is not allowed among bases: {clash}")
        merged.update(one)
    return merge_a_into_b(raw, merged)


def _format_value(value, indent: int) -> str:
    if not isinstance(value, dict):
        return repr(value)
    pad = " " * indent
    body = ",\n".join(
        f"{pad}{k}: {_format_value(v, indent + 2)}" for k, v in value.items()
    )
    return "{\n" + body + "\n" + " " * max(indent - 2, 0) + "}"


# ------------------------------------------------------------------- Config

class Config:
    """Config loader/merger (same classmethod surface as the reference)."""

    @classmethod
    def pretty_text(cls, cfg: dict, indent: int = 2) -> str:
        return _format_value(cfg, indent)

    @classmethod
    def dump(cls, cfg, savepath=None):
        if savepath is None:
            savepath = str(Path(cfg.WORKSPACE) / "config.json")
        with open(savepath, "w") as f:
            json.dump(cfg, f, indent=2)

    @classmethod
    def get_config(cls, default_config: dict | None = None):
        """Parse argv: positional config file + 'key value' override pairs."""
        global cfg
        if cfg is not None:
            return cfg

        parser = argparse.ArgumentParser()
        parser.add_argument(
            "config_file",
            help="the configuration file to load. support: .yaml, .json, .py",
        )
        parser.add_argument(
            "opts",
            default=None,
            nargs="*",
            help="overrided configs. List. Format: 'key1 name1 key2 name2'",
        )
        args = parser.parse_args()

        defaults = BASE_CONFIG if default_config is None else default_config
        merged = EasyDict(defaults)
        if Path(args.config_file).is_file():
            merged = merge_a_into_b(cls.from_file(args.config_file), merged)
        merged = eval_dict_leaf(cls.merge_list(merged, args.opts))
        # Keys from the defaults sort to the end (reference ordering rule).
        for k in BASE_CONFIG:
            merged[k] = merged.pop(k)
        cfg = merged
        return cfg

    @classmethod
    def from_file(cls, filepath: str) -> EasyDict:
        """Load one config file; supports ``_base_`` inheritance."""
        return EasyDict(_resolve(Path(filepath).expanduser().resolve()))

    @classmethod
    def merge_list(cls, cfg, opts: list):
        """Merge dotted-key CLI overrides: ['a.b', v, ...] => cfg.a.b = v."""
        assert len(opts) % 2 == 0, f"length of opts must be even. Got: {opts}"
        for full_key, value in zip(opts[0::2], opts[1::2]):
            *parents, leaf = full_key.split(".")
            node = cfg
            for part in parents + [leaf]:
                if not hasattr(node, part):
                    raise ValueError(
                        f"The key {part} not exist in the config. "
                        f"Full key:{full_key}"
                    )
                if part is not leaf:
                    node = node[part]
            node[leaf] = value
        return cfg


# ---------------------------------------------------------------- leaf eval

def merge_a_into_b(a, b, inplace=False):
    """Recursively merge dict a into dict b (a wins)."""
    if not inplace:
        b = deepcopy(b)
    for key, value in a.items():
        if isinstance(value, dict) and isinstance(b.get(key), dict):
            merge_a_into_b(value, b[key], inplace=True)
        else:
            b[key] = value
    return b


def eval_dict_leaf(d, orig_dict=None):
    """Evaluate every string leaf of a nested dict (in place)."""
    root = d if orig_dict is None else orig_dict
    for key, value in d.items():
        if isinstance(value, dict):
            eval_dict_leaf(value, root)
        else:
            d[key] = eval_string(value, root)
    return d


def eval_string(string, d):
    """Coerce a string leaf to its value.

    '0' -> 0; '0.2' -> 0.2; '[0, 1]' -> list; 'eval(1+2)' -> 3 (sandboxed);
    '${a.b}' -> d.a.b (then sandbox-evaluated); non-strings pass through.
    """
    if not isinstance(string, str):
        return string
    if string.startswith("eval(") and string.endswith(")"):
        return _safe_eval(string[5:-1], extra={"d": d})

    substituted, n = _INTERP.subn(r"d.\1", string)
    if n:
        while True:
            substituted, n = _INTERP.subn(r"d.\1", substituted)
            if not n:
                break
        return _safe_eval(substituted, extra={"d": d})

    try:
        return ast.literal_eval(string)
    except (SyntaxError, ValueError):
        return string
