"""Dataset ingestion for the native clip loader (PyTorch port).

Port of videomamba_tpu/data/dataset.py. Two standard layouts:

* **file list**: one sample per line, ``<path> <label>`` (Kinetics-style
  annotation files; whitespace- or comma-separated, ``#`` comments allowed);
* **class directories**: ``root/<class_name>/<clip>.{npy,vraw,vmjpg}``
  with labels assigned by sorted class-name index (ImageNet-style).

Both feed :class:`videomamba_tpu_torch.data.native.NativeClipLoader`, which
keeps its determinism: sample order and augmentation draws are fixed by
(seed, epoch), whatever the thread count.
"""

from __future__ import annotations

import shlex
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

CLIP_EXTENSIONS = (".npy", ".vraw", ".vmjpg")


def load_file_list(
    list_path, root: Optional[str] = None
) -> Tuple[List[str], List[int]]:
    """Parse a ``<path> <label>`` annotation file into (paths, labels).

    Lines are whitespace- or comma-separated; blank lines and ``#`` comments
    are skipped. Relative paths resolve against ``root`` (default: the list
    file's directory). Paths containing spaces may be quoted or use the
    comma-separated form.
    """
    list_path = Path(list_path)
    base = Path(root) if root is not None else list_path.parent
    paths: List[str] = []
    labels: List[int] = []
    with open(list_path, "r", encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "," in line:
                parts = [p.strip() for p in line.split(",")]
            else:
                parts = shlex.split(line)
            if len(parts) != 2:
                raise ValueError(
                    f"{list_path}:{lineno}: expected '<path> <label>', "
                    f"got {line!r}"
                )
            p, lab = parts
            try:
                label = int(lab)
            except ValueError as e:
                raise ValueError(
                    f"{list_path}:{lineno}: label {lab!r} is not an int"
                ) from e
            full = Path(p)
            if not full.is_absolute():
                full = base / full
            paths.append(str(full))
            labels.append(label)
    if not paths:
        raise ValueError(f"{list_path}: no samples found")
    return paths, labels


def scan_class_directories(
    root, extensions: Sequence[str] = CLIP_EXTENSIONS
) -> Tuple[List[str], List[int], List[str]]:
    """Scan ``root/<class>/<clip>`` into (paths, labels, class_names).

    Classes are the sorted immediate subdirectory names; files are sorted
    within each class, so the sample indexing (and with it the loader's
    per-sample RNG) is the same on every filesystem.
    """
    root = Path(root)
    if not root.is_dir():
        raise FileNotFoundError(f"dataset root {root} is not a directory")
    class_names = sorted(
        d.name for d in root.iterdir() if d.is_dir() and not d.name.startswith(".")
    )
    if not class_names:
        raise ValueError(f"{root}: no class subdirectories found")
    exts = tuple(e.lower() for e in extensions)
    paths: List[str] = []
    labels: List[int] = []
    for idx, name in enumerate(class_names):
        files = sorted(
            p for p in (root / name).rglob("*")
            if p.is_file() and p.suffix.lower() in exts
        )
        for p in files:
            paths.append(str(p))
            labels.append(idx)
    if not paths:
        raise ValueError(
            f"{root}: no clip files with extensions {exts} found"
        )
    return paths, labels, class_names


def make_clip_loader(
    data_dir: Optional[str] = None,
    file_list: Optional[str] = None,
    *,
    train: bool = False,
    **loader_kwargs,
):
    """Build a :class:`NativeClipLoader` from a directory layout or file list.

    Exactly one of ``data_dir`` / ``file_list`` must be given. Returns
    (loader, num_classes). ``loader_kwargs`` pass through to the loader
    (clip_len, crop, batch_size, num_threads, ...).
    """
    from videomamba_tpu_torch.data.native import NativeClipLoader

    if (data_dir is None) == (file_list is None):
        raise ValueError("pass exactly one of data_dir or file_list")
    if data_dir is not None:
        paths, labels, class_names = scan_class_directories(data_dir)
        num_classes = len(class_names)
    else:
        paths, labels = load_file_list(file_list)
        num_classes = max(labels) + 1
    loader = NativeClipLoader(paths, labels, train=train, **loader_kwargs)
    return loader, num_classes
