"""ctypes binding to the native (C++) clip loader (PyTorch port).

Port of videomamba_tpu/data/native.py. The loader itself,
``native/videoloader/{videoloader,jpeg}.cc``, is framework-neutral C++17 with
a plain C interface (a threaded prefetch loader: decode, crop, flip,
normalise off the Python thread); this module builds it with ``g++`` and
wraps it as a Python iterable that yields CPU tensors.

The library goes to ``build/videomamba_tpu_torch/`` at the repository root
under a name that carries a hash of the sources and the flags, written to a
temporary name and moved into place with ``os.replace``: processes that
build at once (parallel test workers) never load a half-written file, and
the JAX package's own build under ``native/build/`` is never touched.

Determinism: the per-sample RNG is keyed on (seed, epoch, sample index), so
a given (seed, epoch) yields bit-identical batches whatever the thread
count or scheduling.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import io
import os
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from videomamba_tpu_torch.ops.kernels._build import BUILD_DIR

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC_DIR = _REPO_ROOT / "native" / "videoloader"
_SOURCES = ("videoloader.cc", "jpeg.cc")
_HEADERS = ("jpeg.h",)
_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def native_available() -> bool:
    """True when the shared library exists or can be built here."""
    try:
        _load_lib()
        return True
    except (OSError, RuntimeError):
        return False


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_native() -> Path:
    """Compile the loader with g++ unless this exact source set is built."""
    if not (_SRC_DIR / _SOURCES[0]).exists():
        raise FileNotFoundError(f"native source missing: {_SRC_DIR / _SOURCES[0]}")
    so = BUILD_DIR / f"libvideoloader_{_source_hash()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so_tmp = os.path.join(tmp, so.name)
        cmd = [os.environ.get("CXX", "g++"), *_CXX_FLAGS,
               *(str(_SRC_DIR / s) for s in _SOURCES), "-o", so_tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed:\n{proc.stderr}")
        os.replace(so_tmp, so)  # atomic: a concurrent build sees all or nothing
    return so


@functools.lru_cache(maxsize=1)
def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native()))
    lib.vml_create.restype = ctypes.c_void_p
    lib.vml_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
    ]
    lib.vml_start_epoch.restype = ctypes.c_int32
    lib.vml_start_epoch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64]
    lib.vml_next.restype = ctypes.c_int32
    lib.vml_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64)]
    lib.vml_batch_floats.restype = ctypes.c_int64
    lib.vml_batch_floats.argtypes = [ctypes.c_void_p]
    lib.vml_last_error.restype = ctypes.c_char_p
    lib.vml_last_error.argtypes = [ctypes.c_void_p]
    lib.vml_destroy.restype = None
    lib.vml_destroy.argtypes = [ctypes.c_void_p]
    return lib


def write_vraw(path, video: np.ndarray) -> None:
    """Write a (T, H, W, C) uint8 array in the VMRAW001 shard format."""
    video = np.ascontiguousarray(video, dtype=np.uint8)
    if video.ndim != 4:
        raise ValueError(f"expected (T, H, W, C), got {video.shape}")
    with open(path, "wb") as f:
        f.write(b"VMRAW001")
        f.write(struct.pack("<4I", *video.shape))
        f.write(video.tobytes())


def write_vmjpg(path, jpeg_frames: Sequence[bytes],
                height: int, width: int) -> None:
    """Write an MJPEG shard (VMJPG001): per-frame baseline JPEG payloads
    with an offset index, decoded by the loader's own baseline JPEG
    decoder. All frames must share (height, width)."""
    offsets = np.zeros(len(jpeg_frames) + 1, dtype=np.uint64)
    for i, fr in enumerate(jpeg_frames):
        offsets[i + 1] = offsets[i] + len(fr)
    with open(path, "wb") as f:
        f.write(b"VMJPG001")
        f.write(struct.pack("<4I", len(jpeg_frames), height, width, 3))
        f.write(offsets.tobytes())
        for fr in jpeg_frames:
            f.write(fr)


def encode_vmjpg(path, video: np.ndarray, quality: int = 90,
                 subsampling: int = 0) -> None:
    """Encode a (T, H, W, 3) uint8 array as a VMJPG001 shard with PIL
    (baseline JPEGs; subsampling=0 is 4:4:4). PIL is needed only to write;
    the loader decodes natively."""
    from PIL import Image

    video = np.ascontiguousarray(video, dtype=np.uint8)
    frames = []
    for t in range(video.shape[0]):
        buf = io.BytesIO()
        Image.fromarray(video[t]).save(
            buf, format="JPEG", quality=quality, subsampling=subsampling)
        frames.append(buf.getvalue())
    write_vmjpg(path, frames, video.shape[1], video.shape[2])


class NativeClipLoader:
    """Threaded native clip loader yielding (B, C, T, S, S) float32 batches
    as CPU tensors, with int64 labels.

    Accepts ``.npy`` files (uint8, C-order, shape (T, H, W, C)),
    ``VMRAW001`` shards (:func:`write_vraw`) and ``VMJPG001`` shards.
    ``train=True`` enables a random temporal start, a random crop and a
    horizontal flip; otherwise a center start and a center crop.
    ``short_side > 0`` resizes the short side to that length (bilinear,
    align_corners=False, the convention of ``ops/resample.py``) before
    cropping.
    """

    def __init__(
        self,
        paths: Sequence[str],
        labels: Optional[Sequence[int]] = None,
        *,
        clip_len: int = 8,
        frame_stride: int = 1,
        short_side: int = 0,
        crop: int = 224,
        batch_size: int = 4,
        num_threads: int = 4,
        prefetch: int = 3,
        mean: Sequence[float] = IMAGENET_MEAN,
        std: Sequence[float] = IMAGENET_STD,
        train: bool = False,
    ):
        lib = _load_lib()
        self._lib = lib
        self.batch_size = batch_size
        self.clip_len = clip_len
        self.crop = crop
        self.n_samples = len(paths)

        c_paths = (ctypes.c_char_p * len(paths))(
            *[str(p).encode() for p in paths])
        if labels is None:
            labels = list(range(len(paths)))
        c_labels = (ctypes.c_int64 * len(paths))(*[int(label) for label in labels])
        c_mean = (ctypes.c_float * 3)(*[float(m) for m in mean])
        c_std = (ctypes.c_float * 3)(*[float(s) for s in std])
        err = ctypes.create_string_buffer(512)
        handle = lib.vml_create(
            c_paths, c_labels, len(paths), clip_len, frame_stride,
            short_side, crop, batch_size, num_threads, prefetch,
            c_mean, c_std, 1 if train else 0, err, len(err))
        if not handle:
            raise RuntimeError(f"vml_create failed: {err.value.decode()}")
        self._handle = ctypes.c_void_p(handle)
        self._batch_floats = lib.vml_batch_floats(self._handle)

    def epoch(
        self, seed: int = 0, shuffle: Optional[bool] = None,
        drop_last: bool = False, epoch: Optional[int] = None,
    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Iterate one epoch; yields (clips, labels): clips a float32 CPU
        tensor (count, C, clip_len, crop, crop), labels int64 (count,);
        count < batch_size only on a final partial batch that is kept.
        Each batch owns its memory (a copy of the loader's buffer).

        ``epoch`` pins the augmentation RNG's epoch index (so a resumed run
        replays bit-exactly); by default it advances with each call, so
        repeated epochs draw fresh augmentations."""
        n_batches = self._lib.vml_start_epoch(
            self._handle, seed, 1 if shuffle else 0, 1 if drop_last else 0,
            -1 if epoch is None else int(epoch))
        buf = np.empty(self._batch_floats, dtype=np.float32)
        lbl = np.empty(self.batch_size, dtype=np.int64)
        for _ in range(n_batches):
            count = self._lib.vml_next(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                lbl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if count <= 0:
                break
            clips = buf.reshape(
                self.batch_size, 3, self.clip_len, self.crop, self.crop)
            yield torch.from_numpy(clips[:count].copy()), torch.from_numpy(lbl[:count].copy())
        err = self._lib.vml_last_error(self._handle)
        if err:
            msg = err.decode()
            if msg:
                raise RuntimeError(f"native loader error: {msg}")

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.vml_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
