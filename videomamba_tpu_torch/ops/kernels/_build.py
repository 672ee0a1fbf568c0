"""Build and bind the Hopper kernels under ``videomamba_tpu_torch/csrc``.

Each ``.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``, all at
once, and the objects are linked into one shared library with a plain C
interface, loaded with :mod:`ctypes`. The library goes to
``build/videomamba_tpu_torch/`` at the repository root, under a file name
that carries a hash of the sources and flags, so a stale build is never
loaded. The build runs at the first launch in a process, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "videomamba_tpu_torch"
SOURCES = ("fused_add_norm.cu", "selective_scan.cu", "mixer_fused.cu",
           "block_fused.cu", "selective_scan_bwd.cu", "mixer_bwd.cu",
           "fused_add_norm_bwd.cu", "block_bwd.cu", "causal_conv.cu",
           "decode_step.cu", "ssd_mixer.cu", "ssd_pmixer.cu", "ssd_core_bwd.cu",
           "ssd_mixer_bwd.cu", "ssd_pmixer_bwd.cu")
HEADERS = ("add_norm.cuh", "add_norm_bwd.cuh", "decode_persist.cuh", "mixer_bwd.cuh",
           "mixer_parts.cuh", "scan_walk.cuh", "scan_walk_bwd.cuh", "scan_walk_split.cuh",
           "scan_walk_split_bwd.cuh", "ssd_core.cuh", "ssd_core_bwd.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> argument types. Every pointer and the stream are
# c_void_p, so ctypes never cuts a 64-bit address to an int.
SIGNATURES = {
    "vmt_fused_add_norm": (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
    "vmt_selective_scan": (
        _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _LL,
        _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "vmt_mixer_fused": (
        _P, _LL, _P, _LL, *(_P,) * 17, *(_I,) * 10, _P,
    ),
    "vmt_block_fused": (
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _I, *(_P,) * 10, *(_I,) * 9, _F, _I, _I, _P,
    ),
    "vmt_selective_scan_bwd": (
        *(_P, _LL) * 6, *(_P,) * 18, *(_I,) * 7, _P,
    ),
    "vmt_mixer_bwd": (
        _P, _LL, _P, _LL, *(_P,) * 23, *(_I,) * 10, _P,
    ),
    "vmt_fused_add_norm_bwd": (
        _P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _P,
    ),
    "vmt_block_bwd": (*(_P,) * 16, _I, *(_P,) * 16, *(_I,) * 9, _F, _I, _I, _P),
    "vmt_causal_conv": (*(_P,) * 5, *(_I,) * 7, _P),
    "vmt_decode_stack": (_P, _P, _P, _F, _I, _P),
    "vmt_decode_stack_m2": (_P, _P, _P, _F, _F, _I, _P),
    "vmt_ssd_mixer": (_P, _LL, *(_P,) * 14, *(_I,) * 8, _F, _I, _I, _P),
    "vmt_ssd_pmixer": (*(_P,) * 6, _I, *(_P,) * 13, *(_I,) * 8, _F, _I, _I, _P),
    "vmt_ssd_scan": (*(_P,) * 8, *(_I,) * 9, _P),
    "vmt_ssd_scan_bwd": (*(_P,) * 16, *(_I,) * 9, _P),
    "vmt_ssd_mixer_bwd": (_P, _LL, _P, _P, _LL, *(_P,) * 29, *(_I,) * 8, _F, _I, _I, _P),
    "vmt_ssd_pmixer_bwd": (*(_P,) * 12, _I, *(_P,) * 29, *(_I,) * 8, _F, _I, _I, _P),
}
# Entry points that return a size instead of a CUDA error code.
SIZE_QUERIES = {
    "vmt_mixer_bwd_scratch_floats": ((_I,) * 7, _LL),
    "vmt_fused_add_norm_bwd_blocks": ((_LL,), _I),
    "vmt_block_bwd_scratch_floats": ((_I,) * 8, _LL),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found: the videomamba_tpu_torch kernels are built from "
        "source with the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)."
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this exact source set has not been built."""
    lib_path = BUILD_DIR / f"libvmt_kernels_{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(src).stem + ".o") for src in SOURCES]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", obj]
                    for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        errs = [proc.communicate()[1] for proc in procs]  # wait for every one
        for cmd, proc, err in zip(compiles, procs, errs):
            _raise_on_failure(cmd, proc.returncode, err)
        lib_tmp = os.path.join(tmp, lib_path.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        _raise_on_failure(link, proc.returncode, proc.stderr)
        os.replace(lib_tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path


def _raise_on_failure(cmd, returncode: int, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stderr}")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built library with every entry point's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, (argtypes, restype) in SIZE_QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


FP32 = (torch.float32,)
FP32_OR_BF16 = (torch.float32, torch.bfloat16)
_DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def check_operands(kernel: str, device: torch.device, operands: dict,
                   contiguous=(), dtypes=None) -> None:
    """Raise unless each operand (name -> (tensor or None, shape)) is a
    tensor of that shape on ``device`` with a dtype its kernel takes
    (``dtypes``: name -> allowed dtypes; fp32 for a name not given), and
    those named in ``contiguous`` are contiguous. A kernel call is not
    recorded by autograd: the training route calls the kernels inside
    ``torch.autograd.Function`` forwards and backwards, where grad mode is
    off. So an operand that autograd would record (a direct call under grad
    mode) raises instead of the kernel silently cutting the graph."""
    dtypes = dtypes or {}
    for name, (t, shape) in operands.items():
        if t is None:
            continue
        allowed = dtypes.get(name, FP32)
        if t.device != device or t.dtype not in allowed:
            names = " or ".join(_DTYPE_NAMES.get(d, str(d)) for d in allowed)
            raise ValueError(
                f"{kernel} kernel: {name} must be {names} on {device} "
                f"(got {t.dtype} on {t.device})"
            )
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{kernel} kernel: {name} has shape {tuple(t.shape)}, "
                f"expected {tuple(shape)}"
            )
        if name in contiguous and not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} must be contiguous")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                f"{kernel} kernel: a direct call has no backward; call it "
                "through its autograd Function, or under torch.no_grad() "
                "or torch.inference_mode()"
            )


def one_dtype(t: torch.Tensor) -> tuple:
    """Allowed dtypes for operands that must share ``t``'s: its own when it
    is fp32 or bf16 (else both, so the error names what is taken)."""
    return (t.dtype,) if t.dtype in FP32_OR_BF16 else FP32_OR_BF16


def row_stride(t: torch.Tensor, name: str) -> int:
    """Row stride of a (batch, L, F) operand laid out as rows of unit stride
    with batch stride L * row stride. Views that split the last axis (x and
    z of in_proj's output, B and C of x_proj's) qualify; others raise."""
    b, l, f = t.shape
    ld = t.stride(1) if l > 1 else (t.stride(0) if b > 1 else f)
    if (f > 1 and t.stride(2) != 1) or (b > 1 and t.stride(0) != l * ld) or ld < f:
        raise ValueError(
            f"{name}: needs rows of unit element stride and batch stride "
            f"L * row stride, got strides {t.stride()} for shape {tuple(t.shape)}"
        )
    return ld


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def is_bf16(t) -> int:
    """The dtype flag of a C entry: 1 for bf16, 0 for fp32 (or no tensor)."""
    return int(t is not None and t.dtype == torch.bfloat16)


def ptr(t) -> int | None:
    """Device address of a tensor, or None (a NULL pointer) for None."""
    return None if t is None else t.data_ptr()
