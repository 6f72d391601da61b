"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all at
once in parallel, and the objects are linked into one shared library with
a plain C interface that :mod:`ctypes` loads. The library lands in
``build/kernels/<digest>/`` at the repository root (listed in
``.gitignore``), keyed by a digest of the sources and flags, so a process
builds only when a source changed; the first call of any kernel wrapper
triggers the build. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["library", "function", "check", "build_seconds", "build_log",
           "require", "ptr", "stream_of", "int_array", "float_array",
           "field_bits", "require_cuda", "check_cols", "MAX_COLS", "MAX_SPECS",
           "BUILD_ROOT", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
_LIB_NAME = "librepro_torch_kernels.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin)")


def _digest(files: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        (out.parent / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib_tmp = Path(tmp) / _LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *(str(o) for _, o, _ in procs),
             "-o", str(lib_tmp)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(lib_tmp, out)       # atomic: no half-written library


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its digest is new."""
    files = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out = BUILD_ROOT / _digest(files) / _LIB_NAME
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def build_seconds() -> float:
    """Build (if needed) and load the library; returns the seconds taken."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


def build_log() -> str:
    """The compiler output of the loaded library's build (ptxas register
    and spill lines), or '' when it was built by an earlier process."""
    files = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    p = BUILD_ROOT / _digest(files) / "build.log"
    return p.read_text() if p.exists() else ""


@functools.lru_cache(maxsize=None)
def function(name: str, argtypes: tuple):
    """A launch function of the library with its C signature declared;
    every launch function returns a CUDA error code."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    """Raise if a launch function reported an error."""
    if code != 0:
        msg = library().rt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------
# Launch helpers shared by the kernel wrappers
# ---------------------------------------------------------------------------

# field bits, as in csrc/common.cuh
_FIELD_BITS = {"sum": 1, "sumsq": 2, "count": 4, "min": 8, "max": 16,
               "first": 32, "last": 64}
MAX_COLS = 64      # rt::kMaxCols
MAX_SPECS = 16     # rt::kMaxSpecs


def field_bits(fields: Sequence[str]) -> int:
    bits = 0
    for f in fields:
        if f not in _FIELD_BITS:
            raise ValueError(f"unknown field {f!r}")
        bits |= _FIELD_BITS[f]
    return bits


def require(t: Optional[torch.Tensor], name: str, dtype: torch.dtype,
            shape: Tuple[int, ...], device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel takes through a raw pointer."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(t: torch.Tensor, what: str) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel and takes CUDA "
                         f"tensors; got {getattr(t, 'device', type(t))}")
    return t.device


def check_cols(cols: Optional[Sequence[int]], V: int) -> Tuple[int, ...]:
    cols = tuple(range(V)) if cols is None else tuple(int(c) for c in cols)
    if len(cols) > MAX_COLS:
        raise ValueError(f"a launch reads at most {MAX_COLS} columns, got "
                         f"{len(cols)}")
    bad = [c for c in cols if not 0 <= c < V]
    if bad:
        raise ValueError(f"column indices {bad} outside [0, {V})")
    return cols


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def int_array(xs: Sequence[int]):
    return (ctypes.c_int * max(len(xs), 1))(*xs)


def float_array(xs: Sequence[float]):
    return (ctypes.c_float * max(len(xs), 1))(*xs)
