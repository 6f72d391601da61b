"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all at
once in parallel, and the objects are linked into one shared library with
a plain C interface that :mod:`ctypes` loads. The library lands in
``build/kernels/<digest>/`` at the repository root (listed in
``.gitignore``; ``REPRO_KERNEL_BUILD_ROOT`` names another directory),
keyed by a digest of the sources and flags, so a process builds only
when a source changed; the first call of any kernel wrapper
triggers the build. Threads of one process build once under a lock, and
processes (the shard workers of the process backend) under an ``flock``
on the digest directory: the first builds, the others wait and load its
library. A failed build raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["library", "function", "check", "build_seconds", "build_log",
           "require", "ptr", "stream_of", "field_bits", "launch_fields",
           "require_cuda", "check_cols", "empty_outputs", "device_table",
           "launch_slices", "count_launch", "builds", "MAX_COLS",
           "MAX_SPECS", "BUILD_ROOT", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(os.environ.get("REPRO_KERNEL_BUILD_ROOT") or
                  Path(__file__).resolve().parents[3] / "build" / "kernels")
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


_lib: Optional[ctypes.CDLL] = None
# host threads that launch their first kernel together (a worker pool, the
# stream flusher, the batcher) must not each run nvcc: the first one
# builds and loads under this lock, the others wait for it
_lib_lock = threading.Lock()
builds = 0        # libraries this process built (0: it loaded a built one)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its digest is new; built
    and loaded once per process, whichever thread asks first, and built
    once per digest, whichever process asks first."""
    global _lib, builds
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                files = (sorted(CSRC.glob("*.cu"))
                         + sorted(CSRC.glob("*.cuh")))
                out = BUILD_ROOT / _digest(files) / _LIB_NAME
                if not out.exists():
                    out.parent.mkdir(parents=True, exist_ok=True)
                    with open(out.parent / "lock", "w") as lock:
                        fcntl.flock(lock, fcntl.LOCK_EX)
                        if not out.exists():    # another process built it
                            _build(out)
                            builds += 1
                lib = ctypes.CDLL(str(out))
                lib.rt_error_string.argtypes = [ctypes.c_int]
                lib.rt_error_string.restype = ctypes.c_char_p
                _lib = lib
    return _lib


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
MAX_COLS = 64      # rt::kMaxCols: value columns one launch reads
MAX_SPECS = 16     # rt::kMaxSpecs: window specs one fused launch takes


@functools.lru_cache(maxsize=256)
def launch_fields(fields: Optional[Tuple[str, ...]],
                  order: Tuple[str, ...]) -> Tuple[Tuple[str, ...], int]:
    """The fields a launch materialises (``order``'s, in its order; all
    of them for None) and their bits, once per static request."""
    fields = tuple(f for f in order if f in (fields or order))
    return fields, field_bits(fields)


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
    bad = [c for c in cols if not 0 <= c < V]
    if bad:
        raise ValueError(f"column indices {bad} outside [0, {V})")
    return cols


@functools.lru_cache(maxsize=256)
def launch_slices(n_specs: int, n_cols: int
                  ) -> Tuple[Tuple[int, int, int, int], ...]:
    """The launches one wrapper call makes: one ``(s0, s1, c0, c1)`` per
    slice of at most MAX_SPECS specs and MAX_COLS output columns, specs
    outer, ⌈S/MAX_SPECS⌉ × ⌈V/MAX_COLS⌉ of them (one column slice, empty,
    where ``n_cols`` is 0). Specs and columns are independent in every
    feature kernel, so each slice is exact on its own; a launch writes its
    slice into the call's outputs through their full strides."""
    def cuts(n, w):
        return [(a, min(a + w, n)) for a in range(0, n, w)] or [(0, 0)]
    return tuple((s0, s1, c0, c1) for s0, s1 in cuts(n_specs, MAX_SPECS)
                 for c0, c1 in cuts(n_cols, MAX_COLS))


@functools.lru_cache(maxsize=256)
def device_table(cols: Tuple[int, ...], device: torch.device,
                 specs: Tuple[Tuple[int, int, float], ...] = ()
                 ) -> torch.Tensor:
    """A launch's static int32 table on ``device``, laid out as
    ``csrc/warp_window.cuh`` reads it: the column indices padded to
    MAX_COLS words, then MAX_SPECS words each of the specs' ROWS lengths
    (-1 for RANGE), field bits and RANGE spans (float32 bits), from one
    ``(rows, bits, span)`` triple per spec. Copied to the device once per
    table; the cache keeps it. Two threads that miss the cache at once
    both build the table and the cache keeps one of the two equal tensors,
    so filling it concurrently is safe (as for ``launch_fields``,
    ``launch_slices`` and ``fused_window.spec_table``)."""
    def pad(xs, n):
        return list(xs) + [0] * (n - len(xs))

    rows, bits, spans = zip(*specs) if specs else ((), (), ())
    span_bits = torch.tensor(spans, dtype=torch.float32).view(torch.int32)
    words = (pad(cols, MAX_COLS) + pad(rows, MAX_SPECS)
             + pad(bits, MAX_SPECS) + pad(span_bits.tolist(), MAX_SPECS))
    return torch.tensor(words, dtype=torch.int32).to(device)


def empty_outputs(shapes: Dict[str, Tuple[int, ...]],
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """Uninitialised f32 outputs of one launch, carved as contiguous views
    out of one allocation (one allocator call instead of one per field)."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    return {f: t.view(s) for (f, s), t in
            zip(shapes.items(), flat.split(sizes))}


def ptr(t: Optional[torch.Tensor], offset: int = 0) -> Optional[int]:
    """The address of element ``offset`` of ``t`` (None for no tensor)."""
    return None if t is None else t.data_ptr() + offset * t.element_size()


_count_lock = threading.Lock()


def count_launch(module, route: Optional[str] = None) -> None:
    """Add one to a wrapper module's ``launches`` counter atomically:
    ``launches += 1`` is a read and a write, which concurrent launching
    threads would interleave and lose counts. With ``route``, also to the
    module's ``route_launches[route]``."""
    with _count_lock:
        module.launches += 1
        if route is not None:
            module.route_launches[route] += 1


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

