"""ctypes binding to the C++ batch decoder (``native/wavcodec.cpp`` with its
FLAC and AIFF ``.inc`` files).

The same C interface and Python contract as ``audioflow_tpu/io/native.py``,
with the port's own build: ``g++`` compiles the sources at first use into
``build/audioflow_torch/`` at the root of the checkout, under a file name
that carries a digest of the sources and the flags (as
``ops/kernels/_build.py`` does for ``nvcc``), so an edited source is never
served by an old build. The sources are shared with the JAX package and are
only read here. Without a toolchain the decoder is unavailable and callers
fall back (check :func:`available`). The numpy codec in
:mod:`audioflow_torch.io.wav` is the behavioural oracle: both give
bit-identical output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "audioflow_torch"
SOURCES = ("wavcodec.cpp", "flaccodec.inc", "aiffcodec.inc")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib = None
_load_error: str | None = None
_LOCK = threading.Lock()


class Stats:
    """What this process's decoder did: ``build_seconds`` (None when the
    library was already on disk) and ``calls`` of :func:`decode_batch_mono`."""

    build_seconds: float | None = None
    calls: int = 0


STATS = Stats()


def library_path() -> Path:
    parts = [(NATIVE_DIR / s).read_bytes() for s in SOURCES]
    digest = hashlib.sha256(b"".join(parts) + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwavcodec-{digest}.so"


def _build(so: Path) -> None:
    """Compile the library into ``so``; raises OSError or SubprocessError."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise OSError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / SOURCES[0])],
        check=True, capture_output=True, timeout=300,
    )
    os.replace(tmp, so)  # atomic: another process never loads half a file
    STATS.build_seconds = time.perf_counter() - t0


def _load():
    global _lib, _load_error
    with _LOCK:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError) as e:
            _load_error = f"native decoder build or load failed: {e}"
            return None
        lib.afw_probe.restype = ctypes.c_int
        lib.afw_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.afw_decode_batch_mono.restype = ctypes.c_int
        lib.afw_decode_batch_mono.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it now if needed) and loaded."""
    return _load() is not None


def load_error() -> str | None:
    """Why :func:`available` is false, or None."""
    _load()
    return _load_error


def decode_batch_mono(
    buffers: list[bytes], stride: int, n_threads: int = 0, out: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode WAV/FLAC/AIFF byte buffers to a zero-padded mono f32 batch.

    Returns (out [n, stride] f32, n_frames [n] i64 (-1 = failed lane),
    rates [n] i32). Failed lanes are zeroed, never raising — per-lane fault
    isolation.

    ``out``, if given, is the destination buffer (``[n, stride]`` f32,
    C-contiguous, pinned or not) and is returned; the C++ side zeroes every
    lane before writing, so no host-side clear is needed. Reusing a warm
    buffer across batches avoids a page fault per written page of a fresh
    allocation.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_load_error}")
    n = len(buffers)
    if out is None:
        out = np.empty((n, stride), dtype=np.float32)  # C++ memsets each lane
    elif (
        out.shape != (n, stride)
        or out.dtype != np.float32
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(
            f"out must be C-contiguous f32 [{n}, {stride}], got "
            f"{out.dtype} {out.shape}"
        )
    frames = np.zeros(n, dtype=np.int64)
    rates = np.zeros(n, dtype=np.int32)
    buf_ptrs = (ctypes.c_char_p * n)(*buffers)
    lens = (ctypes.c_int64 * n)(*[len(b) for b in buffers])
    lib.afw_decode_batch_mono(
        buf_ptrs,
        lens,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stride,
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    STATS.calls += 1
    return out, frames, rates
