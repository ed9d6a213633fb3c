"""Build the CUDA sources in ``audioflow_torch/csrc`` at first use and load
them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` builds it in seconds into a shared library under
``build/audioflow_torch/`` at the root of the checkout. The library's file
name carries a digest of the source and flags, so an edited source is never
served by an old build. Nothing is built or imported when this module is
imported.
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

from ...errors import AudioError, ErrorCode

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "audioflow_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in BUILD_LOG
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}  # name -> nvcc's output of this process's build
BUILD_SECONDS: dict[str, float] = {}  # name -> seconds this process spent building


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise AudioError(
            "nvcc not found (PATH, CUDA_HOME, CUDA_PATH); the CUDA toolkit is "
            "needed to build the kernels",
            code=ErrorCode.KERNEL_COMPILATION_FAILED,
        )
    return str(path)


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True, check=False,
            )
            BUILD_SECONDS[name] = time.perf_counter() - t0
            BUILD_LOG[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise AudioError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n{BUILD_LOG[name]}",
                    code=ErrorCode.KERNEL_COMPILATION_FAILED,
                )
            os.replace(tmp, so)  # atomic: another process never loads half a file
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
        return lib
