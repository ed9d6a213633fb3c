"""Build the CUDA sources in ``audioflow_torch/csrc`` at first use and load
them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` builds it in seconds into a shared library under
``build/audioflow_torch/`` at the root of the checkout. The library's file
name carries a digest of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is never served by an old build. Nothing is built or imported when this module is
imported. Each source's nvcc run and library load is timed once per process
in ``obs.trace``'s one-time table (``kernels.build.<name>``,
``kernels.load.<name>``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ...errors import AudioError, ErrorCode
from ...obs import trace

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


def _library(name: str) -> Path:
    """The library's path, named by a digest of the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc_run(nvcc: str, name: str, tmp: Path) -> None:
    """One source's nvcc run into ``tmp``, its output kept in ``BUILD_LOG``;
    its seconds are recorded only where it succeeds, so a retry after a
    failed build is timed."""
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with trace.first(f"kernels.build.{name}"):
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        BUILD_LOG[name] = proc.stdout
        if proc.returncode != 0:
            raise AudioError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{proc.stdout}",
                             code=ErrorCode.KERNEL_COMPILATION_FAILED)


def _compile(names) -> None:
    """Build the libraries of ``names`` that are not on disk yet, one nvcc per
    source, all started together (a thread waits on each, so each is timed
    on its own); the caller holds ``_LOCK``."""
    todo = {name: _library(name) for name in dict.fromkeys(names)}
    todo = {name: so for name, so in todo.items() if not so.exists()}
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmps = {name: so.with_name(f"{so.name}.{os.getpid()}.tmp") for name, so in todo.items()}
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        runs = {name: pool.submit(_nvcc_run, nvcc, name, tmp) for name, tmp in tmps.items()}
    failed = []
    for name, run in runs.items():
        try:
            run.result()
        except AudioError as e:
            failed.append(e.message)
        else:
            os.replace(tmps[name], todo[name])  # atomic: another process never loads half a file
    if failed:
        raise AudioError("\n".join(failed), code=ErrorCode.KERNEL_COMPILATION_FAILED)


def build(*names: str) -> None:
    """Build the sources ``csrc/<name>.cu`` now, in parallel, instead of at
    their first launch."""
    with _LOCK:
        _compile(names)


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _compile([name])
            with trace.first(f"kernels.load.{name}"):
                lib = _LIBS[name] = ctypes.CDLL(str(_library(name)))
        return lib
