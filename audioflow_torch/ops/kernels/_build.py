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

The wrappers share the rest of the launch path from here: :func:`launch`,
:func:`check_mirror`, :class:`LaunchCount`, the row layout the kernels read
(:func:`_rows`) and the shared memory a block may use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import torch

from ...errors import AudioError, ErrorCode
from ...obs import trace

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "audioflow_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in BUILD_LOG
)

# shared memory one block may use on Hopper (227 KB of the SM's 256 KB)
_MAX_SMEM = 232_448

_LIBS: dict[str, ctypes.CDLL] = {}
_MIRRORED: set = set()  # (kernel, shape) whose mirrors the library confirmed
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


@dataclass
class LaunchCount:
    """Kernel launches since the last reset (a plain int: set it to 0 to reset)."""

    launches: int = 0


def launch(kernel: str, count: LaunchCount, entry, device: torch.device, *args) -> None:
    """``entry(*args, stream)``, a library entry that launches ``kernel`` on
    ``stream``, the raw current stream of the CUDA ``device``; counted in
    ``count``. A nonzero ``cudaError`` raises."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():  # torch.cuda.device's switch costs more host time than the rest
        err = entry(*args, stream)
    else:  # the runtime launches on the calling thread's device
        with torch.cuda.device(device):
            err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    count.launches += 1


def check_mirror(kernel: str, shape: tuple, mirror, library) -> None:
    """Raise where a wrapper's ``mirror`` of ``kernel``'s constants at
    ``shape`` differs from the library's own, ``library()``; a kernel and
    shape that agreed are not asked again."""
    if (kernel, shape) in _MIRRORED:
        return
    got = library()
    if got != mirror:
        raise RuntimeError(f"the wrapper's mirrors of {kernel}.cu at {shape} are out of date: {mirror} vs {got}")
    _MIRRORED.add((kernel, shape))


def _row_stride(t: torch.Tensor) -> int | None:
    """The one stride between consecutive rows of ``t [..., n]`` taken as
    ``[rows, n]``, or None where its layout has none (or its samples are not
    adjacent)."""
    shape, strides = t.shape, t.stride()
    if shape[-1] > 1 and strides[-1] != 1:
        return None
    if t.ndim == 1:
        return shape[-1]
    row = strides[-2]
    for i in range(t.ndim - 3, -1, -1):
        if shape[i] > 1 and strides[i] != strides[i + 1] * shape[i + 1]:
            return None
    return row


def _rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` and its row stride, copied first where its layout has none."""
    stride = _row_stride(t)
    if stride is None:
        t = t.contiguous()
        stride = t.shape[-1]
    return t, stride
