"""Fused log-mel spectrogram: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/melspec.cu``) replaces the Pallas kernel
``audioflow_tpu/ops/pallas/melspec.py::mel_spectrogram_pallas``. It computes
``log(max(fbᵀ·|DFT_w(frame)|², floor))`` over center=False frames of
``x [..., T]`` without writing the frames or the power spectrum to device
memory. The Pallas kernel's 64-frame x 8-row tiling and its overlapped tile
tensor are TPU artefacts and are not carried over; see the source's note for
the CUDA design.

:func:`mel_spectrogram` takes a tensor on the CPU to the plain version
:func:`mel_spectrogram_reference`, launches the kernel for a CUDA tensor,
and raises for anything the kernel does not take. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..framing import frame, num_frames
from ..mel import floor_log
from ._build import load

LOG_MODES = {None: 0, "none": 0, "ln": 1, "log10": 2, "db": 3}

# shared memory one block may use on Hopper (227 KB of the SM's 256 KB)
_MAX_SMEM = 232_448


@dataclass
class LaunchCount:
    """Kernel launches since the last reset (a plain int: set it to 0 to reset)."""

    launches: int = 0


COUNT = LaunchCount()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("melspec")
    lib.melspec_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.melspec_launch.restype = ctypes.c_int
    lib.melspec_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.melspec_smem_bytes.restype = ctypes.c_longlong
    return lib


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _lib()


def mel_spectrogram_reference(
    x: torch.Tensor,
    cosb: torch.Tensor,
    sinb: torch.Tensor,
    fb: torch.Tensor,
    hop: int,
    log: str | None = "ln",
    floor: float = 1e-10,
) -> torch.Tensor:
    """Plain torch version: ``log_mel(spectrogram(x, center=False), fb)``
    with the given banks; ``[..., T]`` -> ``[..., frames, n_mels]``."""
    frames = frame(x, cosb.shape[0], hop)
    re = torch.matmul(frames, cosb)
    im = torch.matmul(frames, sinb)
    return floor_log(torch.matmul(re * re + im * im, fb), floor, log)


def _check(x, cosb, sinb, fb, hop, log):
    if log not in LOG_MODES:
        raise ValueError(f"unknown log {log!r}; known: {sorted(map(str, LOG_MODES))}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if cosb.ndim != 2 or sinb.shape != cosb.shape:
        raise ValueError(f"cos/sin banks must share a [n_fft, n_bins] shape: {cosb.shape}, {sinb.shape}")
    if fb.ndim != 2 or fb.shape[0] != cosb.shape[1]:
        raise ValueError(f"filterbank {tuple(fb.shape)} does not take {cosb.shape[1]} bins")
    if x.shape[-1] < cosb.shape[0]:
        raise ValueError(f"signal length {x.shape[-1]} shorter than n_fft {cosb.shape[0]}")
    for name, t in (("x", x), ("cos bank", cosb), ("sin bank", sinb), ("filterbank", fb)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, the signal on {x.device}")


def mel_spectrogram(
    x: torch.Tensor,
    cosb: torch.Tensor,
    sinb: torch.Tensor,
    fb: torch.Tensor,
    hop: int,
    log: str | None = "ln",
    floor: float = 1e-10,
) -> torch.Tensor:
    """(log-)mel spectrogram ``[..., frames, n_mels]`` of ``x [..., T]``.

    ``cosb``/``sinb`` ``[n_fft, n_bins]`` are the window-folded DFT banks
    (``ops.stft.dft_banks``), ``fb [n_bins, n_mels]`` the mel filterbank.
    ``log`` is "ln", "log10", "db" or None (floored linear mel).
    """
    _check(x, cosb, sinb, fb, hop, log)
    if x.device.type in ("cpu", "meta"):  # meta tensors carry shapes only
        return mel_spectrogram_reference(x, cosb, sinb, fb, hop, log, floor)
    if x.device.type != "cuda":
        raise ValueError(f"mel_spectrogram runs on cpu or cuda tensors, not {x.device.type}")
    tensors = (x, cosb, sinb, fb)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"the kernel takes float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    n_fft, n_bins = cosb.shape
    n_mels = fb.shape[1]
    lead, t = x.shape[:-1], x.shape[-1]
    batch = x.numel() // t
    n_frames = num_frames(t, n_fft, hop)
    if max(batch, t) >= 2**31:
        raise ValueError(f"batch {batch} and length {t} must each be below 2**31")
    lib = _lib()
    smem = lib.melspec_smem_bytes(n_fft, n_bins)
    if smem > _MAX_SMEM:
        raise ValueError(f"n_fft {n_fft} needs {smem} B of shared memory per block, over {_MAX_SMEM}")
    out = torch.empty((batch, n_frames, n_mels), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.melspec_launch(
            x.data_ptr(), cosb.data_ptr(), sinb.data_ptr(), fb.data_ptr(), out.data_ptr(),
            batch, t, n_fft, hop, n_bins, n_mels, n_frames, LOG_MODES[log], floor,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"melspec kernel launch failed: cudaError {err}")
    COUNT.launches += 1
    return out.reshape(*lead, n_frames, n_mels)
