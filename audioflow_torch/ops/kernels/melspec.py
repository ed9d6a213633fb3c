"""Fused log-mel spectrogram: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/melspec.cu``) replaces the Pallas kernel
``audioflow_tpu/ops/pallas/melspec.py::mel_spectrogram_pallas``. It computes
``log(max(fbᵀ·|DFT_w(frame)|², floor))`` over center=False frames of
``x [..., T]`` without writing the frames or the power spectrum to device
memory. The Pallas kernel's 64-frame x 8-row tiling and its overlapped tile
tensor are TPU artefacts and are not carried over; see the source's note for
the CUDA design. The kernel has two paths behind one launch, chosen by shape
(:func:`kernel_path`): a shared-memory FFT (``csrc/fft.cuh``) for a
power-of-two n_fft from 16 to 2048, dense DFT products against the banks for
any other. Both project the power spectrum onto the filterbank's nonzero
bands only (:func:`mel_bands`).

:func:`mel_spectrogram` takes a tensor on the CPU to the plain version
:func:`mel_spectrogram_reference`, launches the kernel for a CUDA tensor,
and raises for anything the kernel does not take. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...utils.cache import BoundedCache, on_device
from ..framing import frame, num_frames
from ..mel import floor_log
from . import fft
from ._build import load

LOG_MODES = {None: 0, "none": 0, "ln": 1, "log10": 2, "db": 3}

# shared memory one block may use on Hopper (227 KB of the SM's 256 KB)
_MAX_SMEM = 232_448
# mirrors of melspec.cu's kFrames and kFftFrames, so that kernel_path()
# needs no build; the wrapper checks the mirrors against the library
_FRAMES = 16
_FFT_FRAMES = 8

# band layouts on the device, keyed by the filterbank tensor they were read from
_BANDS = BoundedCache(maxsize=16)


@dataclass
class LaunchCount:
    """Kernel launches since the last reset (a plain int: set it to 0 to reset)."""

    launches: int = 0


COUNT = LaunchCount()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("melspec")
    lib.melspec_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.melspec_launch.restype = ctypes.c_int
    lib.melspec_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.melspec_smem_bytes.restype = ctypes.c_longlong
    lib.melspec_path.argtypes = [ctypes.c_int]
    lib.melspec_path.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _lib()


def fft_frames(n_fft: int) -> int:
    """Frames per block of the FFT path, or 0 where n_fft takes the dense
    path (not a power of two from 16 to 2048)."""
    return _FFT_FRAMES if fft.is_fft_size(n_fft) else 0


def kernel_path(n_fft: int) -> str:
    """The path the kernel takes, chosen by shape: ``"fft"`` for a
    power-of-two n_fft from 16 to 2048 (any hop), ``"dense"`` for any other."""
    return "fft" if fft_frames(n_fft) else "dense"


def smem_bytes(n_fft: int) -> int:
    """Dynamic shared memory of one block of the path the kernel takes."""
    frames = fft_frames(n_fft)
    m = n_fft // 2
    if frames:
        return 8 * m + 8 * frames * (m + (m >> 5))
    return 4 * _FRAMES * (((n_fft + 3) & ~3) + m + 1)


def mel_bands(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The banded layout of a filterbank ``[n_bins, n_mels]``: int32
    ``[3, n_mels]`` of each column's first nonzero bin, its count of bins up
    to its last nonzero one (0 for an empty column) and the offset of its
    weights, and the float32 weights packed column after column. Only exact
    zeros outside each column's first-to-last range are left out."""
    fb = np.asarray(fb, np.float32)
    n_mels = fb.shape[1]
    layout = np.zeros((3, n_mels), np.int32)
    packed = []
    offset = 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m] != 0)
        if nz.size:
            lo, count = int(nz[0]), int(nz[-1] - nz[0] + 1)
            layout[:, m] = lo, count, offset
            packed.append(fb[lo : lo + count, m])
            offset += count
        else:
            layout[2, m] = offset
    wts = np.concatenate(packed) if packed else np.zeros(1, np.float32)
    return layout, wts.astype(np.float32)


def _device_bands(fb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`mel_bands` of a filterbank tensor, on its device: read back and
    laid out once per tensor and version (an in-place edit makes a new
    layout). The entry holds the tensor, so its address is not reused
    while the entry lives."""
    key = (fb.data_ptr(), str(fb.device), tuple(fb.shape), fb.stride(), fb._version)
    hit = _BANDS.get(key)
    if hit is None:
        layout, wts = mel_bands(fb.detach().cpu().numpy())
        hit = (fb, torch.from_numpy(layout).to(fb.device), torch.from_numpy(wts).to(fb.device))
        _BANDS[key] = hit
    return hit[1], hit[2]


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


def _check(x, cosb, sinb, window, fb, hop, log):
    if log not in LOG_MODES:
        raise ValueError(f"unknown log {log!r}; known: {sorted(map(str, LOG_MODES))}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if cosb.ndim != 2 or sinb.shape != cosb.shape:
        raise ValueError(f"cos/sin banks must share a [n_fft, n_bins] shape: {cosb.shape}, {sinb.shape}")
    if tuple(window.shape) != (cosb.shape[0],):
        raise ValueError(f"window {tuple(window.shape)} does not take n_fft {cosb.shape[0]}")
    if fb.ndim != 2 or fb.shape[0] != cosb.shape[1]:
        raise ValueError(f"filterbank {tuple(fb.shape)} does not take {cosb.shape[1]} bins")
    if x.shape[-1] < cosb.shape[0]:
        raise ValueError(f"signal length {x.shape[-1]} shorter than n_fft {cosb.shape[0]}")
    for name, t in (("x", x), ("cos bank", cosb), ("sin bank", sinb), ("window", window), ("filterbank", fb)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, the signal on {x.device}")


def mel_spectrogram(
    x: torch.Tensor,
    cosb: torch.Tensor,
    sinb: torch.Tensor,
    window: torch.Tensor,
    fb: torch.Tensor,
    hop: int,
    log: str | None = "ln",
    floor: float = 1e-10,
) -> torch.Tensor:
    """(log-)mel spectrogram ``[..., frames, n_mels]`` of ``x [..., T]``.

    ``cosb``/``sinb`` ``[n_fft, n_bins]`` are the window-folded DFT banks
    (``ops.stft.dft_banks``) of the dense path and the plain version,
    ``window [n_fft]`` the same analysis window unfolded
    (``ops.stft.padded_window`` as float32) for the FFT path, ``fb [n_bins,
    n_mels]`` the mel filterbank. ``log`` is "ln", "log10", "db" or None
    (floored linear mel).
    """
    _check(x, cosb, sinb, window, fb, hop, log)
    if x.device.type in ("cpu", "meta"):  # meta tensors carry shapes only
        return mel_spectrogram_reference(x, cosb, sinb, fb, hop, log, floor)
    if x.device.type != "cuda":
        raise ValueError(f"mel_spectrogram runs on cpu or cuda tensors, not {x.device.type}")
    tensors = (x, cosb, sinb, window, fb)
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
    frames, smem = lib.melspec_path(n_fft), lib.melspec_smem_bytes(n_fft, n_bins)
    if (frames, smem) != (fft_frames(n_fft), smem_bytes(n_fft)):
        raise RuntimeError(
            f"fft_frames()/smem_bytes() are out of date with melspec.cu: "
            f"{(fft_frames(n_fft), smem_bytes(n_fft))} vs {(frames, smem)}"
        )
    if smem > _MAX_SMEM:
        raise ValueError(f"n_fft {n_fft} needs {smem} B of shared memory per block, over {_MAX_SMEM}")
    tw = on_device(fft.twiddles(n_fft), x.device) if frames else None
    bands, wts = _device_bands(fb)
    out = torch.empty((batch, n_frames, n_mels), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.melspec_launch(
            x.data_ptr(), window.data_ptr(), None if tw is None else tw.data_ptr(), cosb.data_ptr(),
            sinb.data_ptr(), bands.data_ptr(), wts.data_ptr(), out.data_ptr(),
            batch, t, n_fft, hop, n_bins, n_mels, n_frames, LOG_MODES[log], floor,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"melspec kernel launch failed: cudaError {err}")
    COUNT.launches += 1
    return out.reshape(*lead, n_frames, n_mels)
