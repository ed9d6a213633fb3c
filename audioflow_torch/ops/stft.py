"""Power/magnitude spectrogram as two matmuls against windowed DFT banks.

The windowed real-DFT banks are host-side float64 designs copied bit for bit
from ``audioflow_tpu/ops/stft.py::_dft_banks``. Folding the analysis window
into the banks makes the spectrogram ``frames @ cos`` and ``frames @ sin``:
no window multiply and no complex arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cache import BoundedCache, on_device
from ._mm import mm
from .framing import frame
from .windows import get_window

# windowed-DFT bank variants, ~n_fft*(n_fft//2+1)*4 B each (8 MB at 2048)
_BANK_CACHE = BoundedCache(maxsize=64)

# The JAX package's impl variants choose between lane-padding and compile-time
# trade-offs of the TPU's matrix unit. They compute the same function; the
# port accepts every name and runs the one two-matmul form.
IMPLS = ("matmul", "folded", "fourstep", "onedot", "radix2", "fft")


def _dft_banks(n_fft: int, window: str, win_length: int | None):
    """Windowed real-DFT banks: cos/sin matrices [n_fft, n_fft//2+1], f64-designed.

    Folding the analysis window into the banks makes the whole spectrogram
    two matmuls — no separate window multiply, no complex arithmetic.
    """
    key = (n_fft, window, win_length)
    if key not in _BANK_CACHE:
        wl = win_length or n_fft
        w = get_window(window, wl, periodic=True)
        if wl < n_fft:
            pad = n_fft - wl
            w = np.pad(w, (pad // 2, pad - pad // 2))
        n_bins = n_fft // 2 + 1
        k = np.arange(n_fft, dtype=np.float64)[:, None] * np.arange(n_bins)[None, :]
        ang = 2.0 * np.pi * k / n_fft
        _BANK_CACHE[key] = (
            (np.cos(ang) * w[:, None]).astype(np.float32),
            (-np.sin(ang) * w[:, None]).astype(np.float32),
        )
    return _BANK_CACHE[key]


def dft_banks(n_fft: int, window: str, win_length: int | None, device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_dft_banks` as float32 tensors on ``device`` (uploaded once)."""
    cosb, sinb = _dft_banks(n_fft, window, win_length)
    return on_device(cosb, device), on_device(sinb, device)


def pad_center(x: torch.Tensor, n_fft: int, pad_mode: str = "reflect") -> torch.Tensor:
    """Pad ``x [..., T]`` by ``n_fft // 2`` on both sides (center=True framing)."""
    if pad_mode not in ("reflect", "constant"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}; known: constant, reflect")
    p = n_fft // 2
    lead = x.shape[:-1]
    # torch's reflect pad takes [N, C, T]; fold every lead axis into N
    y = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]), (p, p), mode=pad_mode)
    return y.reshape(*lead, y.shape[-1])


def spectrogram(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    win_length: int | None = None,
    center: bool = True,
    pad_mode: str = "reflect",
    power: bool = True,
    impl: str = "matmul",
    dtype=torch.float32,
    precision: str | None = None,
) -> torch.Tensor:
    """Power (or magnitude) spectrogram ``[..., frames, n_fft//2+1]``.

    Every ``impl`` name of the JAX package is accepted and runs the same
    two-matmul form (see :data:`IMPLS`).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown spectrogram impl {impl!r}; known: {', '.join(IMPLS)}")
    if center:
        x = pad_center(x, n_fft, pad_mode)
    frames = frame(x.to(dtype), n_fft, hop)
    cosb, sinb = dft_banks(n_fft, window, win_length, x.device)
    re = mm(frames, cosb.to(dtype), precision)
    im = mm(frames, sinb.to(dtype), precision)
    p = re * re + im * im
    return p if power else torch.sqrt(p)
