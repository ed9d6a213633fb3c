"""STFT, ISTFT and the power/magnitude spectrogram: ``torch.fft`` for
``impl="fft"``, matmuls against host-designed DFT banks for every other name.

The windowed real-DFT banks (``_dft_banks``) and the inverse banks
(``_idft_banks``) are float64 designs copied bit for bit from
``audioflow_tpu/ops/stft.py``. Folding the analysis window into the banks
makes the spectrogram ``frames @ cos`` and ``frames @ sin``: no window
multiply. The inverse is ``Re @ ci + Im @ si``, then the synthesis window,
overlap-add and the window-square (WOLA) normalisation. ``impl="fft"`` is
``torch.fft.rfft`` of the windowed frames and ``torch.fft.irfft``, as the
JAX package's ``jnp.fft`` form: cuFFT on the card, torch's own FFT on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.cache import BoundedCache, on_device
from ._mm import mm
from .framing import frame, overlap_add
from .windows import get_window

# windowed-DFT bank variants, ~n_fft*(n_fft//2+1)*4 B each (8 MB at 2048)
_BANK_CACHE = BoundedCache(maxsize=64)

# "fft" is an FFT (torch.fft: cuFFT on the card), as in the JAX package.
# The other names are the JAX package's lane-padding and compile-time
# trade-offs of the TPU's matrix unit; they compute the same function, and
# the port runs every one of them as the one two-matmul form against the banks.
IMPLS = ("matmul", "folded", "fourstep", "onedot", "radix2", "fft")

# the JAX default's name for the DFT products; the port computes them in fp32
DFT_PRECISION_DEFAULT = "high"


def padded_window(n_fft: int, window: str, win_length: int | None = None) -> np.ndarray:
    """The periodic float64 window of ``win_length`` (default n_fft),
    centre-padded with zeros to n_fft. Cached: callers must not write to it."""
    key = ("window", n_fft, window, win_length)
    if key not in _BANK_CACHE:
        wl = win_length or n_fft
        if wl > n_fft:
            raise ValueError("win_length must be <= n_fft")
        w = get_window(window, wl, periodic=True)
        if wl < n_fft:
            pad = n_fft - wl
            w = np.pad(w, (pad // 2, pad - pad // 2))
        _BANK_CACHE[key] = w
    return _BANK_CACHE[key]


def _dft_banks(n_fft: int, window: str, win_length: int | None):
    """Windowed real-DFT banks: cos/sin matrices [n_fft, n_fft//2+1], f64-designed.

    Folding the analysis window into the banks makes the whole spectrogram
    two matmuls — no separate window multiply, no complex arithmetic.
    """
    key = (n_fft, window, win_length)
    if key not in _BANK_CACHE:
        w = padded_window(n_fft, window, win_length)
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

    ``impl="fft"`` goes through :func:`stft` (``torch.fft.rfft``), then
    takes the power or the magnitude, as the JAX package does; every other
    name runs the two-matmul form (see :data:`IMPLS`).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown spectrogram impl {impl!r}; known: {', '.join(IMPLS)}")
    if impl == "fft":
        spec = stft(x, n_fft, hop, win_length, window, center, pad_mode, dtype)
        return power_fn(spec) if power else magnitude(spec)
    if center:
        x = pad_center(x, n_fft, pad_mode)
    frames = frame(x.to(dtype), n_fft, hop)
    cosb, sinb = dft_banks(n_fft, window, win_length, x.device)
    re = mm(frames, cosb.to(dtype), precision)
    im = mm(frames, sinb.to(dtype), precision)
    p = re * re + im * im
    return p if power else torch.sqrt(p)


def stft(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    dtype=torch.float32,
    impl: str = "fft",
    precision: str | None = None,
) -> torch.Tensor:
    """Short-time Fourier transform of ``x [..., T]``: a complex64
    spectrogram ``[..., n_frames, n_fft // 2 + 1]`` (frame axis first).

    ``impl="fft"`` is ``torch.fft.rfft`` of the frames times the periodic
    window; every other name runs the two-matmul form (see :data:`IMPLS`).
    ``precision`` is accepted for parity (fp32 always).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown stft impl {impl!r}; known: {', '.join(IMPLS)}")
    if center:
        x = pad_center(x, n_fft, pad_mode)
    frames = frame(x.to(dtype), n_fft, hop)
    if impl == "fft":
        w = on_device(padded_window(n_fft, window, win_length), x.device).to(dtype)
        return torch.fft.rfft(frames * w, n=n_fft)
    cosb, sinb = dft_banks(n_fft, window, win_length, x.device)
    return torch.complex(mm(frames, cosb.to(dtype), precision), mm(frames, sinb.to(dtype), precision))


def magnitude(spec: torch.Tensor) -> torch.Tensor:
    return spec.abs()


def power(spec: torch.Tensor) -> torch.Tensor:
    """``|spec|^2``; a real ``spec`` is squared, as ``jnp.imag`` of a real
    array is zero (the JAX CLI's ``align`` and ``segments`` take the power
    of a power spectrogram)."""
    if not spec.is_complex():
        return spec**2
    return spec.real**2 + spec.imag**2


power_fn = power  # spectrogram's `power` argument shadows the name


def _idft_banks(n_fft: int):
    """Inverse real-DFT banks: irfft(X) == Re(X) @ ci + Im(X) @ si."""
    key = ("idft", n_fft)
    if key not in _BANK_CACHE:
        n_bins = n_fft // 2 + 1
        k = np.arange(n_bins, dtype=np.float64)[:, None]
        n = np.arange(n_fft, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * k * n / n_fft
        weights = np.full((n_bins, 1), 2.0)
        weights[0] = 1.0
        if n_fft % 2 == 0:
            weights[-1] = 1.0
        ci = (weights * np.cos(ang) / n_fft).astype(np.float32)
        si = (-weights * np.sin(ang) / n_fft).astype(np.float32)
        _BANK_CACHE[key] = (ci, si)
    return _BANK_CACHE[key]


def synthesis_banks(n_fft: int, window: str) -> tuple[np.ndarray, np.ndarray]:
    """:func:`_idft_banks` with the synthesis window folded into the columns,
    float32, as the JAX package's fused kernels design them
    (``pallas/timestretch.py:428-431``, ``pallas/griffinlim.py:297-298``).
    Cached: callers must not write to them."""
    key = ("synthesis", n_fft, window)
    if key not in _BANK_CACHE:
        ci, si = _idft_banks(n_fft)
        w = padded_window(n_fft, window)
        _BANK_CACHE[key] = (ci * w[None, :]).astype(np.float32), (si * w[None, :]).astype(np.float32)
    return _BANK_CACHE[key]


class Banks(NamedTuple):
    """The fused kernels' banks as float32 tensors on one device: analysis
    ``[n_fft, n_bins]`` (window folded in, as :func:`dft_banks`) and
    synthesis ``[n_bins, n_fft]`` (:func:`synthesis_banks`)."""

    cos: torch.Tensor
    sin: torch.Tensor
    icos: torch.Tensor
    isin: torch.Tensor


def kernel_banks(n_fft: int, window: str, device) -> Banks:
    """:class:`Banks` on ``device`` (uploaded once)."""
    ciw, siw = synthesis_banks(n_fft, window)
    cosb, sinb = dft_banks(n_fft, window, None, device)
    return Banks(cosb, sinb, on_device(ciw, device), on_device(siw, device))


def frames_from_spec(
    spec: torch.Tensor, n_fft: int, impl: str = "fft", dtype=torch.float32,
    precision: str | None = None,
) -> torch.Tensor:
    """Inverse real DFT of spectral frames ``[..., F, n_bins]`` ->
    ``[..., F, n_fft]``: ``impl="fft"`` is ``torch.fft.irfft``, ``"matmul"``
    the two-matmul form against the inverse banks."""
    if impl not in ("fft", "matmul"):
        raise ValueError(f"unknown istft impl {impl!r}; known: fft, matmul")
    if impl == "fft":
        return torch.fft.irfft(spec, n=n_fft).to(dtype)
    ci, si = (on_device(b, spec.device).to(dtype) for b in _idft_banks(n_fft))
    return mm(spec.real.to(dtype), ci, precision) + mm(spec.imag.to(dtype), si, precision)


def istft(
    spec: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    length: int | None = None,
    dtype=torch.float32,
    impl: str = "fft",
    precision: str | None = None,
) -> torch.Tensor:
    """Inverse STFT with synthesis-window (WOLA) normalisation.

    ``length`` trims/defines the output sample count; defaults to
    ``n_frames * hop`` for center=True.
    """
    w = on_device(padded_window(n_fft, window, win_length), spec.device).to(dtype)
    n = spec.shape[-2]
    frames = frames_from_spec(spec, n_fft, impl, dtype, precision)
    y = overlap_add(frames * w, hop)
    # the window-square normaliser is the same for every row: one [n, n_fft] overlap-add
    wsq = overlap_add((w * w).expand(n, n_fft), hop)
    y = y / torch.clamp_min(wsq, 1e-11)
    if not center:
        return y if length is None else y[..., :length]
    if length is None:
        length = n * hop
    return y[..., n_fft // 2 : n_fft // 2 + length]
