"""FIR filtering: windowed-sinc design and causal convolution.

Mirrors ``audioflow_tpu/ops/fir.py``. The design is host-side float64
windowed-sinc (scipy.signal.firwin conventions), copied bit for bit. The
application is ``torch.nn.functional.conv1d`` with the kernel flipped (cuDNN
on the card, fp32 with TF32 off: ``ops/_mm.py``) for short and medium
kernels, or FFT fast convolution (``torch.fft``, cuFFT on the card) for long
ones. Causal semantics with explicit prehistory make streaming exact with
zero latency: ``zf`` is the last ``K-1`` input samples, the carry and the
checkpoint.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.cache import BoundedCache
from . import _mm  # noqa: F401  (turns TF32 off for cuDNN's convolution)
from .windows import get_window

# designed taps, float32, keyed by the design's parameters
_DESIGNS = BoundedCache(maxsize=64)


def fir_design(
    num_taps: int,
    cutoff: float | tuple[float, float],
    sample_rate: float,
    kind: str = "lowpass",
    window: str = "hamming",
) -> np.ndarray:
    """Windowed-sinc FIR design (scipy.signal.firwin semantics), float64.

    kind: "lowpass" | "highpass" | "bandpass" | "bandstop". Odd ``num_taps``
    required for highpass/bandstop (type-I linear phase). Gain is normalized
    at DC (lowpass/bandstop) or at the passband center (highpass/bandpass).
    """
    if num_taps < 3:
        raise ValueError("num_taps must be >= 3")
    nyq = sample_rate / 2.0
    edges = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) / nyq
    if np.any(edges <= 0) or np.any(edges >= 1):
        raise ValueError(f"cutoff must lie strictly inside (0, {nyq}) Hz")
    if kind in ("highpass", "bandstop") and num_taps % 2 == 0:
        raise ValueError(f"{kind} needs odd num_taps (type-I linear phase)")
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0

    def sinc_lp(fc):  # ideal lowpass with cutoff fc (normalized to Nyquist)
        return fc * np.sinc(fc * m)

    if kind == "lowpass":
        h = sinc_lp(edges[0])
    elif kind == "highpass":
        h = -sinc_lp(edges[0])
        h[(num_taps - 1) // 2] += 1.0
    elif kind == "bandpass":
        if edges.size != 2:
            raise ValueError("bandpass needs (low, high) cutoff")
        h = sinc_lp(edges[1]) - sinc_lp(edges[0])
    elif kind == "bandstop":
        if edges.size != 2:
            raise ValueError("bandstop needs (low, high) cutoff")
        h = sinc_lp(edges[0]) - sinc_lp(edges[1])
        h[(num_taps - 1) // 2] += 1.0
    else:
        raise ValueError(f"unknown FIR kind {kind!r}")
    w = get_window(window, num_taps, periodic=False)
    h = h * w
    # normalize gain: DC for lowpass/bandstop, band center for the others
    if kind in ("lowpass", "bandstop"):
        h /= h.sum()
    elif kind == "highpass":
        h /= np.abs((h * np.cos(np.pi * m)).sum())  # gain at Nyquist
    else:
        fc = 0.5 * (edges[0] + edges[1])  # scipy.firwin's scale frequency
        h /= np.abs((h * np.exp(-1j * np.pi * fc * m)).sum())
    return h


def cached_design(num_taps: int, cutoff, sample_rate: float, kind: str, window: str) -> np.ndarray:
    """:func:`fir_design` as float32 taps, designed once per parameter set.
    Shared: callers must not write to it."""
    key = (num_taps, tuple(np.atleast_1d(cutoff).tolist()), float(sample_rate), kind, window)
    if key not in _DESIGNS:
        _DESIGNS[key] = fir_design(num_taps, cutoff, sample_rate, kind, window).astype(np.float32)
    return _DESIGNS[key]


def fir_apply(
    x: torch.Tensor,
    h: torch.Tensor | np.ndarray,
    zi: torch.Tensor | None = None,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal FIR: ``y[n] = sum_k h[k] x[n-k]``, same-length output.

    ``zi [..., K-1]`` is the input prehistory (zeros if None); returns
    ``(y, zf)`` with ``zf`` = the last K-1 inputs: feed it back in for exact
    chunked or streamed processing. ``impl``: "direct" (``conv1d``), "fft"
    (fast convolution), "auto" (fft above 192 taps).
    """
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    k = h.shape[-1]
    lead = x.shape[:-1]
    if k == 1:
        return x * h[0], (zi if zi is not None else x.new_zeros((*lead, 0)))
    if zi is None:
        zi = x.new_zeros((*lead, k - 1))
    xx = torch.cat([zi, x], dim=-1)
    zf = xx[..., xx.shape[-1] - (k - 1) :]
    if impl == "auto":
        impl = "fft" if k > 192 else "direct"
    if impl == "direct":
        # conv1d is a correlation: flip the kernel
        rows = math.prod(lead)
        y = torch.nn.functional.conv1d(xx.reshape(rows, 1, xx.shape[-1]), h.flip(-1).reshape(1, 1, k))
        y = y.reshape(*lead, -1)
    elif impl == "fft":
        t = xx.shape[-1]
        n = 1 << (t + k - 1).bit_length()
        spec = torch.fft.rfft(xx, n=n) * torch.fft.rfft(h, n=n)
        y = torch.fft.irfft(spec, n=n)[..., k - 1 : t].to(x.dtype)
    else:
        raise ValueError(f"unknown fir impl {impl!r}; known: direct, fft, auto")
    return y, zf


def convolve(x: torch.Tensor, ir: torch.Tensor | np.ndarray, mode: str = "full") -> torch.Tensor:
    """Linear convolution with an impulse response (convolution reverb).

    ``mode``: "full" (length T+K-1) or "same" (length T, zero-latency head:
    the causal :func:`fir_apply` output).
    """
    k = np.shape(ir)[-1]
    impl = "fft" if k > 192 else "direct"
    if mode == "same":
        return fir_apply(x, ir, impl=impl)[0]
    if mode != "full":
        raise ValueError(f"unknown mode {mode!r}; known: full, same")
    return fir_apply(torch.nn.functional.pad(x, (0, k - 1)), ir, impl=impl)[0]
