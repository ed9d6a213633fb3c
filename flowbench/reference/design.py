"""Filter, window and filterbank designs, worked out by the reference itself.

Frozen copies of the published designs the configurations name, in float64
numpy: the kaiser windowed-sinc polyphase bank (the design that
``audioflow_torch/ops/resample.py`` documents), the periodic hann window, and
the slaney mel filterbank (librosa's ``htk=False, norm="slaney"``). Nothing
here is read from the program: a later change to the program's designs cannot
move the yardstick.
"""

from __future__ import annotations

import math

import numpy as np

# the kaiser design's published constants: 16 taps a side per output period, beta 8.555
KAISER_HALF_WIDTH = 16
KAISER_BETA = 8.555

# named VAD sensitivity presets of the dictation app (threshold in dB of mean square)
VAD_LEVELS = {"aggressive": -55.0, "balanced": -50.0, "relaxed": -40.0}


def rational(input_rate: int, output_rate: int) -> tuple[int, int]:
    """``(up, down)`` in lowest terms for ``output_rate / input_rate``."""
    g = math.gcd(int(input_rate), int(output_rate))
    return int(output_rate) // g, int(input_rate) // g


def kaiser_bank(up: int, down: int) -> tuple[np.ndarray, int]:
    """Windowed-sinc polyphase bank ``[up, K]`` and its anchor offset.

    The lowpass keeps ``2 * half_width`` taps per output period when
    decimating (``half_width * ceil(down / up)`` a side), cutoff ``1 /
    max(up, down)`` of the upsampled rate, gain ``up``. Output ``n`` is
    ``sum_t bank[p, t] * x[n * down // up + offset + t]`` with ``p = n * down
    % up`` and ``x`` zero outside the signal.
    """
    half = KAISER_HALF_WIDTH * max(1, -(-down // up))
    n_total = 2 * half * up + 1
    k = np.arange(n_total, dtype=np.float64) - half * up
    fc = 1.0 / max(up, down)
    h = up * fc * np.sinc(fc * k) * np.kaiser(n_total, KAISER_BETA)
    taps = 2 * half + 1
    # tap t of phase p is h[(taps - 1 - t) * up + p]
    idx = (taps - 1 - np.arange(taps))[None, :] * up + np.arange(up)[:, None]
    bank = np.where(idx < n_total, h[np.minimum(idx, n_total - 1)], 0.0)
    return bank, -((taps - 1) // 2)


def hann(n: int) -> np.ndarray:
    """Periodic hann window of ``n`` points."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def dft_banks(n_fft: int, window: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real DFT banks ``[n_fft, n_fft // 2 + 1]``: the real and
    imaginary parts of ``sum_n w[n] x[n] exp(-2 pi i n k / n_fft)``. The angle
    is reduced modulo ``n_fft`` in integers, so it is exact."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * ((n * k) % n_fft) / n_fft
    return window[:, None] * np.cos(ang), -window[:, None] * np.sin(ang)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f * 3.0 / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * 27.0 / np.log(6.4), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0), m * 200.0 / 3.0)


def slaney_filterbank(n_fft: int, n_mels: int, sample_rate: float, f_min: float, f_max: float) -> np.ndarray:
    """Triangular slaney-normalised mel filterbank ``[n_fft // 2 + 1, n_mels]``."""
    freqs = np.arange(n_fft // 2 + 1) * sample_rate / n_fft
    pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    lo, mid, hi = pts[:-2], pts[1:-1], pts[2:]
    rise = (freqs[:, None] - lo) / np.maximum(mid - lo, 1e-10)
    fall = (hi - freqs[:, None]) / np.maximum(hi - mid, 1e-10)
    return np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))
