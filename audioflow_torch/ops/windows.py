"""Analysis/synthesis window functions.

Windows are computed host-side in float64 with NumPy and cast to the compute
dtype — they are compile-time constants of a graph, never traced. Periodic
(DFT-even) variants are the default, as required for COLA-correct STFT.
"""

from __future__ import annotations

import numpy as np

_WINDOWS = {}


def _register(name):
    def deco(fn):
        _WINDOWS[name] = fn
        return fn

    return deco


@_register("rect")
def rect(n: int, periodic: bool = True) -> np.ndarray:
    del periodic
    return np.ones(n, dtype=np.float64)


def _cosine_sum(n: int, coeffs, periodic: bool) -> np.ndarray:
    denom = n if periodic else max(n - 1, 1)
    k = np.arange(n, dtype=np.float64)
    w = np.zeros(n, dtype=np.float64)
    for j, a in enumerate(coeffs):
        w += ((-1) ** j) * a * np.cos(2.0 * np.pi * j * k / denom)
    return w


@_register("hann")
def hann(n: int, periodic: bool = True) -> np.ndarray:
    return _cosine_sum(n, (0.5, 0.5), periodic)


@_register("hamming")
def hamming(n: int, periodic: bool = True) -> np.ndarray:
    return _cosine_sum(n, (0.54, 0.46), periodic)


@_register("blackman")
def blackman(n: int, periodic: bool = True) -> np.ndarray:
    return _cosine_sum(n, (0.42, 0.5, 0.08), periodic)


@_register("blackmanharris")
def blackmanharris(n: int, periodic: bool = True) -> np.ndarray:
    return _cosine_sum(n, (0.35875, 0.48829, 0.14128, 0.01168), periodic)


@_register("povey")
def povey(n: int, periodic: bool = True) -> np.ndarray:
    """Kaldi's 'povey' window: hann ** 0.85."""
    return hann(n, periodic) ** 0.85


def kaiser(n: int, beta: float, periodic: bool = False) -> np.ndarray:
    m = n + 1 if periodic else n
    w = np.kaiser(m, beta)
    return w[:n]


def get_window(name: str, n: int, periodic: bool = True) -> np.ndarray:
    """Look up a window by name. Raises ValueError for unknown names."""
    if name.startswith("kaiser:"):
        return kaiser(n, float(name.split(":", 1)[1]), periodic)
    try:
        return _WINDOWS[name](n, periodic)
    except KeyError:
        raise ValueError(f"unknown window {name!r}; known: {sorted(_WINDOWS)}") from None
