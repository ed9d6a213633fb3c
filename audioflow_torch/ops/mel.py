"""Mel filterbank and log-mel features.

The filterbank is a host-side float64 design copied bit for bit from
``audioflow_tpu/ops/mel.py``; the projection is one
``[frames, freqs] @ [freqs, mels]`` matmul in fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cache import BoundedCache, on_device
from ._mm import mm


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    n_freqs: int,
    n_mels: int = 128,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``[n_freqs, n_mels]`` (matmul-ready)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    n_fft = 2 * (n_freqs - 1)
    fft_freqs = np.arange(n_freqs, dtype=np.float64) * sample_rate / n_fft
    mel_pts = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    # vectorized triangle construction
    lower = hz_pts[:-2][None, :]  # [1, n_mels]
    center = hz_pts[1:-1][None, :]
    upper = hz_pts[2:][None, :]
    f = fft_freqs[:, None]  # [n_freqs, 1]
    up = (f - lower) / np.maximum(center - lower, 1e-10)
    down = (upper - f) / np.maximum(upper - center, 1e-10)
    fb = np.maximum(0.0, np.minimum(up, down))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[None, :]
    elif norm not in (None, "none"):
        raise ValueError(f"unknown mel norm {norm!r}")
    return fb.astype(dtype)


_FB_CACHE = BoundedCache(maxsize=64)


def cached_filterbank(*args) -> np.ndarray:
    """:func:`mel_filterbank` of the positional ``args``, designed once.

    The graph's nodes call this on every stream step; the result is shared
    and must not be written to.
    """
    if args not in _FB_CACHE:
        _FB_CACHE[args] = mel_filterbank(*args)
    return _FB_CACHE[args]


def _as_tensor(fb, device) -> torch.Tensor:
    return fb if isinstance(fb, torch.Tensor) else on_device(fb, device)


def apply_mel(spec_power: torch.Tensor, fb) -> torch.Tensor:
    """Project a power/magnitude spectrogram ``[..., frames, freqs]`` onto mel bins."""
    return mm(spec_power, _as_tensor(fb, spec_power.device))


def floor_log(m: torch.Tensor, floor: float, log_base: str | None) -> torch.Tensor:
    """``log(max(m, floor))`` in ``log_base``; None or "none" keeps the
    floored linear value (the JAX package's ``log_mel_fused`` convention)."""
    m = torch.clamp_min(m, floor)
    if log_base == "ln":
        return torch.log(m)
    if log_base == "log10":
        return torch.log10(m)
    if log_base == "db":
        return 10.0 * torch.log10(m)
    if log_base in (None, "none"):
        return m
    raise ValueError(f"unknown log_base {log_base!r}")


def log_mel(
    spec_power: torch.Tensor,
    fb,
    floor: float = 1e-10,
    log_base: str = "ln",
) -> torch.Tensor:
    """log(max(mel, floor)) — 'ln' (natural), 'log10', or 'db' (10*log10)."""
    if log_base in (None, "none"):
        raise ValueError(f"unknown log_base {log_base!r}")
    return floor_log(apply_mel(spec_power, fb), floor, log_base)
