"""Mel filterbank, log-mel and MFCC features, and their inversion to audio.

The filterbank and the DCT basis are host-side float64 designs copied bit
for bit from ``audioflow_tpu/ops/mel.py``; the projections are fp32
matmuls.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import as_tensor
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


def dct_matrix(n_in: int, n_out: int, norm: str | None = "ortho", dtype=np.float32) -> np.ndarray:
    """DCT-II basis ``[n_in, n_out]`` for MFCC as a matmul."""
    k = np.arange(n_out, dtype=np.float64)[None, :]
    n = np.arange(n_in, dtype=np.float64)[:, None]
    basis = 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    if norm == "ortho":
        basis[:, 0] *= 1.0 / np.sqrt(4.0 * n_in)
        basis[:, 1:] *= 1.0 / np.sqrt(2.0 * n_in)
    return basis.astype(dtype)


def mfcc(log_mels: torch.Tensor, n_mfcc: int = 13) -> torch.Tensor:
    """MFCC from log-mel features ``[..., n_mels]``: one more matmul (DCT-II, ortho)."""
    d = dct_matrix(log_mels.shape[-1], n_mfcc)
    return mm(log_mels, torch.from_numpy(d).to(log_mels.device))


# Feature inversion: mel/MFCC back to a spectrogram (non-negative least
# squares by Lee-Seung multiplicative updates from the adjoint), then to
# audio through griffin_lim.


def mel_to_stft(
    m: torch.Tensor,
    fb: np.ndarray,
    n_iter: int = 32,
    precision: str | None = "high",
    eps: float = 1e-10,
) -> torch.Tensor:
    """Nonnegative least-squares inverse of :func:`apply_mel`.

    Recovers a power spectrogram ``s [..., F, n_freqs]`` with ``s @ fb ~ m``
    and ``s >= 0`` by ``n_iter`` multiplicative updates
    ``s <- s * (m @ fb.T) / (s @ fb @ fb.T)`` from the adjoint init
    ``s0 = m @ fb.T``, in fp32 (``precision`` is accepted for parity).
    """
    fb = np.asarray(fb, np.float64)
    fbt = torch.from_numpy(fb.T.astype(np.float32)).to(m.device)
    fbj = torch.from_numpy(fb.astype(np.float32)).to(m.device)
    m = torch.clamp_min(m, 0.0)
    target = mm(m, fbt, precision)  # [..., F, n_freqs], constant across iterations
    s = target
    for _ in range(n_iter):
        denom = mm(mm(s, fbj, precision), fbt, precision)
        s = s * target / torch.clamp_min(denom, eps)
    return s


def mfcc_to_log_mel(coeffs: torch.Tensor, n_mels: int = 128) -> torch.Tensor:
    """Inverse of :func:`mfcc` (orthonormal DCT-II columns: the adjoint is the
    pseudo-inverse): ``[..., n_mfcc]`` -> ``[..., n_mels]``. Exact on the
    retained coefficients; the discarded ones are smoothed away."""
    d = dct_matrix(n_mels, coeffs.shape[-1])
    return mm(coeffs, torch.from_numpy(d.T.copy()).to(coeffs.device))


def mel_to_audio(
    m,
    fb: np.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    center: bool = True,
    length: int | None = None,
    nnls_iter: int = 32,
    gl_iter: int = 32,
    power: float = 2.0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Mel (power, ``power=2.0``, or magnitude, ``power=1.0``) spectrogram
    ``[..., F, n_mels]`` -> waveform: NNLS inversion to the linear
    spectrogram, then Griffin-Lim (``impl="auto"``: the fused kernel on the
    card). ``m`` is a tensor, or a numpy array that goes to ``device``
    ("cuda" unless given)."""
    # imported here: ops.griffinlim reaches ops.kernels.melspec, which
    # imports this module
    from .griffinlim import griffin_lim

    s = mel_to_stft(as_tensor(m, device), fb, n_iter=nnls_iter)
    mag = torch.sqrt(torch.clamp_min(s, 0.0)) if power == 2.0 else torch.clamp_min(s, 0.0)
    return griffin_lim(mag, n_fft, hop, window=window, n_iter=gl_iter, center=center, length=length)


def mfcc_to_audio(
    coeffs,
    fb: np.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    log_base: str = "ln",
    device: torch.device | str | None = None,
    **kwargs,
) -> torch.Tensor:
    """MFCC ``[..., F, n_mfcc]`` -> waveform via the inverse DCT, the inverse
    of :func:`log_mel` at ``log_base``, and :func:`mel_to_audio`."""
    lm = mfcc_to_log_mel(as_tensor(coeffs, device), n_mels=np.asarray(fb).shape[-1])
    if log_base == "ln":
        m = torch.exp(lm)
    elif log_base == "log10":
        m = torch.pow(10.0, lm)
    elif log_base == "db":
        m = torch.pow(10.0, lm / 10.0)
    else:
        raise ValueError(f"unknown log_base {log_base!r}")
    return mel_to_audio(m, fb, n_fft, hop, **kwargs)
