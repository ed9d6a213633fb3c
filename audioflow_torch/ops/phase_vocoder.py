"""Phase-vocoder time-stretch and pitch-shift (BASELINE config 4).

Mirrors ``audioflow_tpu/ops/phase_vocoder.py``. Three paths compute the
stretch:

* ``"matmul"``: STFT, the angle-form phase vocoder (per-frame increments,
  one ``cumsum``), ISTFT, all plain torch, the transforms as products with
  the DFT banks;
* ``"fft"``: the same with the transforms as ``torch.fft.rfft``/``irfft``
  (cuFFT on the card);
* ``"pallas"`` (the JAX package's name for its fused kernel): the
  hand-written CUDA kernel of :mod:`audioflow_torch.ops.kernels.timestretch`,
  which uses the trig-free phasor form (see :func:`increment_phasors`).

``impl="auto"`` takes the kernel for a CUDA tensor at a rate the kernel
supports, the matmul path otherwise (so always on the CPU, as the JAX
package off a TPU).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..utils import as_tensor
from .kernels.timestretch import supported, time_stretch_fused
from .resample import resample
from .stft import istft, stft

IMPLS = ("auto", "pallas", "matmul", "fft")


def _wrap_phase(p: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi)."""
    two_pi = 2.0 * np.pi
    return p - two_pi * torch.round(p / two_pi)


def increment_phasors(
    s_lo: torch.Tensor, s_hi: torch.Tensor, m_lo: torch.Tensor, m_hi: torch.Tensor
) -> torch.Tensor:
    """Unit phasor of the per-step phase increment between two analysis
    frames: ``exp(i*(angle(s_hi)-angle(s_lo)))`` without any trig (the
    expected advance and the wrap both cancel inside exp). Zero-magnitude
    frames contribute a unit phasor (the angle(0)==0 convention)."""
    denom = m_hi * m_lo
    ok = denom > 0
    u = s_hi * s_lo.conj() / torch.where(ok, denom, 1.0)
    return torch.where(ok, u, torch.ones_like(u))


def cumulative_phasor(u: torch.Tensor, axis: int) -> torch.Tensor:
    """Inclusive cumulative product of unit phasors along ``axis``."""
    return torch.cumprod(u, dim=axis)


def phase_vocoder(spec: torch.Tensor, rate: float, hop: int, n_fft: int) -> torch.Tensor:
    """Stretch a complex spectrogram ``[..., T, F]`` in time by ``1/rate``.

    rate > 1 speeds up (fewer output frames); rate < 1 slows down. The last
    output frames interpolate toward the last input frame (``hi`` clamped).
    """
    t_in = spec.shape[-2]
    steps = np.arange(0, t_in, rate)  # fractional analysis positions
    lo = np.minimum(steps.astype(np.int64), t_in - 1)
    hi = np.minimum(lo + 1, t_in - 1)
    frac = torch.from_numpy((steps - lo).astype(np.float32)).to(spec.device)[:, None]

    s_lo = spec[..., torch.from_numpy(lo).to(spec.device), :]
    s_hi = spec[..., torch.from_numpy(hi).to(spec.device), :]
    mag = (1.0 - frac) * s_lo.abs() + frac * s_hi.abs()

    # expected per-hop phase advance of each bin
    n_bins = spec.shape[-1]
    phi_adv = torch.from_numpy(
        (2.0 * np.pi * hop / n_fft) * np.arange(n_bins, dtype=np.float32)
    ).to(spec.device)
    dphase = _wrap_phase(s_hi.angle() - s_lo.angle() - phi_adv)
    increments = phi_adv + dphase  # [..., T_out, F]

    phase0 = s_lo[..., :1, :].angle()
    phase = phase0 + torch.cat(
        [torch.zeros_like(increments[..., :1, :]), torch.cumsum(increments[..., :-1, :], dim=-2)],
        dim=-2,
    )
    return mag * torch.exp(1j * phase)


def time_stretch(
    x,
    rate: float,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    impl: str = "auto",
    precision: str | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Stretch audio duration by 1/rate at constant pitch (ISTFT round-trip).

    ``x [..., T]`` is a tensor, or a numpy array that goes to ``device``
    ("cuda" unless given; see :func:`audioflow_torch.utils.as_tensor`).
    ``impl`` is "auto", "pallas" (force the fused kernel; its plain version
    on the CPU), "matmul" (STFT and ISTFT against the DFT banks) or "fft"
    (the same through ``torch.fft``). ``precision`` is
    accepted for parity: the port computes in fp32.
    """
    if rate <= 0:
        raise ValueError("rate must be positive")
    if impl not in IMPLS:
        raise ValueError(f"unknown time_stretch impl {impl!r}; known: {', '.join(IMPLS)}")
    x = as_tensor(x, device)
    if impl == "auto":
        fused = x.device.type == "cuda" and supported(rate, n_fft, hop)
        impl = "pallas" if fused else "matmul"
    if impl == "pallas":
        return time_stretch_fused(x.contiguous(), rate, n_fft, hop, window, precision=precision)
    spec = stft(x, n_fft=n_fft, hop=hop, window=window, impl=impl, precision=precision)
    out = phase_vocoder(spec, rate, hop, n_fft)
    length = int(round(x.shape[-1] / rate))
    return istft(
        out, n_fft=n_fft, hop=hop, window=window, length=length, impl=impl, precision=precision
    )


def pitch_shift(
    x,
    semitones: float,
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    resample_mode: str = "kaiser",
    device: torch.device | str | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Shift pitch by ``semitones`` at constant duration: stretch, then
    resample by ``Fraction(2**(semitones/12)).limit_denominator(64)`` (pitch
    error under a cent; only the ratio matters to the resampler).
    ``sample_rate`` is accepted for parity and not needed; ``impl`` picks the
    stretch's path, as in :func:`time_stretch`."""
    x = as_tensor(x, device)
    factor = 2.0 ** (semitones / 12.0)
    stretched = time_stretch(x, rate=1.0 / factor, n_fft=n_fft, hop=hop, impl=impl)
    fr = Fraction(factor).limit_denominator(64)
    y = resample(stretched, fr.numerator, fr.denominator, mode=resample_mode)
    t = x.shape[-1]
    if y.shape[-1] < t:
        y = torch.nn.functional.pad(y, (0, t - y.shape[-1]))
    return y[..., :t]
