"""Frame-level spectral and time-domain descriptors.

Mirrors ``audioflow_tpu/ops/features.py`` (librosa conventions): spectral
centroid, bandwidth, rolloff, flatness and flux, zero-crossing rate, frame
RMS, chroma, regression deltas, PCEN, spectral contrast, tonnetz and
time-lagged stacking. Spectral inputs are magnitude (not power)
spectrograms ``[..., F, bins]`` unless noted; time-domain inputs are signals
``[..., T]``. The host designs (bin frequencies, the chroma filterbank, the
contrast bands, the tonnetz basis) are float64, bit for bit the JAX
package's, designed once and uploaded once per device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cache import BoundedCache, on_device
from ._mm import mm
from .framing import frame

# host designs keyed by their parameters
_DESIGNS = BoundedCache(maxsize=64)


def _cached(key, design):
    if key not in _DESIGNS:
        _DESIGNS[key] = design()
    return _DESIGNS[key]


def fft_frequencies(sample_rate: float, n_fft: int) -> np.ndarray:
    """Bin center frequencies [n_fft//2 + 1] (host-side, f64)."""
    return np.arange(n_fft // 2 + 1, dtype=np.float64) * sample_rate / n_fft


def _freqs(mag: torch.Tensor, sample_rate: float, n_fft: int) -> torch.Tensor:
    f = _cached(("freqs", float(sample_rate), n_fft), lambda: fft_frequencies(sample_rate, n_fft))
    return on_device(f, mag.device, mag.dtype)


def spectral_centroid(mag: torch.Tensor, sample_rate: float, n_fft: int, eps: float = 1e-10) -> torch.Tensor:
    """First spectral moment per frame, Hz ``[..., F]``."""
    f = _freqs(mag, sample_rate, n_fft)
    norm = torch.clamp_min(mag.sum(dim=-1), eps)
    return (mag * f).sum(dim=-1) / norm


def spectral_bandwidth(
    mag: torch.Tensor, sample_rate: float, n_fft: int, p: float = 2.0, eps: float = 1e-10
) -> torch.Tensor:
    """p-th order spectral moment about the centroid, Hz ``[..., F]``."""
    f = _freqs(mag, sample_rate, n_fft)
    c = spectral_centroid(mag, sample_rate, n_fft, eps)
    norm = torch.clamp_min(mag.sum(dim=-1), eps)
    dev = (f - c[..., None]).abs() ** p
    return ((mag * dev).sum(dim=-1) / norm) ** (1.0 / p)


def spectral_rolloff(mag: torch.Tensor, sample_rate: float, n_fft: int, roll_percent: float = 0.85) -> torch.Tensor:
    """Frequency below which ``roll_percent`` of the spectral energy lies,
    Hz ``[..., F]``: the lowest bin whose cumulative magnitude crosses the
    threshold (librosa's definition)."""
    f = _freqs(mag, sample_rate, n_fft)
    cum = torch.cumsum(mag, dim=-1)
    hit = cum >= roll_percent * cum[..., -1:]  # monotone: the first True stays True
    # argmax returns the first maximal index: the first crossing
    return f[torch.argmax(hit.to(torch.uint8), dim=-1)]


def spectral_flatness(mag: torch.Tensor, eps: float = 1e-10, power: float = 2.0) -> torch.Tensor:
    """Geometric/arithmetic mean ratio of the power spectrum, ``[..., F]``
    in (0, 1]; ``power=2`` matches librosa (flatness of ``mag**2``)."""
    s = torch.clamp_min(mag, eps) ** power
    return torch.exp(torch.log(s).mean(dim=-1)) / s.mean(dim=-1)


def spectral_flux(
    mag: torch.Tensor,
    norm: bool = True,
    rectify: bool = False,
    prev: torch.Tensor | None = None,
) -> torch.Tensor:
    """L2 distance between consecutive frames ``[..., F]`` (frame 0 fluxes
    against itself: 0). ``rectify`` keeps only increases; ``norm``
    L1-normalizes each frame first. ``prev [..., 1, bins]`` is frame -1 for
    chunked processing (the previous chunk's last frame)."""
    if norm:
        mag = mag / torch.clamp_min(mag.sum(dim=-1, keepdim=True), 1e-10)
    if prev is None:
        head = mag[..., :1, :]
    else:
        head = prev / torch.clamp_min(prev.sum(dim=-1, keepdim=True), 1e-10) if norm else prev
    d = mag - torch.cat([head, mag[..., :-1, :]], dim=-2)
    if rectify:
        d = torch.clamp_min(d, 0.0)
    return torch.sqrt((d * d).sum(dim=-1))


def zero_crossing_rate(x: torch.Tensor, frame_length: int = 2048, hop: int = 512) -> torch.Tensor:
    """Fraction of sign changes per frame ``[..., F]`` (librosa: zero counts
    as the positive side)."""
    pos = frame(x, frame_length, hop) >= 0.0
    return (pos[..., 1:] != pos[..., :-1]).to(x.dtype).mean(dim=-1)


def frame_rms(x: torch.Tensor, frame_length: int = 2048, hop: int = 512) -> torch.Tensor:
    """Root-mean-square level per frame ``[..., F]``."""
    fr = frame(x, frame_length, hop)
    return torch.sqrt((fr * fr).mean(dim=-1))


def chroma_filterbank(
    sample_rate: float,
    n_fft: int,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: float = 2.0,
    base_c: bool = True,
) -> np.ndarray:
    """Chroma (pitch-class) filterbank ``[n_freqs, n_chroma]``, float32,
    matmul-ready: librosa.filters.chroma conventions (Gaussian bleed across
    fractional pitch classes, per-bin L2 normalization, Gaussian octave
    weighting centered at ``ctroct``, C-based class order), designed in
    float64."""
    freqs = np.linspace(0, sample_rate, n_fft, endpoint=False)[1:]
    a440 = 440.0 * 2.0 ** (tuning / n_chroma)
    frqbins = n_chroma * np.log2(freqs / (a440 / 16.0))
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidth = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    d = np.subtract.outer(frqbins, np.arange(n_chroma, dtype=np.float64)).T  # [C, n_fft]
    half = round(n_chroma / 2)
    d = np.remainder(d + half + 10 * n_chroma, n_chroma) - half
    wts = np.exp(-0.5 * (2 * d / np.tile(binwidth, (n_chroma, 1))) ** 2)
    wts /= np.maximum(np.sqrt((wts**2).sum(axis=0)), 1e-10)  # per-bin L2
    if octwidth:
        wts *= np.tile(
            np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
            (n_chroma, 1),
        )
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : n_fft // 2 + 1].T.astype(np.float32))


def chroma(
    power_spec: torch.Tensor,
    sample_rate: float,
    n_fft: int,
    n_chroma: int = 12,
    norm: bool = True,
    tuning: float = 0.0,
) -> torch.Tensor:
    """Chromagram from a power spectrogram ``[..., F, bins]`` ->
    ``[..., F, n_chroma]``: one matmul and an optional per-frame max-norm
    (librosa.feature.chroma_stft)."""
    fb = _cached(
        ("chroma", float(sample_rate), n_fft, n_chroma, float(tuning)),
        lambda: chroma_filterbank(sample_rate, n_fft, n_chroma, tuning),
    )
    c = mm(power_spec, on_device(fb, power_spec.device, power_spec.dtype))
    if norm:
        c = c / torch.clamp_min(c.amax(dim=-1, keepdim=True), 1e-10)
    return c


def _delta_taps(width: int) -> np.ndarray:
    n = width // 2
    taps = np.arange(-n, n + 1, dtype=np.float64)
    return (taps / (2.0 * np.sum(np.arange(1, n + 1, dtype=np.float64) ** 2))).astype(np.float32)


def delta_taps(width: int, device, dtype=torch.float32) -> torch.Tensor:
    """The regression taps ``n / (2 sum n^2)`` for ``n = -width//2 ..
    width//2``, float32 on ``device``."""
    return on_device(_cached(("delta", width), lambda: _delta_taps(width)), device, dtype)


def delta(feats: torch.Tensor, width: int = 9, order: int = 1) -> torch.Tensor:
    """Kaldi/HTK-style regression deltas along the time axis (-2):
    ``d[t] = sum_{n=1..N} n (c[t+n] - c[t-n]) / (2 sum n^2)``, the edges
    replicated, ``N = width // 2``; ``order=2`` applies it twice."""
    if width < 3 or width % 2 != 1:
        raise ValueError(f"width must be odd and >= 3, got {width}")
    if order < 1:
        raise ValueError("order must be >= 1")
    n = width // 2
    w = delta_taps(width, feats.device, feats.dtype)
    out = feats
    for _ in range(order):
        m = out.movedim(-2, -1)  # [..., F, T]
        t = m.shape[-1]
        edge = torch.clamp(torch.arange(-n, t + n, device=m.device), 0, t - 1)
        win = frame(m.index_select(-1, edge), width, 1)  # [..., F, T, width]
        out = (win * w).sum(dim=-1).movedim(-1, -2)
    return out


def add_deltas(feats: torch.Tensor, width: int = 9, orders: tuple[int, ...] = (1, 2)) -> torch.Tensor:
    """Base features with their deltas along the feature axis (the ASR
    [static, delta, delta-delta] layout)."""
    return torch.cat([feats] + [delta(feats, width, o) for o in orders], dim=-1)


def pcen_smoother(
    energy: torch.Tensor,
    smooth: float,
    m_prev: torch.Tensor | None = None,
    first_index: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The PCEN time smoother ``M[t] = (1-s) M[t-1] + s E[t]`` over the time
    axis (-2) of ``energy [..., T, F]``. Returns ``(M, M[last])``.

    The affine recurrence ``M[t] = a[t] M[t-1] + b[t]`` runs as a doubling
    scan, log2(T) steps of whole-tensor ops (the JAX package runs it as an
    associative scan). ``m_prev [..., F]`` carries M across chunks (None:
    offline, seeded so that M[0] == E[0]). ``first_index`` (the
    chunk-relative index of the stream's offline frame 0) reseeds M = E at
    that frame, reproducing the offline warm start mid-stream.
    """
    s = float(smooth)
    e_t = energy.movedim(-2, 0)  # [T, ..., F]
    a = torch.full_like(e_t, 1.0 - s)
    b = s * e_t
    # offline warm start: M[0] = (1-s) E[0] + s E[0] = E[0]
    b[0] = b[0] + (1.0 - s) * (e_t[0] if m_prev is None else m_prev)
    a[0] = 0.0
    if first_index is not None and 0 <= first_index < e_t.shape[0]:
        a[first_index] = 0.0
        b[first_index] = e_t[first_index]
    d = 1
    while d < e_t.shape[0]:
        # (a, b)[t] <- (a, b)[t-d] then (a, b)[t]: a' = a[t] a[t-d], b' = b[t] + a[t] b[t-d]
        b = torch.cat([b[:d], b[d:] + a[d:] * b[:-d]])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return b.movedim(0, -2), b[-1]


def pcen_output(energy: torch.Tensor, m: torch.Tensor, alpha: float, delta_bias: float, r: float, eps: float):
    """``(E / (eps + M)^alpha + delta)^r - delta^r``."""
    return (energy / (eps + m) ** alpha + delta_bias) ** r - delta_bias**r


def pcen(
    energy: torch.Tensor,
    smooth: float = 0.025,
    alpha: float = 0.98,
    delta_bias: float = 2.0,
    r: float = 0.5,
    eps: float = 1e-6,
    initial: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-channel energy normalization (Wang et al., 2017) of a mel or
    linear energy spectrogram ``[..., T, F]``: the smoother
    :func:`pcen_smoother`, then ``(E / (eps + M)^alpha + delta)^r -
    delta^r``. ``initial`` seeds M[-1] (default: the E[0] warm start)."""
    m, _ = pcen_smoother(energy, smooth, m_prev=initial)
    return pcen_output(energy, m, alpha, delta_bias, r, eps)


def contrast_bands(sample_rate: float, n_fft: int, n_bands: int = 6, fmin: float = 200.0) -> list[tuple[int, int]]:
    """Octave sub-band bin ranges for spectral contrast (host-side): band 0
    is [0, fmin), band k >= 1 is [fmin*2^(k-1), fmin*2^k), the top band
    reaches Nyquist. ``n_bands + 1`` half-open ``(lo, hi)`` ranges covering
    all ``n_fft//2 + 1`` bins."""
    freqs = fft_frequencies(sample_rate, n_fft)
    edges = fmin * 2.0 ** np.arange(0, n_bands + 1, dtype=np.float64)
    if edges[-2] >= sample_rate / 2:
        raise ValueError(
            f"top contrast band start {edges[-2]:.0f} Hz >= Nyquist "
            f"{sample_rate / 2:.0f} Hz; lower n_bands or fmin"
        )
    bounds = [0] + [int(np.searchsorted(freqs, e)) for e in edges]
    bounds[-1] = len(freqs)  # top band always extends to Nyquist
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            raise ValueError(
                f"empty contrast sub-band [{lo},{hi}); n_fft={n_fft} too "
                f"small for n_bands={n_bands}, fmin={fmin}"
            )
        out.append((lo, hi))
    return out


def spectral_contrast(
    mag: torch.Tensor,
    sample_rate: float,
    n_fft: int,
    n_bands: int = 6,
    fmin: float = 200.0,
    quantile: float = 0.02,
    eps: float = 1e-10,
) -> torch.Tensor:
    """Octave-band spectral contrast ``[..., F, n_bands + 1]`` in dB:
    ``20*log10(peak/valley)`` per sub-band, peak and valley the means of
    the top and bottom ``quantile`` of the band's sorted bins (at least
    one; Jiang et al. 2002, the librosa feature)."""
    bands = _cached(
        ("contrast", float(sample_rate), n_fft, n_bands, float(fmin)),
        lambda: tuple(contrast_bands(sample_rate, n_fft, n_bands, fmin)),
    )
    cols = []
    for lo, hi in bands:
        sub = torch.sort(mag[..., lo:hi], dim=-1).values
        k = max(int(round(quantile * (hi - lo))), 1)
        valley = sub[..., :k].mean(dim=-1)
        peak = sub[..., hi - lo - k :].mean(dim=-1)
        cols.append(20.0 * (torch.log10(peak + eps) - torch.log10(valley + eps)))
    return torch.stack(cols, dim=-1)


def tonnetz_basis(n_chroma: int = 12) -> np.ndarray:
    """Tonal-centroid projection basis ``[n_chroma, 6]`` (host-side, f64):
    the circles of fifths, minor thirds and major thirds (Harte/Sandler
    2006), each a (sin, cos) pair, radii (1, 1, 0.5)."""
    dim = np.linspace(0, 12, num=n_chroma, endpoint=False)
    scale = np.array([7.0 / 6, 7.0 / 6, 3.0 / 2, 3.0 / 2, 2.0 / 3, 2.0 / 3])
    v = np.multiply.outer(scale, dim)  # [6, n_chroma]
    v[::2] -= 0.5  # sin rows lead cos rows by a quarter turn
    radii = np.array([1.0, 1.0, 1.0, 1.0, 0.5, 0.5])
    return np.ascontiguousarray((radii[:, None] * np.cos(np.pi * v)).T)


def tonnetz(chroma_frames: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Tonal centroid features ``[..., F, 6]`` from a chromagram
    ``[..., F, n_chroma]``: each frame L1-normalized, then projected."""
    n = chroma_frames.shape[-1]
    basis = _cached(("tonnetz", n), lambda: tonnetz_basis(n).astype(np.float32))
    c = chroma_frames / torch.clamp_min(chroma_frames.abs().sum(dim=-1, keepdim=True), eps)
    return mm(c, on_device(basis, c.device, c.dtype))


_FEATURES = ("centroid", "bandwidth", "rolloff", "flatness", "flux")


def spectral_features(
    mag: torch.Tensor,
    sample_rate: float,
    n_fft: int,
    features: tuple[str, ...] = _FEATURES,
) -> torch.Tensor:
    """Named spectral descriptors stacked ``[..., F, len(features)]``, in the
    order of ``features``."""
    cols = []
    for name in features:
        if name == "centroid":
            cols.append(spectral_centroid(mag, sample_rate, n_fft))
        elif name == "bandwidth":
            cols.append(spectral_bandwidth(mag, sample_rate, n_fft))
        elif name == "rolloff":
            cols.append(spectral_rolloff(mag, sample_rate, n_fft))
        elif name == "flatness":
            cols.append(spectral_flatness(mag))
        elif name == "flux":
            cols.append(spectral_flux(mag))
        else:
            raise ValueError(f"unknown spectral feature {name!r}; known: {_FEATURES}")
    return torch.stack(cols, dim=-1)


def stack_memory(feats: torch.Tensor, n_steps: int = 2, delay: int = 1) -> torch.Tensor:
    """Time-lagged stacking ``[..., T, F] -> [..., T, F * n_steps]``: the
    feature vector beside its ``delay``-frame history (zero-filled at the
    edge); a negative ``delay`` stacks lookahead."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if delay == 0:
        raise ValueError("delay must be nonzero")
    t = feats.shape[-2]
    outs = [feats]
    for k in range(1, n_steps):
        d = k * delay
        if abs(d) >= t:  # lag past the clip: the whole copy is edge fill
            shifted = torch.zeros_like(feats)
        elif d > 0:
            shifted = torch.nn.functional.pad(feats[..., : t - d, :], (0, 0, d, 0))
        else:
            shifted = torch.nn.functional.pad(feats[..., -d:, :], (0, 0, 0, -d))
        outs.append(shifted)
    return torch.cat(outs, dim=-1)
