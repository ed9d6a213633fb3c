"""Spectral decomposition: HPSS, spectral-gate denoising and NMF.

Mirrors ``audioflow_tpu/ops/decompose.py``. Harmonic/percussive separation
(Fitzgerald 2010, the librosa convention) median-filters the power
spectrogram along time and frequency and applies p-power Wiener soft masks
to the complex STFT. Spectral gating (the "noisereduce" recipe) estimates
a per-bin noise floor, thresholds the magnitude against it and smooths the
decision into a soft mask. NMF factorizes a magnitude spectrogram by
Lee-Seung multiplicative updates, a host loop of matmuls.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cache import BoundedCache
from ._mm import mm
from .framing import frame
from .stft import istft, stft

# median comparator schedules, keyed by the window size
_NETWORKS = BoundedCache(maxsize=64)


def median_network(n: int) -> tuple[tuple[int, int], ...]:
    """Comparator schedule that routes the median of ``n`` values to wire
    ``n // 2``: an odd-even transposition sort (n passes of adjacent
    compare-exchanges), dead-code-eliminated backwards from the one output
    wire. For n=17 it keeps 79 of the 136 comparators. Each comparator is
    one ``minimum`` and one ``maximum`` over shifted views: no window tensor
    and no sort."""
    if n not in _NETWORKS:
        comps = []
        for p in range(n):
            for i in range(p % 2, n - 1, 2):
                comps.append((i, i + 1))
        needed = {n // 2}
        kept: list[tuple[int, int]] = []
        for i, j in reversed(comps):
            if i in needed or j in needed:
                kept.append((i, j))
                needed.add(i)
                needed.add(j)
        _NETWORKS[n] = tuple(reversed(kept))
    return _NETWORKS[n]


def _pad_index(n: int, left: int, right: int, mode: str, device) -> torch.Tensor:
    """Source index of each position of ``x [..., n]`` padded by ``left``
    and ``right`` in numpy's ``symmetric`` (the edge sample repeated:
    ``b a | a b c``) or ``reflect`` (``c b | a b c``) mode, any pad width."""
    i = torch.arange(-left, n + right, device=device)
    if mode == "symmetric":
        i = torch.remainder(i, 2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * n - 2)
    return torch.where(i >= n, 2 * n - 2 - i, i)


def _pad(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    return x.index_select(-1, _pad_index(x.shape[-1], left, right, mode, x.device))


def median_filter(x: torch.Tensor, size: int, axis: int = -1, impl: str = "auto") -> torch.Tensor:
    """Sliding-window median along ``axis`` (odd ``size``), padded as
    scipy.ndimage.median_filter(mode='reflect'), numpy's ``symmetric``.

    ``impl``: "network" (the default for size <= 33) is the pruned min/max
    comparator network over ``size`` shifted views; "sort" sorts
    ``[..., N, size]`` windows (``torch.sort``), for large windows.
    """
    if size % 2 != 1 or size < 1:
        raise ValueError(f"median size must be odd and >= 1, got {size}")
    if impl not in ("auto", "network", "sort"):
        raise ValueError(f"median impl must be auto|network|sort, got {impl!r}")
    if size == 1:
        return x
    x = torch.movedim(x, axis, -1)
    h = size // 2
    xp = _pad(x, h, h, "symmetric")
    n = x.shape[-1]
    if impl == "network" or (impl == "auto" and size <= 33):
        vals = [xp[..., k : k + n] for k in range(size)]
        for i, j in median_network(size):
            lo = torch.minimum(vals[i], vals[j])
            vals[j] = torch.maximum(vals[i], vals[j])
            vals[i] = lo
        med = vals[h]
    else:
        med = torch.sort(frame(xp, size, 1), dim=-1).values[..., h]
    return torch.movedim(med, -1, axis)


def hpss_mask(
    power_spec: torch.Tensor,
    kernel_time: int = 17,
    kernel_freq: int = 17,
    power: float = 2.0,
    margin: float = 1.0,
    eps: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Soft harmonic/percussive masks for a power spectrogram ``[..., T, F]``
    (time axis -2, frequency axis -1). ``power`` is the Wiener exponent;
    ``margin`` > 1 sharpens the split (librosa's margin semantics)."""
    harm = median_filter(power_spec, kernel_time, axis=-2)
    perc = median_filter(power_spec, kernel_freq, axis=-1)
    hp = harm**power
    pp = (margin * perc) ** power
    mask_h = hp / torch.clamp_min(hp + pp, eps)
    hp2 = (margin * harm) ** power
    pp2 = perc**power
    mask_p = pp2 / torch.clamp_min(hp2 + pp2, eps)
    return mask_h, mask_p


def hpss(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    kernel_time: int = 17,
    kernel_freq: int = 17,
    power: float = 2.0,
    margin: float = 1.0,
    impl: str = "matmul",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a waveform into (harmonic, percussive) components: STFT ->
    median masks -> masked ISTFT, both from one analysis. Output length
    matches the input."""
    t = x.shape[-1]
    spec = stft(x, n_fft, hop, window=window, impl=impl)
    p = spec.real**2 + spec.imag**2
    mask_h, mask_p = hpss_mask(p, kernel_time, kernel_freq, power, margin)
    y_h = istft(spec * mask_h, n_fft, hop, window=window, length=t, impl=impl)
    y_p = istft(spec * mask_p, n_fft, hop, window=window, length=t, impl=impl)
    return y_h, y_p


def noise_profile(mag: torch.Tensor, quantile: float = 0.1, eps: float = 1e-10) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bin noise floor (mean, std) in log-magnitude from the quietest
    ``quantile`` of frames, energy-ranked by a stable sort (``jnp.argsort``
    is stable); the std is the population one (``ddof=0``). mag
    ``[..., T, F]``."""
    logm = torch.log10(torch.clamp_min(mag, eps))
    energy = mag.sum(dim=-1)  # [..., T]
    k = max(int(round(mag.shape[-2] * quantile)), 2)
    idx = torch.argsort(energy, dim=-1, stable=True)[..., :k]  # the quietest k frames
    quiet = torch.gather(logm, -2, idx[..., None].expand(*idx.shape, logm.shape[-1]))
    return quiet.mean(dim=-2), quiet.std(dim=-2, correction=0)


def _smooth(mask: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Boxcar smoothing along ``axis`` (reflect-padded moving average)."""
    if size <= 1:
        return mask
    m = torch.movedim(mask, axis, -1)
    h = size // 2
    mp = _pad(m, h, size - 1 - h, "reflect")
    return torch.movedim(frame(mp, size, 1).mean(dim=-1), -1, axis)


def spectral_gate(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    noise: torch.Tensor | None = None,
    n_std: float = 1.5,
    prop_decrease: float = 1.0,
    time_smooth: int = 5,
    freq_smooth: int = 5,
    quantile: float = 0.1,
    impl: str = "matmul",
) -> torch.Tensor:
    """Stationary-noise spectral gating (the noisereduce recipe).

    A per-bin threshold sits at ``mean + n_std * std`` of the noise's
    log-magnitude, from ``noise`` (a noise-only clip ``[..., T]``) when
    given, else from the quietest ``quantile`` of the signal's own frames.
    Bins below it are attenuated by ``prop_decrease``; the binary decision
    is boxcar-smoothed over ``time_smooth`` frames and ``freq_smooth`` bins.
    """
    t = x.shape[-1]
    spec = stft(x, n_fft, hop, window=window, impl=impl)
    mag = spec.abs()
    if noise is not None:
        nmag = stft(noise, n_fft, hop, window=window, impl=impl).abs()
        logn = torch.log10(torch.clamp_min(nmag, 1e-10))
        mean, std = logn.mean(dim=-2), logn.std(dim=-2, correction=0)
    else:
        mean, std = noise_profile(mag, quantile)
    thresh = mean + n_std * std  # [..., F]
    keep = (torch.log10(torch.clamp_min(mag, 1e-10)) > thresh[..., None, :]).to(mag.dtype)
    keep = _smooth(_smooth(keep, time_smooth, axis=-2), freq_smooth, axis=-1)
    gain = 1.0 - prop_decrease * (1.0 - keep)
    return istft(spec * gain, n_fft, hop, window=window, length=t, impl=impl)


def _nmf_updates(
    s: torch.Tensor, h: torch.Tensor, w: torch.Tensor, n_iter: int, loss: str, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`nmf` from the initial draws ``h [..., T, K]`` and
    ``w [..., K, F]`` (uniform in [0.1, 1)): the energy-matched scaling,
    then ``n_iter`` multiplicative updates."""
    s = torch.clamp_min(s, 0.0)
    # energy-matched init keeps the first ratios O(1)
    scale = s.sum(dim=(-2, -1), keepdim=True) / torch.clamp_min((h @ w).sum(dim=(-2, -1), keepdim=True), eps)
    h = h * torch.sqrt(scale)
    w = w * torch.sqrt(scale)
    for _ in range(n_iter):
        if loss == "frobenius":
            h = h * mm(s, w.mT) / torch.clamp_min(mm(mm(h, w), w.mT), eps)
            w = w * mm(h.mT, s) / torch.clamp_min(mm(mm(h.mT, h), w), eps)
        else:  # KL divergence; its denominators are the rank-1 row sums
            r = torch.clamp_min(mm(h, w), eps)
            h = h * mm(s / r, w.mT) / torch.clamp_min(w.sum(dim=-1)[..., None, :], eps)
            r = torch.clamp_min(mm(h, w), eps)
            w = w * mm(h.mT, s / r) / torch.clamp_min(h.sum(dim=-2)[..., :, None], eps)
    return h, w


def nmf(
    s: torch.Tensor,
    n_components: int,
    n_iter: int = 200,
    loss: str = "frobenius",
    seed: int = 0,
    eps: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nonnegative matrix factorization of a magnitude/power spectrogram:
    ``s [..., T, F] ~ h @ w`` with activations ``h [..., T, K]`` and
    templates ``w [..., K, F]``, by Lee-Seung multiplicative updates
    (``"frobenius"`` or ``"kl"``), a host loop of ``n_iter`` steps.

    The initial factors are uniform in [0.1, 1), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``s``'s device (the JAX
    package draws them from ``jax.random``, another stream), then scaled so
    the first reconstruction matches ``s`` in total energy.
    """
    if n_components < 1:
        raise ValueError(f"n_components must be >= 1, got {n_components}")
    if loss not in ("frobenius", "kl"):
        raise ValueError(f"unknown loss {loss!r}; known: frobenius, kl")
    *lead, t, f = s.shape
    gen = torch.Generator(device=s.device).manual_seed(seed)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=s.device, dtype=s.dtype) * 0.9 + 0.1

    h = uniform((*lead, t, n_components))
    w = uniform((*lead, n_components, f))
    return _nmf_updates(s, h, w, n_iter, loss, eps)


def nmf_separate(
    x: torch.Tensor,
    n_components: int = 2,
    n_fft: int = 1024,
    hop: int = 256,
    n_iter: int = 200,
    loss: str = "frobenius",
    seed: int = 0,
    power: float = 1.0,
    eps: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blind source separation of ``x [T]`` into ``n_components`` waveforms:
    STFT -> NMF of the magnitude (``power=1``; 2 factorizes the power) ->
    per-component soft masks ``V_k / sum_j V_j`` on the complex spectrogram
    -> ISTFT. The masks sum to 1, so the components sum to the input.
    Returns ``(components [K, T], activations [F, K], templates [K, bins])``.
    """
    if x.ndim != 1:
        raise ValueError(f"nmf_separate takes a 1-D signal, got {tuple(x.shape)}")
    spec = stft(x, n_fft, hop)
    mag = spec.abs() ** power
    h, w = nmf(mag, n_components, n_iter=n_iter, loss=loss, seed=seed, eps=eps)
    # per-component magnitude models [K, frames, bins] from outer products
    v = torch.clamp_min(h.mT[:, :, None] * w[:, None, :], 0.0)
    masks = v / torch.clamp_min(v.sum(dim=0, keepdim=True), eps)
    comps = istft(masks * spec[None], n_fft, hop, length=x.shape[-1])
    return comps, h, w
