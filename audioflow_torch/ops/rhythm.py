"""Rhythm analysis: onset strength and detection, tempogram, tempo, beats.

Mirrors ``audioflow_tpu/ops/rhythm.py`` (librosa conventions; the Ellis
2007 dynamic-programming beat tracker and its causal counterpart). Onset
strength, the sliding windows and the tempogram are elementwise passes and
reductions; the autocorrelation takes the JAX package's rule for a backend
that is not a TPU (``direct`` up to 64 lags, else ``torch.fft``, cuFFT on
the card; ``matmul`` only when asked). The sequential parts — peak picking's
"wait" constraint, the causal tracker, the DP's forward recurrence — are
Python loops over frames on the tensor's device, batched over lanes, where
the JAX package runs ``lax.scan``; the DP's backtrace walks the backlinks
from each lane's last beat, one step a beat, where the JAX package scans
every frame in reverse, and marks the same frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.cache import on_device
from ._mm import mm
from .framing import frame


def onset_strength(mel_power: torch.Tensor, lag: int = 1, eps: float = 1e-10) -> torch.Tensor:
    """Spectral-flux onset envelope ``[..., T]`` from a mel power
    spectrogram ``[..., T, M]``: per-band rectified dB increase over ``lag``
    frames, averaged across bands. The first ``lag`` frames are 0."""
    if lag < 1:
        raise ValueError(f"lag must be >= 1, got {lag}")
    s_db = 10.0 * torch.log10(torch.clamp_min(mel_power, eps))
    d = torch.clamp_min(s_db[..., lag:, :] - s_db[..., :-lag, :], 0.0).mean(dim=-1)
    return F.pad(d, (lag, 0))


def _sliding_extremum(x: torch.Tensor, pre: int, post: int, fill: float) -> torch.Tensor:
    """max over the window ``x[t-pre : t+post+1]`` for every t, out-of-range
    positions reading ``fill``: a max over pre+post+1 shifted slices."""
    t = x.shape[-1]
    xp = F.pad(x, (pre, post), value=fill)
    out = xp[..., 0:t]
    for k in range(1, pre + post + 1):
        out = torch.maximum(out, xp[..., k : k + t])
    return out


def _sliding_mean(x: torch.Tensor, pre: int, post: int) -> torch.Tensor:
    """mean over ``x[t-pre : t+post+1]`` clipped to the valid range (edge
    windows average fewer samples) — two cumsums."""
    t = x.shape[-1]
    c = F.pad(torch.cumsum(x, dim=-1), (1, 0))  # c[k] = sum of x[:k]
    idx = torch.arange(t, device=x.device)
    hi = torch.clamp_max(idx + post + 1, t)
    lo = torch.clamp_min(idx - pre, 0)
    return (c[..., hi] - c[..., lo]) / (hi - lo).to(x.dtype)


def peak_pick(
    env: torch.Tensor,
    pre_max: int = 3,
    post_max: int = 3,
    pre_avg: int = 10,
    post_avg: int = 10,
    delta: float = 0.07,
    wait: int = 3,
) -> torch.Tensor:
    """Boolean onset mask ``[..., T]`` over an onset envelope: a frame is an
    onset iff it is the maximum of ``env[t-pre_max : t+post_max+1]``, it
    exceeds the (edge-clipped) mean of ``env[t-pre_avg : t+post_avg+1]`` by
    ``delta``, and at least ``wait`` frames passed since the previously
    accepted onset (a loop over frames with an int32 carry per lane)."""
    is_max = env >= _sliding_extremum(env, pre_max, post_max, -float("inf"))
    over_avg = env >= _sliding_mean(env, pre_avg, post_avg) + delta
    cand = torch.logical_and(is_max, over_avg)
    since = torch.full(cand.shape[:-1], wait, dtype=torch.int32, device=env.device)
    picked = torch.zeros_like(cand)
    for t in range(cand.shape[-1]):
        ok = torch.logical_and(cand[..., t], since >= wait)
        since = torch.where(ok, 0, since + 1)
        picked[..., t] = ok
    return picked


def autocorrelate(
    x: torch.Tensor,
    max_lag: int | None = None,
    impl: str = "auto",
    precision: str | None = None,
) -> torch.Tensor:
    """Linear (non-circular) autocorrelation along the last axis, truncated
    to ``max_lag + 1`` lags.

    ``"direct"``: shifted multiply-sums, auto when ``max_lag <= 64``;
    ``"fft"``: the zero-padded rFFT power spectrum (cuFFT on the card), auto
    otherwise; ``"matmul"``: fp32 DFT-bank products at the minimal
    no-wraparound length, only when asked (the JAX package's auto picks it
    only on a TPU).
    """
    from .pitch import ACF_PRECISION_DEFAULT, _resolve_acf_impl

    n = x.shape[-1]
    if max_lag is None:
        max_lag = n - 1
    if impl == "auto":
        impl = "direct" if max_lag <= 64 else "fft"
    if impl == "direct":
        out = [(x * x).sum(dim=-1, keepdim=True)]
        for lag in range(1, max_lag + 1):
            out.append((x[..., :-lag] * x[..., lag:]).sum(dim=-1, keepdim=True))
        return torch.cat(out, dim=-1)
    if _resolve_acf_impl(impl) == "matmul":
        fwd, inv = _auto_acf_banks(n, max_lag)
        p = precision or ACF_PRECISION_DEFAULT
        k_count = fwd.shape[1] // 2
        spec = mm(x, on_device(fwd, x.device), p)  # [..., 2K] (Re | Im)
        power = spec[..., :k_count] ** 2 + spec[..., k_count:] ** 2
        return mm(power, on_device(inv, x.device), p)
    nfft = 1
    while nfft < n + max_lag + 1:
        nfft *= 2
    f = torch.fft.rfft(x, n=nfft, dim=-1)
    ac = torch.fft.irfft(f.real**2 + f.imag**2, n=nfft, dim=-1)
    return ac[..., : max_lag + 1]


@lru_cache(maxsize=16)
def _auto_acf_banks(n_in: int, max_lag: int) -> tuple[np.ndarray, np.ndarray]:
    """Autocorrelation packing of ``ops/pitch.py::_dft_corr_parts``: forward
    real DFT [n_in, 2K] at the minimal even no-wrap length n >= n_in +
    max_lag, inverse the Hermitian-weighted irfft cos of the power [K, T+1].
    Cached: do not write to them."""
    from .pitch import _dft_corr_parts, min_even_length

    n = min_even_length(n_in + max_lag)
    cosb, sinb, icos, _ = _dft_corr_parts(n_in, n, max_lag)
    return np.concatenate([cosb, sinb], axis=1), icos


def tempogram(env: torch.Tensor, win_length: int = 384, window: str = "hann") -> torch.Tensor:
    """Local autocorrelation tempogram ``[..., T, win_length]``: hop-1
    centered frames of the onset envelope, windowed, autocorrelated, and
    max-normalized per frame (lag 0 normalizes to 1)."""
    from .windows import get_window

    half = win_length // 2
    ep = F.pad(env, (half, half))
    fr = frame(ep, win_length, 1)[..., : env.shape[-1], :]  # [..., T, W]
    w = torch.from_numpy(get_window(window, win_length).astype(np.float32)).to(env.device)
    ac = autocorrelate(fr * w, max_lag=win_length - 1)
    return ac / torch.clamp_min(ac[..., :1], 1e-10)


def tempo_frequencies(n_lags: int, sample_rate: float, hop: int) -> np.ndarray:
    """BPM corresponding to each autocorrelation lag (host-side; lag 0 maps
    to +inf, suppressed by the prior)."""
    lags = np.arange(n_lags, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return 60.0 * sample_rate / (hop * lags)


def _bpm_prior(bpms: np.ndarray, start_bpm: float, std_bpm: float, max_tempo: float) -> np.ndarray:
    """The log-normal BPM prior of :func:`tempo` (float64, host)."""
    with np.errstate(divide="ignore"):
        prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2)
    prior[0] = 0.0
    prior[bpms > max_tempo] = 0.0
    return prior


def tempo(
    env: torch.Tensor,
    sample_rate: float,
    hop: int,
    start_bpm: float = 120.0,
    std_bpm: float = 1.0,
    max_tempo: float = 320.0,
    ac_size: float = 8.0,
) -> torch.Tensor:
    """Global tempo estimate in BPM, shape ``env.shape[:-1]``: the onset
    envelope's autocorrelation out to ``ac_size`` seconds of lag, weighted
    by a log-normal prior over BPM centered at ``start_bpm`` (width
    ``std_bpm`` octaves), lags faster than ``max_tempo`` zeroed; the best
    lag (the first at a tie)."""
    max_lag = min(int(round(ac_size * sample_rate / hop)), env.shape[-1] - 1)
    ac = autocorrelate(env, max_lag=max_lag)
    bpms = tempo_frequencies(max_lag + 1, sample_rate, hop)
    prior = _bpm_prior(bpms, start_bpm, std_bpm, max_tempo)
    best = torch.argmax(ac * torch.from_numpy(prior.astype(np.float32)).to(env.device), dim=-1)
    lut = bpms.copy()
    lut[0] = start_bpm  # all-zero envelope -> argmax 0 -> sane fallback
    return torch.from_numpy(lut.astype(np.float32)).to(env.device)[best]


@lru_cache(maxsize=16)
def make_online_beat_plan(
    sample_rate: float,
    hop: int,
    start_bpm: float = 120.0,
    std_bpm: float = 1.0,
    max_tempo: float = 320.0,
    max_lag: int = 256,
    ac_seconds: float = 8.0,
    pre: int = 3,
    post: int = 3,
    delta: float = 0.07,
    warmup_seconds: float = 2.0,
) -> "OnlineBeatPlan":
    """Static plan for the causal tracker: the lag prior (the prior of
    :func:`tempo`), the exponential-forgetting factor of an ``ac_seconds``
    autocorrelation window, and the peak and warmup knobs."""
    fr = sample_rate / hop  # envelope frame rate
    bpms = tempo_frequencies(max_lag + 1, sample_rate, hop)
    prior = _bpm_prior(bpms, start_bpm, std_bpm, max_tempo)
    rho = float(np.exp(-1.0 / (ac_seconds * fr)))
    start_period = float(60.0 * fr / start_bpm)
    return OnlineBeatPlan(
        frame_rate=float(fr),
        max_lag=max_lag,
        prior=prior.astype(np.float32),
        rho=rho,
        pre=pre,
        post=post,
        delta=delta,
        warmup=int(round(warmup_seconds * fr)),
        start_period=start_period,
    )


@dataclass(frozen=True, eq=False)
class OnlineBeatPlan:
    frame_rate: float
    max_lag: int
    prior: np.ndarray = field(repr=False)
    rho: float
    pre: int
    post: int
    delta: float
    warmup: int
    start_period: float

    @property
    def latency(self) -> int:
        """Decision lookahead in envelope frames (= the streaming latency)."""
        return self.post


def online_beat_init(plan: OnlineBeatPlan, lead_shape=(), dtype=torch.float32, device=None) -> dict:
    """Zero streaming state (== the offline start-of-signal state). Its
    leaves in sorted-key order are the JAX package's snapshot order."""
    return {
        "ring": torch.zeros((*lead_shape, plan.max_lag + 1), dtype=dtype, device=device),
        "acf": torch.zeros((*lead_shape, plan.max_lag + 1), dtype=dtype, device=device),
        "peak": torch.zeros((*lead_shape, plan.pre + plan.post + 1), dtype=dtype, device=device),
        "emean": torch.zeros(lead_shape, dtype=dtype, device=device),
        "since": torch.full(lead_shape, 1 << 20, dtype=torch.int32, device=device),
        "period": torch.full(lead_shape, plan.start_period, dtype=dtype, device=device),
    }


def online_beat_step(
    plan: OnlineBeatPlan,
    carry: dict,
    env_chunk: torch.Tensor,
    first_index: int = 0,
) -> tuple[dict, tuple[torch.Tensor, torch.Tensor]]:
    """Causal chunk step: onset envelope ``[..., F]`` -> ``(carry,
    (beat [..., F] bool, bpm [..., F]))``.

    Emission at chunk frame ``j`` decides envelope frame ``j - post`` (the
    ``plan.latency``-frame lookahead of the peak test). The offline position
    of chunk frame ``j`` is ``j - first_index``; it gates the warmup, so a
    zeroed upstream preroll never counts toward the warmup clock.
    """
    dtype = env_chunk.dtype
    prior = on_device(plan.prior, env_chunk.device, dtype)
    c = carry
    beats, bpms = [], []
    for j in range(env_chunk.shape[-1]):
        e = env_chunk[..., j]
        ring = torch.cat([e[..., None], c["ring"][..., :-1]], dim=-1)
        acf = plan.rho * c["acf"] + e[..., None] * ring
        best, lag = (acf * prior).max(dim=-1)  # the first maximal lag
        period = torch.where(best > 0.0, lag.to(dtype), c["period"])
        peak = torch.cat([e[..., None], c["peak"][..., :-1]], dim=-1)
        cand = peak[..., plan.post]
        is_peak = torch.logical_and(cand >= peak.amax(dim=-1), cand > c["emean"] + plan.delta)
        emean = 0.95 * c["emean"] + 0.05 * e
        since = torch.clamp_max(c["since"] + 1, 1 << 20)
        sincef = since.to(dtype)
        if (j - first_index) - plan.post >= plan.warmup:  # the offline frame this step decides about
            beat = torch.logical_and(is_peak, sincef >= 0.72 * period)
            forced = torch.logical_and(sincef >= 1.6 * period, best > 0.0)
            beat = torch.logical_or(beat, forced)
        else:
            beat = torch.zeros_like(is_peak)
        since = torch.where(beat, 0, since)
        bpms.append(60.0 * plan.frame_rate / torch.clamp_min(period, 1.0))
        beats.append(beat)
        c = {"ring": ring, "acf": acf, "peak": peak, "emean": emean, "since": since, "period": period}
    return c, (torch.stack(beats, dim=-1), torch.stack(bpms, dim=-1))


def online_beat_track(
    env: torch.Tensor, sample_rate: float, hop: int, **plan_kwargs
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal beat tracker (the online counterpart of :func:`beat_track`): a
    running exponentially-forgotten autocorrelation with the prior of
    :func:`tempo`, a ``pre+post+1``-frame peak window, and a beat clock that
    fires at a peak past 0.72 of the period or forces one at 1.6 periods.
    Returns ``(beat_mask [..., T] bool, bpm_track [..., T])`` aligned to the
    envelope (the trailing ``post`` frames are undecided = False)."""
    plan = make_online_beat_plan(sample_rate, hop, **plan_kwargs)
    carry = online_beat_init(plan, env.shape[:-1], env.dtype, env.device)
    _, (beat, bpm) = online_beat_step(plan, carry, env)
    if plan.post:
        # emission j decides frame j - post: shift left into alignment
        beat = torch.cat([beat[..., plan.post :], torch.zeros_like(beat[..., : plan.post])], dim=-1)
        bpm = torch.cat([bpm[..., plan.post :], bpm[..., -1:].expand(*bpm.shape[:-1], plan.post)], dim=-1)
    return beat, bpm


def _beat_dp(
    env: torch.Tensor, sample_rate: float, hop: int, bpm, tightness: float, max_period: int, start_bpm: float
) -> dict:
    """The DP's forward pass over ``env [B, T]``: the per-lane ``bpm``, the
    blurred envelope ``local [B, T]``, the gap cost ``cost [B, W]`` (the
    window's entry j is frame t - (W - j)), the cumulative ``scores [B, T]``
    and the ``backgaps [B, T]`` (0 at a chain head). A Python loop over
    frames, a few launches each, batched over lanes."""
    t_frames = env.shape[-1]
    if bpm is None:
        bpm = tempo(env, sample_rate, hop, start_bpm=start_bpm)
    bpm = torch.as_tensor(bpm, dtype=torch.float32, device=env.device)
    period = 60.0 * sample_rate / (hop * bpm)
    period = torch.clamp(period, 1.0, max_period)

    # local score: the envelope blurred by a gaussian of sigma = period/32
    kh = int(max_period) // 16
    k = torch.arange(-kh, kh + 1, dtype=torch.float32, device=env.device)
    sigma = period[..., None] / 32.0
    kern = torch.exp(-0.5 * (k / torch.clamp_min(sigma, 1e-3)) ** 2)
    kern = kern / kern.sum(dim=-1, keepdim=True)
    ep = F.pad(env, (kh, kh))
    win = frame(ep, 2 * kh + 1, 1)[..., :t_frames, :]  # [..., T, K]
    local = (win * kern[..., None, :]).sum(dim=-1)

    w = 2 * int(max_period)
    gaps = torch.arange(w, 0, -1, dtype=torch.float32, device=env.device)
    p = period[..., None]
    valid = torch.logical_and(gaps >= p / 2.0, gaps <= 2.0 * p)
    cost = torch.where(valid, -tightness * torch.log(gaps / p) ** 2, -float("inf"))  # [..., W]

    local = local.reshape(-1, t_frames)
    cost = cost.expand(*env.shape[:-1], w).reshape(-1, w)
    b = local.shape[0]
    # cumulative scores: buf[:, W + t] is frame t's; the window of frame t
    # is buf[:, t : t + W], frames t - W .. t - 1. Four launches a frame:
    # each frame's best predecessor and its index are written in place
    buf = torch.full((b, w + t_frames), -float("inf"), device=env.device)
    best = torch.empty((t_frames, b), device=env.device)
    arg = torch.empty((t_frames, b), dtype=torch.int64, device=env.device)
    for t in range(t_frames):
        torch.max(buf[:, t : t + w] + cost, dim=-1, out=(best[t], arg[t]))  # the first maximum
        torch.add(local[:, t], torch.clamp_min(best[t], 0.0), out=buf[:, w + t])
    backgaps = torch.where(best > 0.0, w - arg, 0).T  # 0 = first beat
    return {"bpm": bpm, "local": local, "cost": cost, "scores": buf[:, w:], "backgaps": backgaps}


def _backtrace(scores: torch.Tensor, backgaps: torch.Tensor) -> torch.Tensor:
    """The beat mask ``[B, T]``: from each lane's best final beat along the
    backlinks, one step a beat (a host check per step ends the walk)."""
    b, t_frames = scores.shape
    nxt = torch.argmax(scores, dim=-1)
    rows = torch.arange(b, device=scores.device)
    mask = torch.zeros((b, t_frames), dtype=torch.bool, device=scores.device)
    while True:
        act = nxt >= 0
        if not bool(act.any()):
            return mask
        at = torch.clamp_min(nxt, 0)
        mask[rows, at] |= act
        gap = backgaps[rows, at]
        nxt = torch.where(act & (gap > 0), nxt - gap, -1)


def beat_track(
    env: torch.Tensor,
    sample_rate: float,
    hop: int,
    bpm: torch.Tensor | float | None = None,
    tightness: float = 100.0,
    max_period: int = 256,
    start_bpm: float = 120.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ellis (2007) dynamic-programming beat tracker.

    Returns ``(beat_mask [..., T] bool, bpm [...])``. ``bpm`` may be given
    (a float or per-lane) or is estimated with :func:`tempo`. The target
    beat period in frames is ``p = 60*sr/(hop*bpm)``; the DP rewards onset
    energy at beats and penalizes inter-beat gaps ``g`` by
    ``-tightness * ln(g/p)^2`` over ``g in [p/2, 2p]``, on a Gaussian-blurred
    envelope (sigma = p/32). The recurrence keeps the last
    ``2*max_period`` scores; both passes run on the envelope's device.
    """
    dp = _beat_dp(env, sample_rate, hop, bpm, tightness, max_period, start_bpm)
    return _backtrace(dp["scores"], dp["backgaps"]).reshape(env.shape), dp["bpm"]
