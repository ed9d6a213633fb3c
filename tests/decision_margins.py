"""Decision margins of the CQT's hybrid inverse and of the rhythm trackers,
for tests that compare outputs reached through discrete decisions (across
the two packages, or the card and the CPU). Each helper asserts that every
decision that can reach the output is clear of the compared sides' fp32
differences, and returns the smallest margins. Imports no JAX, so that the
card tests use it too.

Margins: CQT magnitudes by ``MAG_MARGIN`` of the frame set's peak (the
sides compute them with the same operations, up to one rounding); the
hybrid's candidate scores by ``SCORE_MARGIN`` (logs, sincs and arctangents
from two libraries, a few ulps apart on terms of order 1-10); envelope
comparisons by ``ENV_MARGIN``; weighted autocorrelations by ``LAG_MARGIN``
of the best; the beat DP's scores (sums of envelope values and log-gap
costs of order 1-100) by ``DP_MARGIN``.
"""

import math

import numpy as np
import torch

from audioflow_torch.ops import cqt_mod as tcqt
from audioflow_torch.ops import rhythm as trhythm
from audioflow_torch.ops.cqt import FMIN_C1

RATE = 16000
HOP = 256
MAG_MARGIN = 1e-6
SCORE_MARGIN = 1e-4
ENV_MARGIN = 1e-5
LAG_MARGIN = 1e-5
DP_MARGIN = 1e-3


def hybrid_decisions_clear(c: torch.Tensor, sample_rate=RATE, hop=256, n_bins=84, fmin=FMIN_C1) -> dict:
    """Asserts that every discrete decision of the hybrid inverse that can
    reach its output is clear of the two packages' fp32 differences on the
    complex coefficients ``c`` (see the module docstring); returns the
    smallest margins. A bin is synthesized only if its three peak tests
    (above the left neighbour, at least the right one, above the magnitude
    floor) and the score gate all pass, so each test's margin is checked
    where the other tests may pass."""
    dz = tcqt._hybrid_design(sample_rate, hop, n_bins, fmin, 12, "hann", 1.0)
    est = tcqt._sin_estimates(c.real, c.imag, dz, sample_rate, hop)
    mag = (est["mag"] / est["gmax"]).double()
    k = dz["k_min"]
    pad = torch.full_like(mag[..., :1], -1.0)
    padm = torch.cat([pad, mag, pad], dim=-1)
    tests = torch.stack([mag - padm[..., :-2], mag - padm[..., 2:], mag - 1e-3])[..., k:]  # [3, .., T, K - k]
    s_best = est["s_best"][..., k:].double()
    maybe_peak = (tests > -MAG_MARGIN).all(dim=0)
    maybe_gated = s_best < 0.5 + SCORE_MARGIN
    unclear = tests.abs().amin(dim=0)[maybe_peak & maybe_gated]
    margins = {"peak": float(unclear.min()) if unclear.numel() else math.inf}
    gate = (s_best - 0.5).abs()[maybe_peak]
    margins["gate"] = float(gate.min()) if gate.numel() else math.inf
    scores = est["score"][..., k:, :][maybe_peak & maybe_gated].double().sort(dim=-1).values
    margins["argmin"] = float((scores[:, 1] - scores[:, 0]).min()) if scores.numel() else math.inf
    margins["components"] = int((est["wgt"] > 0).sum(dim=-1).max())
    assert margins["peak"] > MAG_MARGIN, margins
    assert margins["gate"] > SCORE_MARGIN and margins["argmin"] > SCORE_MARGIN, margins
    assert margins["components"] <= 16, margins  # the top-16 cut selects every component
    return margins


def tempo_margin(env: torch.Tensor, sample_rate=RATE, hop=HOP, start_bpm=120.0) -> float:
    """The smallest relative gap between the best and the second best
    prior-weighted autocorrelation lag of :func:`tempo`, over the lanes."""
    max_lag = min(int(round(8.0 * sample_rate / hop)), env.shape[-1] - 1)
    ac = trhythm.autocorrelate(env, max_lag=max_lag).double()
    prior = trhythm._bpm_prior(trhythm.tempo_frequencies(max_lag + 1, sample_rate, hop), start_bpm, 1.0, 320.0)
    s = (ac * torch.from_numpy(prior.astype(np.float32)).to(ac.device).double()).sort(dim=-1).values
    return float(((s[..., -1] - s[..., -2]) / s[..., -1]).min())


def dp_margins_clear(env: torch.Tensor) -> dict:
    """Asserts that the DP's decisions that reach its output are clear of
    fp32 differences on ``env [B, T]``: the tempo's best lag, each lane's
    best final beat, and at every beat the best predecessor (over the second
    best) and its sign. Elsewhere a near tie moves a score continuously, by
    less than the tie's gap, and marks nothing."""
    margins = {"tempo": tempo_margin(env)}
    dp = trhythm._beat_dp(env, RATE, HOP, None, 100.0, 256, 120.0)
    mask = trhythm._backtrace(dp["scores"], dp["backgaps"])
    scores, cost = dp["scores"].double(), dp["cost"].double()
    w = cost.shape[-1]
    buf = torch.cat([scores.new_full((scores.shape[0], w), -np.inf), scores[:, :-1]], dim=-1)
    prev = buf.unfold(-1, w, 1) + cost[:, None, :]  # [B, T, W]
    top = prev.sort(dim=-1).values[..., -2:][mask]  # [beats, 2]
    finite = torch.isfinite(top[:, 1])
    gap = (top[:, 1] - top[:, 0])[finite & torch.isfinite(top[:, 0])]
    margins["predecessor"] = float(gap.min()) if gap.numel() else np.inf
    margins["sign"] = float(top[:, 1][finite].abs().min()) if finite.any() else np.inf
    last = scores.sort(dim=-1).values[:, -2:]
    margins["last"] = float((last[:, 1] - last[:, 0]).min())
    margins["beats"] = int(mask.sum())
    assert margins["tempo"] > LAG_MARGIN, margins
    assert min(margins["predecessor"], margins["sign"], margins["last"]) > DP_MARGIN, margins
    return margins


def online_margins_clear(env: np.ndarray, env_diff: float = 0.0, **plan_kwargs) -> dict:
    """Asserts that the causal tracker's decisions on ``env [B, T]`` are
    clear of fp32 differences, from a float64 run of its state: the peak
    test's two halves where the other half holds (the decided frame against
    its window's runner-up, and against ``emean + delta``), and the best
    weighted lag over the second best where it is positive. ``env_diff`` is
    the largest difference between the envelopes the sides compared see."""
    plan = trhythm.make_online_beat_plan(RATE, HOP, **plan_kwargs)
    b, n = env.shape
    e64 = env.astype(np.float64)
    acf = np.zeros((b, plan.max_lag + 1))
    ring = np.zeros_like(acf)
    win = np.zeros((b, plan.pre + plan.post + 1))
    emean = np.zeros(b)
    prior = plan.prior.astype(np.float64)
    m_mean = m_lag = m_peak = np.inf
    slack = ENV_MARGIN + 2 * env_diff
    for t in range(n):
        e = e64[:, t]
        ring = np.concatenate([e[:, None], ring[:, :-1]], 1)
        acf = plan.rho * acf + e[:, None] * ring
        s = np.sort(acf * prior, axis=-1)
        live = s[:, -1] > 0
        if live.any():
            m_lag = min(m_lag, float(((s[live, -1] - s[live, -2]) / s[live, -1]).min()))
        win = np.concatenate([e[:, None], win[:, :-1]], 1)
        cand = win[:, plan.post]
        over = cand - (emean + plan.delta)
        runner = cand - np.delete(win, plan.post, axis=1).max(axis=1)
        if (over > -slack).any():
            m_peak = min(m_peak, float(np.abs(runner[over > -slack]).min()))
        if (runner > -slack).any():
            m_mean = min(m_mean, float(np.abs(over[runner > -slack]).min()))
        emean = 0.95 * emean + 0.05 * e
    margins = {"mean": m_mean, "lag": m_lag, "peak": m_peak}
    assert min(m_mean, m_peak) > slack, margins
    assert m_lag > LAG_MARGIN + 4 * env_diff, margins
    return margins
