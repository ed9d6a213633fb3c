"""Gain, normalization, limiter, and channel ops.

Mirrors ``audioflow_tpu/ops/dynamics.py``: elementwise and reduction work in
plain torch. The limiter's envelope follower, a sequential recurrence, is a
running max in the log domain (``torch.cummax``), as in the JAX package; see
:func:`envelope_peak_release`. The AGC's gain recurrence is nonlinear, so it
stays a loop over control blocks, with each block's level taken in one
reduction before it and the gain ramps applied in one pass after it.
"""

from __future__ import annotations

import numpy as np
import torch


def gain_db(x: torch.Tensor, db: float | torch.Tensor) -> torch.Tensor:
    return x * torch.pow(10.0, torch.as_tensor(db, dtype=x.dtype, device=x.device) / 20.0)


def to_mono(x: torch.Tensor, channels: int) -> torch.Tensor:
    """Average interleaved channels (the reference's AudioFrame::to_mono).

    Summed in channel order and scaled by the reciprocal, the order of the
    JAX package's mean on the CPU, so the two agree bit for bit."""
    if channels == 1:
        return x
    t = x.shape[-1] // channels * channels
    frames = x[..., :t].reshape(*x.shape[:-1], -1, channels)
    acc = frames[..., 0]
    for c in range(1, channels):
        acc = acc + frames[..., c]
    return acc * (1.0 / channels)


def peak_normalize(x: torch.Tensor, target_peak: float = 1.0, eps: float = 1e-9) -> torch.Tensor:
    peak = x.abs().amax(dim=-1, keepdim=True)
    return x * (target_peak / torch.clamp_min(peak, eps))


def rms_normalize(x: torch.Tensor, target_db: float = -20.0, eps: float = 1e-12) -> torch.Tensor:
    """Scale so RMS (true root-mean-square) hits ``target_db`` dBFS."""
    rms = torch.sqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    target = 10.0 ** (target_db / 20.0)
    return x * (target / torch.clamp_min(rms, eps))


def mean_square_energy(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The reference's 'RMS' energy: mean of squares, *no sqrt*."""
    return (x * x).mean(dim=axis)


def energy_to_dbfs(energy: torch.Tensor) -> torch.Tensor:
    """20*log10(mean-square), -inf for <= 0."""
    db = 20.0 * torch.log10(torch.clamp_min(energy, 1e-38))
    return torch.where(energy > 0.0, db, -torch.inf)


def envelope_peak_release(x_abs: torch.Tensor, release_coeff: float) -> torch.Tensor:
    """Instant-attack / exponential-release peak envelope.

    Serial form: ``e[n] = max(|x[n]|, r * e[n-1])``. Because
    ``e[n] = max_k |x[k]| * r^(n-k)``, in log space this is a running max of
    ``log|x[k]| - k*log(r)``: one ``cummax`` along the last axis.
    """
    if not (0.0 < release_coeff < 1.0):
        raise ValueError("release_coeff must be in (0, 1)")
    log_r = float(np.log(release_coeff))
    t = x_abs.shape[-1]
    ramp = torch.arange(t, dtype=x_abs.dtype, device=x_abs.device) * (-log_r)
    lx = torch.log(torch.clamp_min(x_abs, 1e-30)) + ramp
    running = torch.cummax(lx, dim=-1).values
    return torch.exp(running - ramp)


def limiter(
    x: torch.Tensor,
    threshold_db: float = -1.0,
    release_ms: float = 50.0,
    sample_rate: int = 16000,
) -> torch.Tensor:
    """Hard peak limiter: gain = min(1, T/envelope), envelope as above."""
    r = float(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate)))
    return x * limiter_gain(envelope_peak_release(x.abs(), r), threshold_db)


def limiter_gain(env: torch.Tensor, threshold_db: float) -> torch.Tensor:
    """Linear gain ``min(1, T/envelope)``; shared by the op and the node."""
    thresh = 10.0 ** (threshold_db / 20.0)
    return torch.clamp_max(thresh / torch.clamp_min(env, 1e-30), 1.0)


def compressor_gain(
    env: torch.Tensor, threshold_db: float, ratio: float, knee_db: float = 0.0
) -> torch.Tensor:
    """Linear gain for a peak envelope under a downward compressor curve
    (hard or quadratic soft knee). Shared by the offline op and the
    streaming node so the two can never diverge."""
    level_db = 20.0 * torch.log10(torch.clamp_min(env, 1e-30))
    over = level_db - threshold_db
    if knee_db > 0.0:
        soft = torch.square(torch.clamp(over + knee_db / 2, 0.0, knee_db)) / (2.0 * knee_db)
        over = torch.where(over > knee_db / 2, over, soft)
    else:
        over = torch.clamp_min(over, 0.0)
    gain_reduction_db = over * (1.0 / ratio - 1.0)
    return torch.pow(10.0, gain_reduction_db / 20.0)


def compressor(
    x: torch.Tensor,
    threshold_db: float = -20.0,
    ratio: float = 4.0,
    release_ms: float = 100.0,
    sample_rate: int = 16000,
    knee_db: float = 0.0,
) -> torch.Tensor:
    """Downward compressor with the same log-domain envelope follower."""
    r = float(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate)))
    env = envelope_peak_release(x.abs(), r)
    return x * compressor_gain(env, threshold_db, ratio, knee_db)


def noise_gate(
    x: torch.Tensor,
    threshold_db: float = -60.0,
    release_ms: float = 100.0,
    sample_rate: int = 16000,
    floor_db: float = -80.0,
) -> torch.Tensor:
    """Downward expander/gate: attenuate by ``floor_db`` below threshold.

    Gate decisions follow the same instant-attack/exponential-release peak
    envelope as the limiter/compressor, so brief gaps shorter than the
    release stay open (no chatter)."""
    r = float(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate)))
    env = envelope_peak_release(x.abs(), r)
    return x * gate_gain(env, threshold_db, floor_db)


def gate_gain(env: torch.Tensor, threshold_db: float, floor_db: float = -80.0) -> torch.Tensor:
    """Linear gain for a peak envelope under a hard noise gate."""
    thresh = 10.0 ** (threshold_db / 20.0)
    floor = 10.0 ** (floor_db / 20.0)
    return torch.where(env >= thresh, 1.0, floor).to(env.dtype)


def agc(
    x: torch.Tensor,
    target_db: float = -20.0,
    block: int = 1024,
    max_gain_db: float = 30.0,
    up_db_per_s: float = 6.0,
    down_db_per_s: float = 60.0,
    sample_rate: int = 16000,
    floor_db: float = -55.0,
    gain0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Automatic gain control (slow leveler): track block RMS toward
    ``target_db`` with asymmetric slew limits (fast down to duck sudden
    loudness, slow up so pauses don't pump the noise floor).

    The gain recurrence is nonlinear (clip of a log-domain error), so it
    runs one step per ``block`` samples (64 Hz at the defaults) over
    ``lead``-shaped gains; every block's level comes from one reduction
    first. Blocks whose level is below ``floor_db`` hold the gain (silence
    must not trigger gain-up). Within a block the gain ramps linearly in dB
    to the new value (no zipper noise), all blocks in one pass. Returns
    ``(y, final_gain_db)``; ``gain0`` (dB, shape ``lead``) is the streaming
    carry. Trailing samples beyond the last full block pass at the final
    gain.
    """
    if block < 1:
        raise ValueError("block must be >= 1")
    lead = x.shape[:-1]
    t = x.shape[-1]
    n_blk = t // block
    if gain0 is None:
        g0 = x.new_zeros(lead)
    else:
        g0 = torch.as_tensor(gain0, dtype=x.dtype, device=x.device).expand(lead)
    up = up_db_per_s * block / sample_rate
    down = down_db_per_s * block / sample_rate

    if n_blk == 0:
        return x * torch.pow(10.0, g0[..., None] / 20.0), g0

    blocks = x[..., : n_blk * block].reshape(*lead, n_blk, block)
    rms_db = 10.0 * torch.log10((blocks * blocks).mean(dim=-1) + 1e-12)  # [..., n_blk]
    g = g0
    starts, ends = [], []
    for k in range(n_blk):
        level = rms_db[..., k]
        err = target_db - (level + g)  # dB still needed after current gain
        delta = torch.clamp(err, -down, up)
        g_new = torch.clamp(g + delta, 0.0 - max_gain_db, max_gain_db)
        g_new = torch.where(level > floor_db, g_new, g)  # hold on silence
        starts.append(g)
        ends.append(g_new)
        g = g_new
    g_start, g_end = torch.stack(starts, dim=-1), torch.stack(ends, dim=-1)
    # linear-in-dB ramp from each block's start gain to its end gain
    ramp = torch.arange(1, block + 1, dtype=x.dtype, device=x.device) / block
    gains_db = g_start[..., None] + (g_end - g_start)[..., None] * ramp
    y = (blocks * torch.pow(10.0, gains_db / 20.0)).reshape(*lead, n_blk * block)
    if t > n_blk * block:
        y = torch.cat([y, x[..., n_blk * block :] * torch.pow(10.0, g[..., None] / 20.0)], dim=-1)
    return y, g


def preemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """First-order high-pass FIR y[n] = x[n] - coeff*x[n-1] (ASR-standard).

    Kaldi convention: y[0] = x[0] - coeff*x[0].
    """
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    return x - coeff * prev


def cmvn(feats: torch.Tensor, norm_var: bool = False, eps: float = 1e-8) -> torch.Tensor:
    """Cepstral mean (and optional variance) normalization over the time axis.

    feats [..., T, F]; per-utterance statistics (offline whole-signal op).
    """
    mean = feats.mean(dim=-2, keepdim=True)
    out = feats - mean
    if norm_var:
        var = feats.var(dim=-2, keepdim=True, correction=0)
        out = out / torch.sqrt(var + eps)
    return out


def deemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """One-pole inverse of :func:`preemphasis`: y[n] = x[n] + coeff*y[n-1].

    Runs through the blocked state-space IIR engine (ops/biquad.py), no
    per-sample loop. Round-trip note: preemphasis' Kaldi edge convention
    (y[0] = (1-k)x[0]) is not exactly invertible at the first sample; the
    deviation decays as coeff^n.
    """
    from .biquad import Biquad, biquad_chain

    y, _ = biquad_chain(x, (Biquad(1.0, 0.0, 0.0, -float(coeff), 0.0),))
    return y


def trim_silence(
    x: torch.Tensor,
    top_db: float = 60.0,
    frame_length: int = 2048,
    hop: int = 512,
) -> tuple[torch.Tensor, tuple[int, int]]:
    """Trim leading/trailing silence from a 1-D signal.

    A frame is silent when its RMS is more than ``top_db`` below the
    signal's peak RMS. Returns ``(x[start:end], (start, end))`` in samples.
    The output length is data-dependent, so the boundary decision runs on
    the host over one device-computed [frames] mask.
    """
    mask = _nonsilent_mask(x, top_db, frame_length, hop).cpu().numpy()
    t = x.shape[-1]
    if not mask.any():
        return x[..., :0], (0, 0)
    idx = np.where(mask)[0]
    start = int(idx[0]) * hop
    end = min(int(idx[-1]) * hop + frame_length, t)
    return x[..., start:end], (start, end)


def split_silence(
    x: torch.Tensor,
    top_db: float = 60.0,
    frame_length: int = 2048,
    hop: int = 512,
) -> list[tuple[int, int]]:
    """Sample intervals of non-silent runs (same criterion as
    :func:`trim_silence`); host-side boundary extraction."""
    mask = _nonsilent_mask(x, top_db, frame_length, hop).cpu().numpy()
    t = x.shape[-1]
    out: list[tuple[int, int]] = []
    start = None
    for i, m in enumerate(mask):
        if m and start is None:
            start = i
        elif not m and start is not None:
            out.append((start * hop, min(i * hop + frame_length, t)))
            start = None
    if start is not None:
        out.append((start * hop, t))
    return out


def _nonsilent_mask(x: torch.Tensor, top_db: float, frame_length: int, hop: int) -> torch.Tensor:
    """Per-frame bool: within top_db of the peak frame RMS (on x's device)."""
    from .framing import frame as _frame

    if x.ndim != 1:
        raise ValueError(f"trim/split operate on 1-D signals, got {tuple(x.shape)}")
    if x.shape[-1] < frame_length:
        x = torch.nn.functional.pad(x, (0, frame_length - x.shape[-1]))
    fr = _frame(x, frame_length, hop)
    rms_db = 10.0 * torch.log10(torch.clamp_min((fr * fr).mean(dim=-1), 1e-20))
    return rms_db > rms_db.max() - top_db
