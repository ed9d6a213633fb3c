"""Time-based effects: feedback delay/echo, tremolo, vibrato, chorus, flanger.

Mirrors ``audioflow_tpu/ops/effects.py``:

* the feedback comb ``w[n] = x[n-D] + g*w[n-D]`` has no dependency shorter
  than D samples, so it runs as a host loop over the ``ceil(T/D)`` D-sample
  blocks, each one fused add on a ``[..., D]`` block (the JAX package runs
  the same blocks as a ``lax.scan``). Any chunk length is exact: the tail
  block is computed on zero padding and the carry is cut from the true
  positions.
* LFO-modulated delays (vibrato, chorus, flanger) are one gather with
  linear interpolation from a left-padded history: no recurrence. Phases
  take the absolute sample offset ``t0`` of the chunk, so streamed chunks
  reproduce the offline LFO (the graph nodes wire ``first_index`` into it).
  The LFO phase follows the JAX package's fp32 order of operations.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["feedback_delay", "tremolo", "vibrato", "chorus", "flanger"]


def feedback_delay(
    x: torch.Tensor,
    delay_samples: int,
    feedback: float = 0.4,
    mix: float = 0.5,
    carry: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Echo: ``y = x + mix * w`` with ``w[n] = x[n-D] + g * w[n-D]``.

    ``carry = (x_tail, w_tail)`` holds the last D samples of input and wet
    line (zeros: silence before the signal, the offline convention).
    Returns ``(y, carry')``; any chunk length, and streamed equals offline
    exactly. |feedback| must be < 1 (the comb is unstable otherwise).
    """
    d = int(delay_samples)
    if d < 1:
        raise ValueError(f"delay_samples must be >= 1, got {d}")
    if not -1.0 < feedback < 1.0:
        raise ValueError(f"|feedback| must be < 1, got {feedback}")
    t = x.shape[-1]
    lead = x.shape[:-1]
    if carry is None:
        carry = (x.new_zeros((*lead, d)), x.new_zeros((*lead, d)))
    x_tail, w_tail = carry
    k = -(-t // d)  # blocks covering the chunk
    # xs[i] is x at offset i - d from the chunk start
    xs = torch.cat([x_tail, torch.nn.functional.pad(x, (0, k * d - t))], dim=-1)
    x_blocks = xs[..., : k * d].reshape(*lead, k, d).movedim(-2, 0)  # [K, ..., D], a view
    w_blocks = x.new_empty((k, *lead, d))
    prev = w_tail
    for i in range(k):
        prev = torch.add(x_blocks[i], prev, alpha=feedback, out=w_blocks[i])
    w = w_blocks.movedim(0, -2).reshape(*lead, k * d)[..., :t]
    y = torch.add(x, w, alpha=mix)
    # the carries read the true last D positions (with padding, the tail
    # spans the last real samples of x and w)
    x_new = torch.cat([x_tail, x], dim=-1)[..., -d:]
    w_new = torch.cat([w_tail, w], dim=-1)[..., -d:]
    return y, (x_new, w_new)


def _lfo_delay_samples(
    pos: torch.Tensor, sample_rate: float, rate_hz: float, base_s: float, depth_s: float, phase: float
) -> torch.Tensor:
    """The modulated delay in samples at absolute positions ``pos`` (int),
    in fp32 in the JAX package's order: ``(2 pi rate) * pos / sr + phase``."""
    arg = 2.0 * np.pi * rate_hz * pos.to(torch.float32) / sample_rate + phase
    lfo = 0.5 * (1.0 + torch.sin(arg))
    return (base_s + depth_s * lfo) * sample_rate


def history_len(sample_rate: float, base_s: float, depth_s: float) -> int:
    """Dmax: the samples a modulated tap reads before its chunk (its
    longest delay, rounded up, and one for the interpolation)."""
    return int(math.ceil((base_s + depth_s) * sample_rate)) + 1


def _modulated_tap(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz: float,
    base_s: float,
    depth_s: float,
    phase: float,
    t0: int,
    history: torch.Tensor | None,
) -> torch.Tensor:
    """One modulated fractional-delay read ``tap[n] = x[n - d(n)]`` (linear
    interpolation). ``history`` is the last Dmax samples before the chunk
    (zeros offline); ``t0`` is the absolute offset of sample 0. The read
    positions are chunk-local and clipped into the padded chunk, as in the
    JAX package."""
    t = x.shape[-1]
    dmax = history_len(sample_rate, base_s, depth_s)
    if history is None:
        history = x.new_zeros((*x.shape[:-1], dmax))
    elif history.shape[-1] != dmax:
        raise ValueError(f"history must be the last {dmax} samples, got {history.shape[-1]}")
    xp = torch.cat([history, x], dim=-1)  # index n + dmax is x[n]
    n = torch.arange(t, device=x.device, dtype=torch.int32)
    d = _lfo_delay_samples(n + t0, sample_rate, rate_hz, base_s, depth_s, phase)
    idx = (n + dmax) - d  # the fractional read position in xp
    lo = torch.clamp(torch.floor(idx).to(torch.int64), 0, xp.shape[-1] - 1)
    hi = torch.clamp(lo + 1, 0, xp.shape[-1] - 1)
    frac = (idx - lo.to(idx.dtype)).to(x.dtype)
    return xp.index_select(-1, lo) * (1.0 - frac) + xp.index_select(-1, hi) * frac


def tremolo(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz: float = 5.0,
    depth: float = 0.5,
    phase: float = 0.0,
    t0: int = 0,
) -> torch.Tensor:
    """Amplitude LFO: ``y = x * (1 - depth/2 * (1 + sin(2 pi f t + phase)))``,
    the gain sweeping [1 - depth, 1]. ``t0`` is the absolute sample offset
    of ``x[0]`` (streamed chunks pass their position; 0 offline)."""
    if not 0.0 <= depth <= 1.0:
        raise ValueError(f"depth must be in [0, 1], got {depth}")
    pos = (torch.arange(x.shape[-1], device=x.device, dtype=torch.int32) + t0).to(torch.float32)
    gain = 1.0 - 0.5 * depth * (1.0 + torch.sin(2.0 * np.pi * rate_hz * pos / sample_rate + phase))
    return x * gain


def vibrato(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz: float = 5.0,
    depth_s: float = 0.002,
    phase: float = 0.0,
    t0: int = 0,
    history: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pitch LFO: read ``x[n - d(n)]`` with ``d`` sweeping [0, depth_s]."""
    return _modulated_tap(x, sample_rate, rate_hz, 0.0, depth_s, phase, t0, history)


def chorus(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz: float = 0.8,
    depth_s: float = 0.003,
    base_delay_s: float = 0.02,
    voices: int = 3,
    mix: float = 0.5,
    t0: int = 0,
    history: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ensemble: ``voices`` modulated taps at phase offsets ``2 pi k /
    voices`` around a ~20 ms base delay, averaged and mixed:
    ``y = (1 - mix) x + mix * mean(taps)``."""
    if voices < 1:
        raise ValueError(f"voices must be >= 1, got {voices}")
    wet = _modulated_tap(x, sample_rate, rate_hz, base_delay_s, depth_s, 0.0, t0, history)
    for k in range(1, voices):
        wet = wet + _modulated_tap(
            x, sample_rate, rate_hz, base_delay_s, depth_s, 2.0 * np.pi * k / voices, t0, history
        )
    return (1.0 - mix) * x + mix * (wet / voices)


def flanger(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz: float = 0.25,
    depth_s: float = 0.002,
    base_delay_s: float = 0.001,
    mix: float = 0.5,
    t0: int = 0,
    history: torch.Tensor | None = None,
) -> torch.Tensor:
    """Swept comb: one short modulated tap mixed with the dry signal,
    ``y = (1 - mix) x + mix * x[n - d(n)]`` with d sweeping about 1-3 ms
    (feedback-free, the JAX package's convention)."""
    tap = _modulated_tap(x, sample_rate, rate_hz, base_delay_s, depth_s, 0.0, t0, history)
    return (1.0 - mix) * x + mix * tap
