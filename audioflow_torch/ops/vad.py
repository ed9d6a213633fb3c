"""Energy voice-activity detection, serial over frames.

Mirrors ``audioflow_tpu/ops/vad.py``, the reference's 3-state VAD with its
quirks kept: the "RMS" energy is the mean of squares with no sqrt; dBFS is
``20·log10`` of it, -inf for <= 0; the EMA ``s <- a·e + (1-a)·s`` drives
detection, unless ``a == 0``, when the raw energy does; the states run
Silence(0) -> Speech(1) -> Ending(2), Ending lasts one frame, speech
shorter than ``min_speech_frames`` is dropped; each frame reports its state
after the update.

The JAX package runs one ``lax.scan`` over frames. Here the scan is a
Python loop over frames, every leading axis carried along in each step: the
energies, and after the smoothing loop the dBFS and the speech flags, are
computed for all frames at once, so only the EMA (three launches a frame)
and the state machine (about twenty) run per frame. The EMA stays a serial
recurrence rounded to fp32 each frame, as XLA's scan computes it: a closed
form would round otherwise and flip states near the threshold. XLA on the
CPU contracts ``a·e + (1-a)·s`` into one fused multiply-add over the fp32
``(1-a)·s``; the port forms ``a·e`` exactly in float64 and rounds the sum to
fp32 once, which equals the fused form except where the float64 sum lands
on an fp32 halfway point.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .dynamics import energy_to_dbfs, mean_square_energy

SILENCE, SPEECH, ENDING = 0, 1, 2


@dataclass(frozen=True)
class VadConfig:
    """Defaults of the reference: -50 dB, a = 0.3, 15 frames (about 300 ms), 3 frames."""

    threshold_db: float = -50.0
    smoothing_factor: float = 0.3
    silence_timeout_frames: int = 15
    min_speech_frames: int = 3


# named sensitivity presets, the JAX package's meanings of the reference's levels
VAD_LEVELS = {
    "aggressive": VadConfig(threshold_db=-55.0),
    "balanced": VadConfig(threshold_db=-50.0),
    "relaxed": VadConfig(threshold_db=-40.0),
}


class VadCarry(NamedTuple):
    smoothed: torch.Tensor  # f32 [...]
    silence_frames: torch.Tensor  # i32 [...]
    speech_frames: torch.Tensor  # i32 [...]
    state: torch.Tensor  # i32 [...] in {0, 1, 2}


def vad_init(lead_shape: tuple = (), dtype: torch.dtype = torch.float32, device=None) -> VadCarry:
    z = torch.zeros(lead_shape, dtype=dtype, device=device)
    zi = torch.zeros(lead_shape, dtype=torch.int32, device=device)
    return VadCarry(z, zi, zi, zi)


def _coefficients(cfg: VadConfig) -> tuple[float, float]:
    """``a`` and ``1 - a`` rounded to fp32 as the JAX package forms them
    (``1.0 - alpha`` on an fp32 alpha), as Python floats that hold them exactly."""
    a = np.float32(cfg.smoothing_factor)
    return float(a), float(np.float32(1.0) - a)


def _smooth(a_energy: torch.Tensor, oma: float, smoothed: torch.Tensor) -> torch.Tensor:
    """``a·e + (1-a)·s`` rounded once: ``a_energy`` is ``a·e`` in float64 (exact)."""
    return (a_energy + oma * smoothed).to(smoothed.dtype)


def _transition(cfg: VadConfig, carry: VadCarry, smoothed: torch.Tensor, is_speech: torch.Tensor) -> VadCarry:
    """One frame of the state machine given its speech flag."""
    st, sil, spc = carry.state, carry.silence_frames, carry.speech_frames
    speech = is_speech.to(torch.int32)
    zero = torch.zeros_like(st)
    # silence: speech starts a run
    sil_speech = torch.where(is_speech, 1, spc)
    sil_silence = torch.where(is_speech, zero, sil)
    # speech: count on, or time out into Ending (long enough) or Silence
    sp_speech_ct = spc + speech
    sp_silence_ct = torch.where(is_speech, zero, sil + 1)
    timeout = (sp_silence_ct >= cfg.silence_timeout_frames) & ~is_speech
    sp_state = torch.where(
        timeout, torch.where(spc >= cfg.min_speech_frames, ENDING, SILENCE), SPEECH
    ).to(torch.int32)
    sp_speech_ct = torch.where(timeout, zero, sp_speech_ct)
    # ending: back to silence whatever the frame holds
    in_sil, in_spc = st == SILENCE, st == SPEECH
    return VadCarry(
        smoothed,
        torch.where(in_sil, sil_silence, torch.where(in_spc, sp_silence_ct, zero)),
        torch.where(in_sil, sil_speech, torch.where(in_spc, sp_speech_ct, spc)).to(torch.int32),
        torch.where(in_sil, speech, torch.where(in_spc, sp_state, zero)),
    )


def vad_step(cfg: VadConfig, carry: VadCarry, energy: torch.Tensor) -> tuple[VadCarry, torch.Tensor]:
    """One frame given its mean-square energy; returns the new carry and state."""
    a, oma = _coefficients(cfg)
    smoothed = _smooth(a * energy.double(), oma, carry.smoothed)
    detection = smoothed if cfg.smoothing_factor > 0.0 else energy
    new = _transition(cfg, carry, smoothed, energy_to_dbfs(detection) > cfg.threshold_db)
    return new, new.state


def vad_scan(
    frames: torch.Tensor, cfg: VadConfig = VadConfig(), carry: VadCarry | None = None
) -> tuple[VadCarry, torch.Tensor]:
    """VAD over ``frames [..., n_frames, frame_len]``.

    Returns the carry ``[...]`` and the states ``[..., n_frames]`` (int32).
    The loop runs over frames; every leading axis rides along.
    """
    energies = mean_square_energy(frames, axis=-1)  # [..., n]
    n = energies.shape[-1]
    if carry is None:
        carry = vad_init(energies.shape[:-1], energies.dtype, energies.device)
    if n == 0:
        return carry, torch.zeros(energies.shape, dtype=torch.int32, device=energies.device)
    a, oma = _coefficients(cfg)
    a_energies = a * energies.double()
    sm = carry.smoothed
    smoothed = []
    for i in range(n):
        sm = _smooth(a_energies[..., i], oma, sm)
        smoothed.append(sm)
    smoothed_all = torch.stack(smoothed, dim=-1)
    detection = smoothed_all if cfg.smoothing_factor > 0.0 else energies
    is_speech = energy_to_dbfs(detection) > cfg.threshold_db
    states = []
    for i in range(n):
        carry = _transition(cfg, carry, smoothed[i], is_speech[..., i])
        states.append(carry.state)
    return carry, torch.stack(states, dim=-1)


def vad_energy_db(carry: VadCarry) -> torch.Tensor:
    """Current smoothed energy in dB."""
    return energy_to_dbfs(carry.smoothed)


def is_speaking(carry: VadCarry) -> torch.Tensor:
    return carry.state == SPEECH
