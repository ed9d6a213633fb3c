"""Seeded inputs: the recipes a traffic file names, and the WAV files of a corpus.

The same seed gives the same inputs, and every seed gives the same sizes:
the seed moves where the tones and the bursts fall, never how much work
there is. ``seed`` may be any whole number; it is taken modulo 2**63.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

_ROWS_A_CALL = 64  # rows generated per call on the card, to bound the float64 phase


def _seed(seed: int, stream: int = 0) -> int:
    return (int(seed) * 1_000_003 + stream) % 2**63


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of draws of a run with ``seed``."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def tones(rows: int, n: int, rate: int, seed: int, device, p: dict) -> torch.Tensor:
    """``[rows, n]`` float32 on ``device``: per row one tone of a frequency
    drawn from ``[f_lo, f_hi]`` at amplitude ``amp``, plus white noise of
    standard deviation ``noise``. Made on the device with its own generator."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed))
    freqs = torch.empty(rows, 1, dtype=torch.float64, device=device).uniform_(p["f_lo"], p["f_hi"], generator=g)
    t = torch.arange(n, dtype=torch.float64, device=device) / rate
    out = torch.empty(rows, n, dtype=torch.float32, device=device)
    for i in range(0, rows, _ROWS_A_CALL):
        cycles = torch.remainder(freqs[i : i + _ROWS_A_CALL] * t, 1.0)
        out[i : i + _ROWS_A_CALL] = (p["amp"] * torch.sin(2 * torch.pi * cycles)).to(torch.float32)
    out += p["noise"] * torch.randn(rows, n, dtype=torch.float32, device=device, generator=g)
    return out


def speech(rows: int, n: int, rate: int, seed: int, device, p: dict) -> torch.Tensor:
    """``[rows, n]`` float32 on ``device``, speech-like: per row a noise
    floor at ``floor_db`` dBFS, and after a lead of ``lead_s`` seconds,
    bursts of ``burst_s`` seconds (a tone from ``tone_hz`` at ``amp`` plus
    noise of ``noise``) between silences of ``gap_s`` seconds, each length
    drawn uniformly from its range. Made on the device with its own generator."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, 1))
    k = int(n / (rate * (p["burst_s"][0] + p["gap_s"][0]))) + 2

    def draw(lo_hi, shape):
        return torch.empty(shape, dtype=torch.float64, device=device).uniform_(*lo_hi, generator=g)

    lead = (draw(p["lead_s"], (rows, 1)) * rate).long()
    burst = (draw(p["burst_s"], (rows, k)) * rate).long()
    gap = (draw(p["gap_s"], (rows, k)) * rate).long()
    freq = draw(p["tone_hz"], (rows, k))
    starts = (lead + torch.cumsum(burst + gap, dim=1) - (burst + gap)).contiguous()
    out = torch.empty(rows, n, dtype=torch.float32, device=device)
    bursts = torch.empty(rows, n, dtype=torch.bool, device=device)
    pos = torch.arange(n, device=device)
    for i in range(0, rows, _ROWS_A_CALL):
        st, bu, fr = starts[i : i + _ROWS_A_CALL], burst[i : i + _ROWS_A_CALL], freq[i : i + _ROWS_A_CALL]
        at = pos.expand(st.shape[0], n).contiguous()
        j = (torch.searchsorted(st, at, right=True) - 1).clamp_min(0)
        since = at - torch.gather(st, 1, j)
        inside = (since >= 0) & (since < torch.gather(bu, 1, j))
        cycles = torch.remainder(torch.gather(fr, 1, j) * since / rate, 1.0)
        out[i : i + _ROWS_A_CALL] = torch.where(inside, p["amp"] * torch.sin(2 * torch.pi * cycles), 0.0).float()
        bursts[i : i + _ROWS_A_CALL] = inside
    floor = 10 ** (p["floor_db"] / 20)
    noise = torch.randn(rows, n, dtype=torch.float32, device=device, generator=g)
    out += torch.where(bursts, p["noise"], floor) * noise
    return out


def make(kind: dict, rows: int, n: int, rate: int, seed: int, device) -> torch.Tensor:
    """The recipe a traffic file's ``signal`` names, made on ``device``."""
    if kind["recipe"] == "tones":
        return tones(rows, n, rate, seed, device, kind)
    if kind["recipe"] == "speech":
        return speech(rows, n, rate, seed, device, kind)
    raise ValueError(f"unknown signal recipe {kind['recipe']!r}; known: tones, speech")


def to_pcm16(x: torch.Tensor) -> np.ndarray:
    """float samples as 16-bit PCM on the host: rounded, clamped."""
    return torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(torch.int16).cpu().numpy()


def write_wav(path: Path, pcm: np.ndarray, rate: int) -> None:
    """A mono 16-bit PCM WAV file of ``pcm``."""
    data = np.ascontiguousarray(pcm, dtype="<i2").tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, 2 * rate, 2, 16)
    header += b"data" + struct.pack("<I", len(data))
    Path(path).write_bytes(header + data)
