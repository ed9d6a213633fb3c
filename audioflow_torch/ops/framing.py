"""Framing: overlapping windows of a signal along its last axis."""

from __future__ import annotations

import torch


def num_frames(n_samples: int, frame_length: int, hop: int) -> int:
    """Number of full frames that fit (no partial tail frame)."""
    if n_samples < frame_length:
        return 0
    return 1 + (n_samples - frame_length) // hop


def frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice ``x[..., T]`` into overlapping frames ``[..., n_frames, frame_length]``.

    frames[i] = x[..., i*hop : i*hop + frame_length]. Tail samples that do not
    fill a frame are dropped (pad upstream for `center` semantics). The result
    is a strided view of ``x`` (``unfold``): no copy, and not to be written to.
    """
    t = x.shape[-1]
    if num_frames(t, frame_length, hop) <= 0:
        raise ValueError(f"signal length {t} shorter than frame_length {frame_length}")
    return x.unfold(-1, frame_length, hop)
