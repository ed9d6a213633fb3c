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


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Inverse of :func:`frame`: out[t] = sum_i frames[..., i, t - i*hop].

    Output length is ``(n_frames - 1) * hop + frame_length``. Frames are
    added in the JAX package's order: by hop-chunk when ``hop`` divides the
    frame length, else frame by frame.
    """
    *lead, n, length = frames.shape
    if length % hop == 0:
        k = length // hop
        # split each frame into k hop-chunks; chunk m of frame i lands at hop i+m
        z = frames.new_zeros((*lead, n + k - 1, hop))
        f = frames.reshape(*lead, n, k, hop)
        for m in range(k):
            z[..., m : m + n, :] += f[..., :, m, :]
        return z.reshape(*lead, (n + k - 1) * hop)
    z = frames.new_zeros((*lead, (n - 1) * hop + length))
    for i in range(n):  # non-divisible hop: rare path
        z[..., i * hop : i * hop + length] += frames[..., i, :]
    return z
