"""Small shared utilities: rational-rate math, padding, and input placement
for the entry points."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..errors import AudioError, ErrorCode


def rational_rate(input_rate: int, output_rate: int) -> tuple[int, int]:
    """Reduce a sample-rate conversion to coprime (up=L, down=M).

    48000->16000 -> (1, 3); 44100->16000 -> (160, 441).
    """
    if input_rate <= 0 or output_rate <= 0:
        raise ValueError("sample rates must be positive")
    g = math.gcd(input_rate, output_rate)
    return output_rate // g, input_rate // g


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the nearest multiple."""
    return -(-x // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: np.ndarray, length: int, axis: int = -1, value: float = 0.0) -> np.ndarray:
    """Pad ``x`` along ``axis`` to ``length`` with ``value`` (no-op if long enough)."""
    axis = axis % x.ndim
    cur = x.shape[axis]
    if cur >= length:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, length - cur)
    return np.pad(x, widths, constant_values=value)


def stack_padded(arrays: Sequence[np.ndarray], multiple: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length 1-D arrays into [batch, T] plus a lengths vector;
    T is the longest length rounded up to ``multiple``."""
    if not arrays:
        raise ValueError("empty batch")
    lengths = np.array([a.shape[-1] for a in arrays], dtype=np.int32)
    target = round_up(int(lengths.max()), multiple)
    out = np.stack([pad_to(np.asarray(a), target) for a in arrays])
    return out, lengths


def as_tensor(x, device: torch.device | str | None = None) -> torch.Tensor:
    """``x`` as a tensor for an entry point of the port.

    A tensor stays on its own device unless ``device`` names another. Other
    input (a numpy array from the ``io`` loaders, a list) becomes float32,
    the JAX package's default dtype, on ``device``: "cuda" unless the caller
    asks for another, since the port runs on the card. Without a visible card
    that default raises: it never carries on on the CPU unasked.
    """
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=resolve_device(device))


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    another. Without a visible card "cuda" raises ``DEVICE_NOT_FOUND``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise AudioError(
            "no CUDA card is visible; pass device='cpu' to run on the CPU",
            code=ErrorCode.DEVICE_NOT_FOUND,
        )
    return dev
