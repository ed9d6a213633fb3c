"""Small shared utilities: rational-rate math, and input placement for the
entry points."""

from __future__ import annotations

import math

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


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise AudioError(
            "no CUDA card is visible; pass device='cpu' to run on the CPU",
            code=ErrorCode.DEVICE_NOT_FOUND,
        )
    return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)
