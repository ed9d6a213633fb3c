"""Matmul with the port's precision policy: full fp32, always.

The JAX package's precision names do not carry over. There, "high" is a
bf16x3 split on the TPU's matrix unit (plain f32 on the CPU), and
``ops/stft.py`` makes it the DFT default. In torch, "high" would mean TF32,
which keeps a 10-bit mantissa: about three decimal digits, far outside the
1e-4 fidelity budget. So importing this module turns TF32 off for cuBLAS and
cuDNN, and :func:`mm` computes every product in fp32 whatever precision name
it is given. A faster tier (3xTF32 with host-split banks) is later work.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRECISIONS = ("default", "high", "highest")

_default: str = "highest"


def set_default_matmul_precision(name: str) -> None:
    """Record the framework-wide precision name (the JAX package's API).
    The port computes every product in fp32 whatever the name."""
    global _default
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}; known: {sorted(PRECISIONS)}")
    _default = name


def get_default_matmul_precision() -> str:
    """The name last given to :func:`set_default_matmul_precision`."""
    return _default


def check_precision(precision: str | None) -> None:
    """Raise for a precision name the JAX package does not know."""
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; known: {sorted(PRECISIONS)}")


def mm(a: torch.Tensor, b: torch.Tensor, precision: str | None = None) -> torch.Tensor:
    """fp32 matmul. ``precision`` takes the JAX package's names for API
    parity and is checked, but every name computes in full fp32."""
    check_precision(precision)
    return torch.matmul(a, b)
