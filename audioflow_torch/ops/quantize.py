"""PCM quantization: f32 samples to the wire's int16 and back.

Mirrors ``audioflow_tpu/ops/quantize.py``: clamp to [-1, 1], scale by 32767
and truncate toward zero, as the reference's wire packing (Rust ``as
i16``). NaN quantizes to 0 and +-inf to +-32767, which is what the JAX
package gives on the CPU; the cast of a NaN to an integer is not defined in
torch, so NaN is mapped to 0 before it. The little-endian byte and base64
framing lives on the host in :mod:`audioflow_torch.sinks.wire`.
"""

from __future__ import annotations

import torch


def _scaled(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.nan_to_num(x, nan=0.0), -1.0, 1.0) * 32767.0


def quantize_i16(x: torch.Tensor) -> torch.Tensor:
    """f32 [-1, 1] -> int16, reference parity (clamp, scale 32767, trunc)."""
    return torch.trunc(_scaled(x)).to(torch.int16)


def dequantize_i16(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int16 -> f32 in [-1, 1) by the symmetric 1/32768 convention."""
    return x.to(dtype) / 32768.0


def quantize_i16_round(x: torch.Tensor) -> torch.Tensor:
    """The higher-quality variant: round half to even instead of trunc."""
    return torch.round(_scaled(x)).to(torch.int16)
