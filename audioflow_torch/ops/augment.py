"""SpecAugment-style feature augmentation (Park et al. 2019) for the
trainable frontend: time and frequency masking over feature tensors.

Mirrors ``audioflow_tpu/ops/augment.py``. A masked region [t0, t0 + w) is a
broadcast index compare, with no data-dependent slicing. The masks' widths
and starts are drawn on the host from an explicit CPU ``torch.Generator``
(:func:`draw_masks`), so applying them (:func:`apply_masks`) never waits for
the device. Torch's random stream is not JAX's threefry: the same seed gives
other masks than the JAX package's, from the same distribution.
"""

from __future__ import annotations

import torch

__all__ = ["time_mask", "freq_mask", "spec_augment"]


def draw_masks(size: int, generator: torch.Generator, param: int, num_masks: int) -> list[tuple[int, int]]:
    """``num_masks`` draws of ``(w, t0)`` over an axis of ``size``: the width
    uniform in [0, min(param, size)], the start uniform in [0, size - w], as
    the JAX package draws them."""
    if param < 0:
        raise ValueError(f"mask param must be >= 0, got {param}")
    if generator.device.type != "cpu":
        raise ValueError(f"the masks are drawn on the host: pass a CPU torch.Generator, got {generator.device}")
    p = min(param, size)
    draws = []
    for _ in range(max(num_masks, 0)):
        w = int(torch.randint(0, p + 1, (), generator=generator))
        t0 = int(torch.randint(0, max(size - w, 0) + 1, (), generator=generator))
        draws.append((w, t0))
    return draws


def apply_masks(x: torch.Tensor, draws, axis: int, value: float) -> torch.Tensor:
    """Set ``[t0, t0 + w)`` of ``axis`` to ``value`` for each ``(w, t0)`` of
    ``draws``, in order."""
    size = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = size
    idx = torch.arange(size, device=x.device).reshape(shape)
    for w, t0 in draws:
        x = torch.where((idx >= t0) & (idx < t0 + w), value, x)
    return x


def _mask_axis(x, generator, param, num_masks, axis, value):
    return apply_masks(x, draw_masks(x.shape[axis], generator, param, num_masks), axis, value)


def time_mask(feats: torch.Tensor, generator: torch.Generator, param: int = 20, num_masks: int = 1,
              value: float = 0.0) -> torch.Tensor:
    """Zero (or ``value``) out ``num_masks`` random spans of up to ``param``
    frames along the time axis of ``[..., T, F]`` features."""
    return _mask_axis(feats, generator, param, num_masks, feats.ndim - 2, value)


def freq_mask(feats: torch.Tensor, generator: torch.Generator, param: int = 10, num_masks: int = 1,
              value: float = 0.0) -> torch.Tensor:
    """Zero (or ``value``) out ``num_masks`` random bands of up to ``param``
    bins along the feature axis of ``[..., T, F]``."""
    return _mask_axis(feats, generator, param, num_masks, feats.ndim - 1, value)


def spec_augment(
    feats: torch.Tensor,
    generator: torch.Generator,
    time_param: int = 20,
    freq_param: int = 10,
    n_time_masks: int = 2,
    n_freq_masks: int = 2,
    value: float = 0.0,
) -> torch.Tensor:
    """Standard SpecAugment recipe: ``n_freq_masks`` frequency bands, then
    ``n_time_masks`` time spans masked (no time warping, as in the JAX
    package). The frequency masks are drawn first."""
    out = freq_mask(feats, generator, freq_param, n_freq_masks, value)
    return time_mask(out, generator, time_param, n_time_masks, value)
