"""Banded max-plus steps for sequence decoding (the pYIN Viterbi's band).

Mirrors ``audioflow_tpu/ops/sequence.py:44-115``. The transition matrix of a
local-movement HMM is never built: ``max_plus_band`` evaluates
``out[j] = max_k delta[j + k - half] + lk[k]`` over a ``-1e30``-padded
state. The JAX package writes it as ``2*half+1`` shifted adds folded by a
max (or a strict-compare select) tree, which XLA fuses into one pass; in
eager torch that would be four launches per tap, so the port takes the
band as one ``unfold`` window ``[..., S, K]`` and reduces it with
``torch.max``, which returns the first maximal index. The values are the
same f32 sums and the offsets the same: the strict ``>`` of the tap loop
keeps the lowest offset on a tie, and so does the first index.

Dense ``viterbi`` and ``dtw`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

_NEG = -1e30  # effective -inf that survives f32 adds without NaN


def transition_local(n_states: int, width: int) -> np.ndarray:
    """Row-stochastic local-movement transition matrix ``[n, n]``.

    Row i is a triangular window of ``width`` bins centered on i (width is
    forced odd), truncated at the edges and renormalized. float64, built on
    the host; a copy of the JAX package's design.
    """
    if n_states < 1:
        raise ValueError(f"n_states must be >= 1, got {n_states}")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    w = int(width) | 1  # odd
    half = w // 2
    tri = 1.0 - np.abs(np.arange(-half, half + 1, dtype=np.float64)) / (half + 1.0)
    a = np.zeros((n_states, n_states))
    for i in range(n_states):
        lo, hi = max(0, i - half), min(n_states, i + half + 1)
        a[i, lo:hi] = tri[lo - (i - half) : hi - (i - half)]
        a[i] /= a[i].sum()
    return a


def _band(delta: torch.Tensor, log_kernel: torch.Tensor) -> torch.Tensor:
    """The candidates ``delta[j + k - half] + lk[k]`` as ``[..., S, K]``."""
    k = log_kernel.shape[0]
    if k % 2 != 1:
        raise ValueError(f"log_kernel length must be odd, got {k}")
    half = k // 2
    dp = torch.nn.functional.pad(delta, (half, half), value=_NEG)
    return dp.unfold(-1, k, 1) + log_kernel.to(delta.dtype)


def max_plus_band(delta: torch.Tensor, log_kernel: torch.Tensor) -> torch.Tensor:
    """Banded max-plus product ``out[j] = max_k delta[j + k - half] + lk[k]``.

    ``delta`` is ``[..., S]``, ``log_kernel`` a length-(2*half+1) tensor of
    log-transition weights for offsets ``-half..+half``; out-of-range source
    states read -1e30.
    """
    return _band(delta, log_kernel).amax(dim=-1)


def max_plus_band_argmax(
    delta: torch.Tensor, log_kernel: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`max_plus_band` but also returns the winning kernel offset
    index (int16, 0..2*half; source state = j + offset - half). Ties keep the
    lowest offset, as the JAX package's strict-compare loop does."""
    best, arg = _band(delta, log_kernel).max(dim=-1)
    return best, arg.to(torch.int16)
