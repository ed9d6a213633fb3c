"""Structural analysis: self-similarity, novelty, section boundaries.

Mirrors ``audioflow_tpu/ops/segment.py``. The recurrence (self-similarity)
matrix is one Gram product of the (normalized) feature frames through the
port's fp32 :func:`~._mm.mm`; kNN sparsification compares each row with its
k-th largest value (``kthvalue``, the value the JAX package's full sort
reads). Foote novelty reads the box-checkerboard sums from a 2-D
summed-area table (two cumsums with a zero guard row and column) in O(1)
per frame. The table's entries grow as T^2 (about 1e8 at T = 15,500, where
fp32 steps by 8), so each cumsum accumulates in float64 and rounds an entry
once: the JAX package's fp32 scan and the card's fp32 cumsum would each add
their own accumulated rounding, and the card would part from the CPU. Boundaries are the rhythm family's peak picker over the novelty.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import as_tensor
from ._mm import mm
from .rhythm import peak_pick

__all__ = [
    "self_similarity",
    "cross_similarity",
    "recurrence_matrix",
    "novelty_curve",
    "segment_boundaries",
]


def _normalize_rows(x: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "cosine":
        return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)
    if metric == "dot":
        return x
    raise ValueError(f"unknown metric {metric!r}; known: cosine, dot")


def self_similarity(feats, metric: str = "cosine", precision: str | None = None, device=None) -> torch.Tensor:
    """Frame-by-frame similarity ``[..., T, D] -> [..., T, T]`` (one Gram
    product; cosine rows are unit-normalized first). ``feats`` is a tensor,
    or numpy that goes to ``device`` ("cuda" unless given)."""
    xn = _normalize_rows(as_tensor(feats, device), metric)
    return mm(xn, xn.transpose(-2, -1), precision)


def cross_similarity(a, b, metric: str = "cosine", precision: str | None = None, device=None) -> torch.Tensor:
    """Similarity between two feature sequences ``[..., Ta, D] x [..., Tb, D]
    -> [..., Ta, Tb]`` (the DTW cost's affinity twin)."""
    an = _normalize_rows(as_tensor(a, device), metric)
    bn = _normalize_rows(as_tensor(b, an.device), metric)
    return mm(an, bn.transpose(-2, -1), precision)


def recurrence_matrix(
    feats, k: int | None = None, width: int = 1, metric: str = "cosine", sym: bool = False, device=None,
) -> torch.Tensor:
    """kNN recurrence matrix ``[..., T, T]`` (float 0/1).

    ``R[i, j] = 1`` iff frame j is among frame i's ``k`` most similar frames
    (default ``k = ceil(sqrt(T))``), excluding the diagonal band ``|i - j| <
    width``. ``sym=True`` keeps only mutual links (R & R.T).
    """
    feats = as_tensor(feats, device)
    s = self_similarity(feats, metric)
    t = s.shape[-1]
    if not 1 <= width <= t:
        raise ValueError(f"width must be in [1, {t}], got {width}")
    if k is None:
        k = int(np.ceil(np.sqrt(t)))
    k = min(max(int(k), 1), t)
    idx = torch.arange(t, device=s.device)
    band = (idx[:, None] - idx[None, :]).abs() < width
    s = torch.where(band, -torch.inf, s)
    # the k-th largest per row: the (t - k + 1)-th smallest
    kth = torch.kthvalue(s, t - k + 1, dim=-1, keepdim=True).values
    r = (s >= kth) & ~band & torch.isfinite(s)
    if sym:
        r = r & r.transpose(-2, -1)
    return r.to(feats.dtype)


def novelty_curve(s, kernel_width: int = 32, normalize: bool = True, device=None) -> torch.Tensor:
    """Foote novelty of a self-similarity matrix ``[..., T, T] -> [..., T]``.

    Box checkerboard of half-width ``L = kernel_width // 2`` centered on the
    diagonal: ``nov[t] = sum(past block) + sum(future block) - 2 * sum(cross
    block)``, each block sum read from a 2-D summed-area table in O(1).
    Edges use the truncated blocks that fit (the kernel shrinks, it does not
    wrap); ``normalize=True`` divides by the actual block area. The table
    is written into one zero-guarded buffer, so the function holds ``s``,
    one table of its size and a float64 cumsum.
    """
    s = as_tensor(s, device)
    t = s.shape[-1]
    l = max(1, int(kernel_width) // 2)
    # summed-area table with a zero guard row/col: sat[i, j] = sum s[:i, :j];
    # each cumsum accumulates in float64 and rounds each entry once, on
    # either device (torch's CPU cumsum does so for float32 anyway)
    sat = s.new_zeros((*s.shape[:-2], t + 1, t + 1))
    inner = sat[..., 1:, 1:]
    inner.copy_(torch.cumsum(s, dim=-1, dtype=torch.float64))
    inner.copy_(torch.cumsum(inner, dim=-2, dtype=torch.float64))

    ts = torch.arange(t, device=s.device)
    lo = torch.clamp_min(ts - l, 0)
    hi = torch.clamp_max(ts + l, t)

    def block(r0, r1, c0, c1):
        """sum s[r0:r1, c0:c1] per t (vectors of indices)."""
        return sat[..., r1, c1] - sat[..., r0, c1] - sat[..., r1, c0] + sat[..., r0, c0]

    nov = block(lo, ts, lo, ts) + block(ts, hi, ts, hi) - 2.0 * block(lo, ts, ts, hi)
    area = ((ts - lo) * (hi - ts)).to(s.dtype)
    if normalize:
        nov = nov / torch.clamp_min(area, 1.0)
    # an empty past or future block (first/last frame) has no contrast to
    # measure: zero, not a spurious edge spike
    return torch.where(area > 0, torch.clamp_min(nov, 0.0), 0.0)


def segment_boundaries(
    feats,
    kernel_width: int = 32,
    metric: str = "cosine",
    pre: int | None = None,
    post: int | None = None,
    delta: float = 0.05,
    wait: int | None = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Section boundaries from feature frames ``[T, D]``: self-similarity ->
    Foote novelty -> peak picking (``rhythm.peak_pick``). Returns
    ``(boundary_mask [T] bool, novelty [T])``. The picker's windows default
    to the kernel half-width."""
    nov = novelty_curve(self_similarity(feats, metric, device=device), kernel_width)
    half = max(1, kernel_width // 2)
    pre_w = half if pre is None else pre
    post_w = half if post is None else post
    mask = peak_pick(
        nov, pre_max=pre_w, post_max=post_w, pre_avg=pre_w, post_avg=post_w, delta=delta,
        wait=half if wait is None else wait,
    )
    # the first/last half-kernel frames see a badly truncated checkerboard
    # (tiny noisy blocks): a "boundary" there is an edge artifact
    t = nov.shape[-1]
    idx = torch.arange(t, device=nov.device)
    return mask & (idx >= half) & (idx < t - half), nov
