"""Sequence decoding: dense and banded max-plus Viterbi steps, and DTW.

Mirrors ``audioflow_tpu/ops/sequence.py``. The transition matrix of a
local-movement HMM is never built: ``max_plus_band`` evaluates
``out[j] = max_k delta[j + k - half] + lk[k]`` over a ``-1e30``-padded
state. The JAX package writes it as ``2*half+1`` shifted adds folded by a
max (or a strict-compare select) tree, which XLA fuses into one pass; in
eager torch that would be four launches per tap, so the port takes the
band as one ``unfold`` window ``[..., S, K]`` and reduces it with
``torch.max``, which returns the first maximal index. The values are the
same f32 sums and the offsets the same: the strict ``>`` of the tap loop
keeps the lowest offset on a tie, and so does the first index.

The dense :func:`viterbi` is a loop over frames of the ``[..., S, S]``
max-plus (``max`` over the source axis, the first index on a tie, as
``jnp.argmax``) and a backtrace of width-1 gathers. :func:`dtw` runs the
JAX package's anti-diagonal wavefront as a loop over the ``n + m - 1``
diagonals, each written into a preallocated ``[n_diag, n]`` row (the cost's
diagonals gathered once up front), and backtraces the int8 step choices on
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import as_tensor
from ._mm import mm

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


def viterbi(log_obs, log_trans, log_init=None, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Most-likely state path through a dense-transition HMM.

    ``log_obs`` ``[..., T, S]`` per-frame log observation likelihoods (a
    tensor, or numpy that goes to ``device``: "cuda" unless given);
    ``log_trans`` ``[S, S]`` with ``log_trans[i, j]`` = log P(j at t+1 | i
    at t); ``log_init`` ``[S]`` (uniform if None). Returns ``(states [...,
    T] int32, log_prob [...])``.
    """
    log_obs = as_tensor(log_obs, device)
    s = log_obs.shape[-1]
    log_trans = torch.as_tensor(log_trans, dtype=log_obs.dtype, device=log_obs.device)
    if tuple(log_trans.shape) != (s, s):
        raise ValueError(f"log_trans must be [{s}, {s}], got {tuple(log_trans.shape)}")
    if log_init is None:
        log_init = torch.full((s,), float(-np.log(s)), dtype=log_obs.dtype, device=log_obs.device)
    else:
        log_init = torch.as_tensor(log_init, dtype=log_obs.dtype, device=log_obs.device)
    delta = log_init + log_obs[..., 0, :]
    bps = []
    for t in range(1, log_obs.shape[-2]):
        # scores[..., i, j] = delta[..., i] + A[i, j]; the first maximal source
        best, bp = (delta[..., :, None] + log_trans).max(dim=-2)
        delta = best + log_obs[..., t, :]
        bps.append(bp)
    log_prob, state = delta.max(dim=-1, keepdim=True)
    states = [state]
    for bp in reversed(bps):
        state = torch.gather(bp, -1, state)
        states.append(state)
    return torch.cat(states[::-1], dim=-1).to(torch.int32), log_prob[..., 0]


def _dtw_cost(cost: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulated cost ``[N, M]`` and step choices (int8; 0 diagonal, 1 up
    (i-1, j), 2 left (i, j-1)) by the anti-diagonal wavefront: diagonal k
    holds the cells i + j == k, indexed by i. Each diagonal is one step over
    the two before it, as the JAX package's scan body, with the same
    ``1e30`` sentinel and the same sums and comparisons."""
    n, m = cost.shape
    dev, dtype = cost.device, cost.dtype
    big = 1e30
    n_diag = n + m - 1
    i = torch.arange(n, device=dev)
    k = torch.arange(n_diag, device=dev)[:, None]
    j = k - i  # [n_diag, n]
    valid = (j >= 0) & (j < m)
    c_d = torch.where(valid, cost[i, j.clamp(0, m - 1)], big)
    # acc_d[k, 1 + i] is the accumulated cost of cell (i, k - i); column 0 is
    # a big guard, and every cell off the grid holds big, so the three
    # predecessors read big exactly where the JAX package masks them to it
    acc_d = torch.full((n_diag, n + 1), big, dtype=dtype, device=dev)
    steps_d = torch.empty((n_diag, n), dtype=torch.int8, device=dev)
    none = torch.full((2, n + 1), big, dtype=dtype, device=dev)
    big_t = none[0, 0]
    for d in range(n_diag):
        prev = acc_d[d - 1] if d >= 1 else none[0]
        prev2 = acc_d[d - 2] if d >= 2 else none[1]
        # (i-1, j-1) on diagonal d-2, (i-1, j) and (i, j-1) on diagonal d-1
        d_diag, d_up, d_left = prev2[:n], prev[:n], prev[1:]
        ul = torch.minimum(d_up, d_left)
        base = torch.minimum(d_diag, ul)
        steps_d[d] = torch.where(d_diag <= ul, 0, torch.where(d_up <= d_left, 1, 2))
        acc = c_d[d] + base
        if d == 0:  # the origin has no predecessor: its bare cost
            acc[0] = c_d[0, 0]
        torch.where(valid[d], acc, big_t, out=acc_d[d, 1:])
    # scatter the diagonals back to [N, M]
    ii = i[:, None].expand(n, m)
    kk = ii + torch.arange(m, device=dev)[None, :]
    return acc_d[kk, ii + 1], steps_d[kk, ii]


def _backtrace(steps: np.ndarray) -> np.ndarray:
    """The optimal path ``[L, 2]`` from (0, 0) to (N-1, M-1) over the step
    choices: a walk back from the last cell, on the host."""
    n, m = steps.shape
    i, j = n - 1, m - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        s = steps[i, j]
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        elif s == 0:
            i, j = i - 1, j - 1
        elif s == 1:
            i -= 1
        else:
            j -= 1
        path.append((i, j))
    return np.asarray(path[::-1], dtype=np.int64)


def dtw(x=None, y=None, *, cost=None, metric: str = "euclidean", device=None) -> tuple[torch.Tensor, np.ndarray]:
    """Dynamic time warping between feature sequences.

    Either ``x`` ``[N, D]`` and ``y`` ``[M, D]`` (the pairwise cost from
    ``metric``: "euclidean" or "cosine"), or a precomputed ``cost`` ``[N,
    M]``; tensors, or numpy that goes to ``device`` ("cuda" unless given).
    Returns ``(acc, path)``: the accumulated cost matrix (``acc[-1, -1]`` is
    the alignment cost) and the optimal path, a host int64 array ``[L, 2]``
    of (i, j) pairs from (0, 0) to (N-1, M-1).
    """
    if cost is None:
        if x is None or y is None:
            raise ValueError("pass either (x, y) or cost=")
        x = as_tensor(x, device)
        y = as_tensor(y, x.device)
        if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
            raise ValueError(f"x [N, D] and y [M, D] required, got {tuple(x.shape)}, {tuple(y.shape)}")
        if metric == "euclidean":
            d2 = (x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :] - mm(2.0 * x, y.T)
            cost = torch.sqrt(torch.clamp_min(d2, 0.0))
        elif metric == "cosine":
            xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)
            yn = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-12)
            # clamp: fp32 rounding can push |cos| past 1; a distance must
            # not reward the aligner for length
            cost = torch.clamp_min(1.0 - mm(xn, yn.T), 0.0)
        else:
            raise ValueError(f"unknown metric {metric!r}")
    cost = as_tensor(cost, device)
    if cost.ndim != 2:
        raise ValueError(f"cost must be [N, M], got {tuple(cost.shape)}")
    acc, steps = _dtw_cost(cost)
    return acc, _backtrace(steps.cpu().numpy())
