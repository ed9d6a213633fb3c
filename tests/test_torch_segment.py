"""The port's structure analysis (``ops/segment.py``) against the JAX
package on the CPU, on seeded inputs.

Tolerances, absolute: the similarities within ``SIM_TOL`` = 1e-5 (one Gram
product of normalized rows; entries of magnitude <= 1); the novelty within
``NOV_TOL`` = 1e-4 at T <= 256, of the JAX package and of the direct
float64 checkerboard (the JAX package's own bound, ``tests/test_segment.py``:
the summed-area table sums in another order, and the port's CPU cumsum
accumulates in float64), where the table's entries stay small; on a table
whose entries grow to T^2 / 2, within ``sat_bound`` of the float64
checkerboard: eight fp32 spacings of its largest entry (a block reads four
entries, each rounded in its two cumsums) over the block's area; and within
twice that of the JAX package, each side within it of the exact value. The recurrence matrix and the boundaries are
discrete (a k-th value compare, a peak pick): each comparison first asserts
that its decisions are clear of the two sides' differences
(``tests/decision_margins.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import ops as jops
from audioflow_torch import ops as tops
from decision_margins import knn_margin, peak_pick_margins, sat_bound

SIM_TOL = 1e-5
NOV_TOL = 1e-4


def _novelty_direct(s, l):
    t = s.shape[0]
    nov = np.zeros(t)
    for i in range(t):
        lo, hi = max(i - l, 0), min(i + l, t)
        area = (i - lo) * (hi - i)
        if area > 0:
            nov[i] = max((s[lo:i, lo:i].sum() + s[i:hi, i:hi].sum() - 2 * s[lo:i, i:hi].sum()) / area, 0.0)
    return nov


def _sections(rng, n=40, d=8):
    """Three homogeneous sections of distinct feature directions (``tests/test_segment.py``)."""
    c = np.eye(3, d, dtype=np.float32) * 4
    f = np.concatenate([np.tile(c[i], (n, 1)) for i in range(3)])
    return f + 0.1 * rng.standard_normal(f.shape).astype(np.float32)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_similarities_match_jax(metric):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 30, 6)).astype(np.float32)
    got = tops.self_similarity(x, metric, device="cpu").numpy()
    want = np.asarray(jops.self_similarity(jnp.asarray(x), metric))
    scale = 1.0 if metric == "cosine" else np.abs(want).max()
    assert got.shape == want.shape == (2, 30, 30) and np.abs(got - want).max() <= SIM_TOL * scale
    got = tops.cross_similarity(x[0, :5], x[1], metric, device="cpu").numpy()
    want = np.asarray(jops.cross_similarity(jnp.asarray(x[0, :5]), jnp.asarray(x[1]), metric))
    assert got.shape == (5, 30) and np.abs(got - want).max() <= SIM_TOL * scale
    with pytest.raises(ValueError):
        tops.self_similarity(x, "euclid", device="cpu")


@pytest.mark.parametrize("t,l,kind", [(40, 4, "uniform"), (25, 8, "uniform"), (10, 16, "uniform"),
                                      (256, 16, "cosine"), (256, 16, "uniform")])
def test_novelty_matches_jax_and_direct(t, l, kind):
    rng = np.random.default_rng(t + l)
    if kind == "cosine":  # the self-similarity of feature frames: entries in [-1, 1]
        s = np.asarray(jops.self_similarity(jnp.asarray(rng.standard_normal((t, 13)).astype(np.float32))))
    else:  # the JAX package's test input, entries in [0, 1)
        s = rng.random((t, t)).astype(np.float32)
        s = (s + s.T) / 2
    small = t <= 40 or kind == "cosine"
    tol = NOV_TOL if small else sat_bound(s, l)
    got = tops.novelty_curve(s, kernel_width=2 * l, device="cpu").numpy()
    assert got.shape == (t,) and got.dtype == np.float32
    assert (np.abs(got - _novelty_direct(s.astype(np.float64), l)) <= tol).all()
    want = np.asarray(jops.novelty_curve(jnp.asarray(s), kernel_width=2 * l))
    assert (np.abs(got - want) <= (tol if small else 2 * tol)).all()
    # unnormalized, the same bounds times the block's area
    ts = np.arange(t)
    area = np.maximum((ts - np.maximum(ts - l, 0)) * (np.minimum(ts + l, t) - ts), 1)
    raw = tops.novelty_curve(s, kernel_width=2 * l, normalize=False, device="cpu").numpy()
    wraw = np.asarray(jops.novelty_curve(jnp.asarray(s), kernel_width=2 * l, normalize=False))
    assert (np.abs(raw - wraw) <= (tol if small else 2 * tol) * area).all()


@pytest.mark.parametrize("k,width,sym", [(4, 2, False), (4, 2, True), (None, 1, False)])
def test_recurrence_matrix_matches_jax(k, width, sym):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((48, 5)).astype(np.float32)
    s = tops.self_similarity(x, device="cpu")
    ws = np.asarray(jops.self_similarity(jnp.asarray(x)))
    kk = int(np.ceil(np.sqrt(48))) if k is None else k
    assert knn_margin(ws, kk, width) > 2 * float(np.abs(s.numpy() - ws).max()) + 1e-6
    got = tops.recurrence_matrix(x, k=k, width=width, sym=sym, device="cpu")
    want = np.asarray(jops.recurrence_matrix(jnp.asarray(x), k=k, width=width, sym=sym))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    for d in range(-width + 1, width):
        assert np.diagonal(got.numpy(), d).sum() == 0
    with pytest.raises(ValueError):
        tops.recurrence_matrix(x, width=0, device="cpu")


def test_segment_boundaries_match_jax():
    feats = _sections(np.random.default_rng(0))
    mask, nov = tops.segment_boundaries(feats, kernel_width=16, device="cpu")
    wmask, wnov = (np.asarray(a) for a in jops.segment_boundaries(jnp.asarray(feats), kernel_width=16))
    diff = float(np.abs(nov.numpy() - wnov).max())
    assert diff <= 1e-3  # the novelty through a 120-frame table; the boundary
    # decisions are then compared where they clear twice this difference
    m = peak_pick_margins(wnov, 8, 8, 8, 8, 0.05, slack=2 * diff)
    assert min(m.values()) > 2 * diff, m
    assert mask.dtype == torch.bool and np.array_equal(mask.numpy(), wmask)
    hits = np.where(mask.numpy())[0]
    assert all((np.abs(hits - b) <= 3).any() for b in (40, 80)) and len(hits) <= 4, hits
