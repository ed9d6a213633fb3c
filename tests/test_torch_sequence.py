"""The port's dense Viterbi and DTW (``ops/sequence.py``) against the JAX
package on the CPU, on seeded inputs.

Tolerances: Viterbi paths exactly and the log-probability within
``LOGP_TOL`` = 1e-5 (the same fp32 sums); DTW's accumulated cost within
``ACC_TOL`` = 1e-5 of the final cost (the same sums in the same order from a
given cost; from features, the cost's products round differently). A DTW
path is a chain of discrete step choices, so it is compared where the
choices along it are clear of the two sides' accumulated-cost difference
(``tests/decision_margins.py::dtw_path_margin``), and exactly on a cost
with exact ties, which checks the step rule's tie order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import ops as jops
from audioflow_torch import ops as tops
from audioflow_torch.ops import sequence as tseq
from decision_margins import dtw_path_margin

LOGP_TOL = 1e-5
ACC_TOL = 1e-5


def _hmm(rng, shape, s):
    lo = rng.standard_normal((*shape, s)).astype(np.float32)
    a = rng.random((s, s))
    a /= a.sum(1, keepdims=True)
    return lo, np.log(a).astype(np.float32)


@pytest.mark.parametrize("shape,init", [((6,), True), ((2, 3, 9), False), ((4, 1), False), ((40,), False)],
                         ids=["t6-init", "batched", "t1", "t40"])
def test_viterbi_matches_jax(shape, init):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    s = 5
    lo, la = _hmm(rng, shape, s)
    li = np.log(rng.dirichlet(np.ones(s))).astype(np.float32) if init else None
    got, glp = tops.viterbi(lo, la, li, device="cpu")
    want, wlp = jops.viterbi(jnp.asarray(lo), jnp.asarray(la), None if li is None else jnp.asarray(li))
    assert got.dtype == torch.int32 and got.shape == want.shape and glp.shape == wlp.shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.abs(glp.numpy() - np.asarray(wlp)).max() <= LOGP_TOL


def test_viterbi_ties_take_the_first_source():
    """A transition matrix with equal rows and equal observations ties every
    source; both packages take the first index at every step."""
    lo = np.zeros((7, 4), np.float32)
    la = np.full((4, 4), np.log(0.25), np.float32)
    got, _ = tops.viterbi(lo, la, device="cpu")
    want, _ = jops.viterbi(jnp.asarray(lo), jnp.asarray(la))
    assert np.array_equal(got.numpy(), np.asarray(want)) and (got.numpy() == 0).all()
    with pytest.raises(ValueError):
        tops.viterbi(lo, la[:3], device="cpu")


@pytest.mark.parametrize("shape", [(7, 9), (9, 7), (1, 5), (5, 1), (1, 1), (31, 24)])
def test_dtw_cost_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    c = rng.random(shape).astype(np.float32)
    acc, path = tops.dtw(cost=c, device="cpu")
    jacc, jpath = jops.dtw(cost=jnp.asarray(c))
    jacc = np.asarray(jacc)
    assert acc.shape == jacc.shape and path.dtype == np.int64
    assert np.abs(acc.numpy() - jacc).max() <= ACC_TOL * jacc[-1, -1]
    assert np.array_equal(path, jpath)


def test_dtw_step_rule_ties_match_jax():
    """Integer costs: the accumulated costs are exact in fp32, so ties are
    exact on both sides, and the paths are equal only if the step rule
    breaks them in the same order (diagonal, then up, then left)."""
    c = np.random.default_rng(5).integers(0, 3, (14, 17)).astype(np.float32)
    acc, path = tops.dtw(cost=c, device="cpu")
    jacc, jpath = jops.dtw(cost=jnp.asarray(c))
    assert np.array_equal(acc.numpy(), np.asarray(jacc)) and np.array_equal(path, jpath)
    assert dtw_path_margin(acc, path) == 0.0  # the case has ties on the path
    _, steps = tseq._dtw_cost(torch.from_numpy(c))
    assert steps.dtype == torch.int8


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_dtw_features_match_jax(metric):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((40, 13)).astype(np.float32)
    y = np.concatenate([x[::2], x[20:]]) + 0.1 * rng.standard_normal((40, 13)).astype(np.float32)
    acc, path = tops.dtw(x, y, metric=metric, device="cpu")
    jacc, jpath = jops.dtw(jnp.asarray(x), jnp.asarray(y), metric=metric)
    jacc = np.asarray(jacc)
    diff = float(np.abs(acc.numpy() - jacc).max())
    assert diff <= ACC_TOL * jacc[-1, -1], diff
    # each step choice on the path clear of the accumulated costs' difference
    assert dtw_path_margin(jacc, jpath) > 2 * diff, (dtw_path_margin(jacc, jpath), diff)
    assert np.array_equal(path, jpath)


def test_dtw_errors_and_self_alignment():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((8, 3)).astype(np.float32)
    acc, path = tops.dtw(a, a, device="cpu")
    assert float(acc[-1, -1]) < 0.05 and (path[:, 0] == path[:, 1]).all()
    with pytest.raises(ValueError):
        tops.dtw(a, a, metric="manhattan", device="cpu")
    with pytest.raises(ValueError):
        tops.dtw(a, device="cpu")
    with pytest.raises(ValueError):
        tops.dtw(cost=np.zeros((2, 2, 2), np.float32), device="cpu")
    with pytest.raises(ValueError):
        tops.dtw(a, a[:, :2], device="cpu")
