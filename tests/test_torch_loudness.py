"""The port's loudness family (``ops/loudness.py``, ``LoudnessNormalize``)
against the JAX package on the CPU, on seeded inputs.

Tolerances: the K-weighting design is float64 host code copied bit for bit,
so equal; the gated readings (integrated loudness, LRA) within 1e-4 LU;
the momentary and short-term block powers within 1e-5 of the lane's
loudest block (the K-weighting's fp32 error scales with the signal's peak,
not with a block's own level: a block 70 dB down reads about 5e-4 LU off
float64 in both packages); true peak within 1e-4 dB; the normalized signal
within 1e-5 of its peak. The gates are discrete decisions, so each
comparison first asserts that no gating block of its input lies within
1e-3 LU of a gate (the absolute -70 LKFS one and the relative one): there,
fp32 rounding cannot flip a decision."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu import ops as jops
from audioflow_tpu.ops import loudness as jl
from audioflow_torch import graph as tgraph
from audioflow_torch import ops as tops
from audioflow_torch.ops import loudness as tl

RATE = 16000
LU_TOL = 1e-4
MARGIN_LU = 1e-3


def _program(seed=0, seconds=4.0, lead=(2,)):
    """Noise bursts at three levels over a quiet floor: blocks on both sides
    of each gate."""
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE)
    x = 1e-5 * rng.standard_normal((*lead, n))
    for k, (a, b, g) in enumerate(((0.05, 0.32, 0.3), (0.4, 0.6, 0.03), (0.7, 0.92, 0.1))):
        sl = slice(int(a * n), int(b * n))
        x[..., sl] += g * (1 + 0.2 * k) * rng.standard_normal((*lead, sl.stop - sl.start))
    return x.astype(np.float32)


def _gate_margin(x, window_s, rel_lu):
    """The smallest distance, in LU, of a block's loudness from the absolute
    or the relative gate (by the JAX package's own meter)."""
    p = np.asarray(jax.jit(lambda v: jl._block_power(jl.k_weight(v, RATE), RATE, window_s, 0.1))(jnp.asarray(x)))
    l_blk = np.asarray(jl._lufs(jnp.asarray(p)))
    m_abs = l_blk > jl.ABS_GATE_LUFS
    p_abs = np.where(m_abs, p, 0).sum(-1) / np.maximum(m_abs.sum(-1), 1)
    rel = np.asarray(jl._lufs(jnp.asarray(p_abs))) - rel_lu
    return min(np.abs(l_blk - jl.ABS_GATE_LUFS).min(), np.abs(l_blk - rel[..., None]).min())


@pytest.mark.parametrize("rate", [48000, 44100, 16000])
def test_k_weighting_equals_jax(rate):
    got, want = tl.k_weighting(rate), jl.k_weighting(rate)
    assert [tuple(vars(b).values()) for b in got] == [tuple(vars(b).values()) for b in want]


@pytest.mark.parametrize(
    "name,window_s,rel_lu",
    [("integrated_loudness", 0.4, 10.0), ("loudness_range", 3.0, 20.0),
     ("momentary_loudness", None, None), ("shortterm_loudness", None, None)],
)
def test_meters_match_jax(name, window_s, rel_lu):
    x = _program()
    if window_s is not None:
        assert _gate_margin(x, window_s, rel_lu) > MARGIN_LU
    got = getattr(tops, name)(torch.from_numpy(x), RATE).numpy()
    want = np.asarray(jax.jit(lambda v: getattr(jops, name)(v, RATE))(jnp.asarray(x)))
    assert got.shape == want.shape and np.isfinite(got).all()
    if window_s is not None:
        np.testing.assert_allclose(got, want, atol=LU_TOL, rtol=0)
    else:  # block loudness, compared as power against the loudest block
        p_got, p_want = 10.0 ** (got / 10.0), 10.0 ** (want / 10.0)
        assert (np.abs(p_got - p_want).max(axis=-1) / p_want.max(axis=-1) < 1e-5).all()


@pytest.mark.parametrize("oversample", [1, 4])
def test_true_peak_matches_jax(oversample):
    x = _program(seed=1, seconds=1.0)
    got = tops.true_peak(torch.from_numpy(x), RATE, oversample).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(lambda v: jops.true_peak(v, RATE, oversample))(jnp.asarray(x))), atol=1e-4, rtol=0)


def test_k_weight_and_block_count_match_jax():
    x = _program(seconds=1.0)
    got = tops.k_weight(torch.from_numpy(x), RATE).numpy()
    want = np.asarray(jops.k_weight(jnp.asarray(x), RATE))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    for n in (6399, 6400, 16000, 64001):
        assert tl.gating_block_count(n, RATE) == jl.gating_block_count(n, RATE)


def test_masked_percentile_equals_jax():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((4, 37)).astype(np.float32)
    mask = rng.random((4, 37)) > 0.4
    mask[3] = False  # no survivor: index 0 of the sorted fill
    for q in (0.1, 0.5, 0.95):
        got = tl._masked_percentile(torch.from_numpy(v), torch.from_numpy(mask), q).numpy()
        want = np.asarray(jl._masked_percentile(jnp.asarray(v), jnp.asarray(mask), q))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ceiling", [-1.0, None])
def test_normalize_loudness_matches_jax(ceiling):
    x = _program()
    assert _gate_margin(x, 0.4, 10.0) > MARGIN_LU
    got = tops.normalize_loudness(torch.from_numpy(x), RATE, -16.0, ceiling).numpy()
    want = np.asarray(jax.jit(lambda v: jops.normalize_loudness(v, RATE, -16.0, ceiling))(jnp.asarray(x)))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_silent_lane_reads_minus_inf_and_passes_through():
    x = np.zeros((2, RATE), np.float32)
    x[1] = _program(seconds=1.0, lead=())
    li = tops.integrated_loudness(torch.from_numpy(x), RATE).numpy()
    assert li[0] == -np.inf and np.isfinite(li[1])
    y = tops.normalize_loudness(torch.from_numpy(x), RATE).numpy()
    assert np.array_equal(y[0], x[0]) and np.isfinite(y).all()
    assert tops.loudness_range(torch.from_numpy(x[:1]).repeat(1, 4), RATE).item() == 0.0
    with pytest.raises(ValueError, match="too short"):
        tops.integrated_loudness(torch.zeros(100), RATE)


def test_loudness_normalize_node_matches_jax():
    x = _program()
    tg = tgraph.chain(tgraph.LoudnessNormalize(target_lufs=-16.0), input_rate=RATE)
    jg = jgraph.chain(jgraph.LoudnessNormalize(target_lufs=-16.0), input_rate=RATE)
    assert not tg.streamable and tg.nodes[0].sample_rate == RATE
    got = tg.compile()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jg.chain)(jnp.asarray(x)))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    # the meter reads the target (or the true-peak ceiling holds)
    li = tops.integrated_loudness(torch.from_numpy(got), RATE).numpy()
    tp = tops.true_peak(torch.from_numpy(got), RATE).numpy()
    assert np.all((np.abs(li + 16.0) < 0.01) | (tp <= -1.0 + 1e-3))
