"""The port's biquad IIR engine against the JAX package on the CPU.

Designs and plans must equal the JAX package's float for float (both are
the same float64 host code); ``iir_apply`` runs the state recurrence as a
doubling scan where the JAX package runs a ``lax.scan`` over blocks, so the
two agree within fp32 rounding (1e-5), and both within the reference's
``biquad_chain`` budget (1e-4) of the float64 ``scipy.signal.sosfilt``.
"""

import numpy as np
import pytest
import scipy.signal
import torch

import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu.models import eq_bands_default as jax_eq_bands
from audioflow_tpu.ops import biquad as jb
from audioflow_torch import graph as tgraph
from audioflow_torch.models import eq_bands_default
from audioflow_torch.ops import biquad as tb
from audioflow_torch.ops import deemphasis
from audioflow_torch.profiling import aten_ops

FS = 16000.0
# the JAX package's validate row (validate.py:58-70)
VALIDATE_CHAIN = ((tb.highpass, 80.0), (tb.peaking, 1000.0, 4.0, 1.0), (tb.peaking, 3000.0, -3.0, 1.2))


def _to_jax(bqs):
    return tuple(jb.Biquad(b.b0, b.b1, b.b2, b.a1, b.a2) for b in bqs)


def _chain(n_stages: int):
    """1, 3 or 6 stages: the EQ of config 3 and its first bands."""
    return {1: (tb.peaking(1000.0, FS, 2.5, 0.9),),
            3: eq_bands_default(FS)[:3],
            6: eq_bands_default(FS)}[n_stages]


@pytest.mark.parametrize(
    "design,has_gain",
    [("lowpass", False), ("highpass", False), ("bandpass", False), ("notch", False), ("allpass", False),
     ("peaking", True), ("low_shelf", True), ("high_shelf", True)],
)
def test_rbj_design_equals_jax(design, has_gain):
    for fc in (20.0, 440.0, 3999.0, 7999.0):
        for q in (0.3, 0.7071067811865476, 4.0):
            for gain in ((-12.0, 0.0, 6.5) if has_gain else (None,)):
                args = (fc, FS) if gain is None else (fc, FS, gain)
                got = getattr(tb, design)(*args, q)
                want = getattr(jb, design)(*args, q)
                assert (got.b0, got.b1, got.b2, got.a1, got.a2) == (want.b0, want.b1, want.b2, want.a1, want.a2)
                for g, w in zip(got.as_ba(), want.as_ba()):
                    assert np.array_equal(g, w)


@pytest.mark.parametrize("block", [32, 128])
def test_plan_equals_jax(block):
    bqs = eq_bands_default(FS)
    assert [tuple(vars(b).values()) for b in bqs] == [tuple(vars(b).values()) for b in jax_eq_bands(FS)]
    got, want = tb.make_iir_plan(bqs, block), jb.make_iir_plan(_to_jax(bqs), block)
    assert (got.order, got.block) == (want.order, want.block) == (12, block)
    for name in ("t_mat", "o_mat", "u_mat", "a_pow", "a_pows"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    # the port's own two: the joined input matrix and the scan's powers
    assert np.array_equal(got.xw_mat, np.concatenate([got.t_mat.T, got.u_mat.T], axis=1))
    assert np.array_equal(got.scan_pows[0], got.a_pow)
    a, *_ = tb.cascade_state_space(bqs)
    want_p4 = np.linalg.matrix_power(np.linalg.matrix_power(a, block), 4).astype(np.float32)
    np.testing.assert_allclose(got.scan_pows[2], want_p4, rtol=1e-6, atol=1e-7)


def _reached_state(plan_j, lead, seed):
    """A state the cascade reaches: JAX's final state after 777 seeded
    samples. (The EQ's 8 kHz band sits at Nyquist with a double pole on the
    unit circle that no input excites; an arbitrary state would.)"""
    pre = (0.3 * np.random.default_rng(seed).standard_normal((*lead, 777))).astype(np.float32)
    return np.asarray(jb.iir_apply(jnp.asarray(pre), plan_j)[1])


# every length with and without a carried state on the 6-stage EQ; 1 and 3
# stages on a partial tail past one and past four blocks
@pytest.mark.parametrize(
    "n_stages,t_len,with_zi",
    [(6, t, z) for t in (0, 127, 128, 129, 1000, 4 * 128 + 37) for z in (False, True)]
    + [(n, t, True) for n in (1, 3) for t in (129, 4 * 128 + 37)],
)
def test_iir_apply_matches_jax(n_stages, t_len, with_zi):
    bqs = _chain(n_stages)
    plan_t, plan_j = tb.make_iir_plan(bqs), jb.make_iir_plan(_to_jax(bqs))
    lead = (3, 2)
    x = (0.3 * np.random.default_rng(t_len).standard_normal((*lead, t_len))).astype(np.float32)
    zi = _reached_state(plan_j, lead, t_len + 1) if with_zi else None
    y_t, s_t = tb.iir_apply(torch.from_numpy(x), plan_t, None if zi is None else torch.from_numpy(zi))
    y_j, s_j = jb.iir_apply(jnp.asarray(x), plan_j, None if zi is None else jnp.asarray(zi))
    assert tuple(y_t.shape) == (*lead, t_len) and tuple(s_t.shape) == (*lead, 2 * n_stages)
    assert y_t.dtype == s_t.dtype == torch.float32
    if t_len:
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5, rtol=0)


def test_iir_apply_one_dim_and_float64():
    """No leading axes; float64 input computes in float32, as in the JAX package."""
    bqs = eq_bands_default(FS)
    x = 0.3 * np.random.default_rng(5).standard_normal(1000)
    y64, s64 = tb.biquad_chain(torch.from_numpy(x), bqs)
    y32, s32 = tb.biquad_chain(torch.from_numpy(x.astype(np.float32)), bqs)
    assert y64.dtype == torch.float32 and torch.equal(y64, y32) and torch.equal(s64, s32)
    y_j, _ = jb.biquad_chain(jnp.asarray(x.astype(np.float32)), _to_jax(bqs))
    np.testing.assert_allclose(y32.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("chain_name", ["validate", "eq_default"])
def test_iir_apply_matches_sosfilt_oracle(chain_name):
    """The reference's ``biquad_chain`` row: 8,000 samples of 0.3·N(0,1)
    within 1e-4 of the float64 oracle."""
    if chain_name == "validate":
        bqs = tuple(f(*args[:1], FS, *args[1:]) for f, *args in VALIDATE_CHAIN)
    else:
        bqs = eq_bands_default(FS)
    x = (np.random.default_rng(0).standard_normal(8000) * 0.3).astype(np.float32)
    got, _ = tb.biquad_chain(torch.from_numpy(x), bqs)
    sos = np.stack([np.concatenate(b.as_ba()) for b in bqs])
    want = scipy.signal.sosfilt(sos, x.astype(np.float64))
    assert np.abs(got.numpy() - want).max() < 1e-4


def _ops_per_call(t_len):
    x = torch.zeros(1, t_len)
    zi = torch.zeros(1, 12)
    plan = tb.make_iir_plan(eq_bands_default(FS))
    return aten_ops(lambda: tb.iir_apply(x, plan, zi))


def test_iir_apply_ops_grow_with_log_of_blocks():
    """No Python loop over blocks: quadrupling the blocks adds two doubling
    steps (a product and an add each), whatever the length."""
    _ops_per_call(128)  # uploads the plan's matrices, once
    counts = [_ops_per_call(128 * nb) for nb in (31, 127, 511, 2047)]  # 32, 128, 512, 2048 scan entries
    assert [b - a for a, b in zip(counts, counts[1:])] == [4, 4, 4]
    # the block product, the scan's input, 11 steps of two, the output product and add
    assert counts[-1] == 26


def test_biquad_chain_streams_like_offline_and_jax():
    """Chunks of 300 samples (not a block multiple): streamed equals
    offline, and equals the JAX graph's scan_stream."""
    bqs = eq_bands_default(FS)
    x = (0.3 * np.random.default_rng(2).standard_normal((2, 3000))).astype(np.float32)
    g = tgraph.chain(tgraph.BiquadChain(bqs), input_rate=16000)
    j = jgraph.chain(jgraph.BiquadChain(_to_jax(bqs)), input_rate=16000)
    streamed = g.scan_stream(torch.from_numpy(x), 300)
    offline = g.compile(chunked=False)(torch.from_numpy(x))
    np.testing.assert_allclose(streamed.numpy(), offline.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(streamed.numpy(), np.asarray(j.scan_stream(jnp.asarray(x), 300)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(offline.numpy(), np.asarray(j(jnp.asarray(x))), atol=1e-5, rtol=0)


def test_deemphasis_matches_jax():
    from audioflow_tpu.ops import deemphasis as jax_deemphasis

    x = (0.3 * np.random.default_rng(3).standard_normal((2, 1500))).astype(np.float32)
    np.testing.assert_allclose(
        deemphasis(torch.from_numpy(x), 0.95).numpy(), np.asarray(jax_deemphasis(jnp.asarray(x), 0.95)),
        atol=1e-5, rtol=0,
    )


def test_empty_chain_is_rejected():
    from audioflow_torch.errors import AudioError

    with pytest.raises(AudioError):
        tgraph.BiquadChain(())
