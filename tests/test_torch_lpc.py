"""The port's LPC (``ops/lpc.py``) against the JAX package and the serial
float64 Levinson oracle of ``tests/test_lpc.py`` on the CPU, on seeded
inputs.

Tolerances: coefficients and residual energies within ``RTOL`` = 1e-4 of
the JAX package's, relative to each output's peak (the recursion's small
sums in another order, through the same autocorrelation); against the
float64 oracle, ``tests/test_lpc.py``'s own bounds (rtol 1e-3 and atol 1e-4
on the coefficients, 1e-3 relative on the energy).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import ops as jops
from audioflow_torch import ops as tops

RTOL = 1e-4


def _levinson_oracle(r, order):
    a = np.zeros(order + 1)
    a[0] = 1.0
    e = r[0]
    for i in range(1, order + 1):
        s = sum(a[j] * r[i - j] for j in range(i))
        k = -s / e if e > 0 else 0.0
        a_new = a.copy()
        for j in range(1, i + 1):
            a_new[j] = a[j] + k * a[i - j]
        a, e = a_new, e * (1.0 - k * k)
    return a, e


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("order", [2, 8, 16])
def test_lpc_from_autocorr_matches_jax_and_oracle(order):
    rng = np.random.default_rng(order)
    x = rng.standard_normal(4000)
    r = np.array([(x[: 4000 - lag] * x[lag:]).sum() for lag in range(order + 1)])
    r32 = r.astype(np.float32)[None]
    a, e = tops.lpc_from_autocorr(torch.from_numpy(r32), order)
    ja, je = jops.lpc_from_autocorr(jnp.asarray(r32), order)
    assert a.shape == (1, order + 1) and e.shape == (1,)
    assert _rel(a, ja) <= RTOL and _rel(e, je) <= RTOL
    wa, we = _levinson_oracle(r, order)
    np.testing.assert_allclose(a.numpy()[0], wa, rtol=1e-3, atol=1e-4)
    assert abs(float(e[0]) - we) / we < 1e-3


@pytest.mark.parametrize("order", [4, 12])
def test_lpc_batched_matches_jax(order):
    """Framed analysis: every frame of every batch row recursed at once."""
    x = np.random.default_rng(7).standard_normal((3, 5, 1024)).astype(np.float32)
    a = tops.lpc(x, order, device="cpu")
    e = tops.lpc_residual_energy(x, order, device="cpu")
    assert a.shape == (3, 5, order + 1) and e.shape == (3, 5) and (a[..., 0] == 1.0).all()
    assert _rel(a, jops.lpc(jnp.asarray(x), order)) <= RTOL
    assert _rel(e, jops.lpc_residual_energy(jnp.asarray(x), order)) <= RTOL
    r0 = (x.astype(np.float64) ** 2).sum(-1)
    assert (e.numpy() > 0).all() and (e.numpy() < r0 + 1e-6).all()


def test_lpc_recovers_ar_model():
    # AR(2): x[n] = 1.3 x[n-1] - 0.6 x[n-2] + w[n]  ->  a = [1, -1.3, 0.6]
    rng = np.random.default_rng(0)
    n = 30000
    w = rng.standard_normal(n)
    x = np.zeros(n)
    for i in range(2, n):
        x[i] = 1.3 * x[i - 1] - 0.6 * x[i - 2] + w[i]
    a = tops.lpc(x[2000:].astype(np.float32), 2, device="cpu").numpy()
    np.testing.assert_allclose(a, [1.0, -1.3, 0.6], atol=0.02)


def test_lpc_zero_input_and_errors():
    a, e = tops.lpc_from_autocorr(torch.zeros(2, 9), 8)
    assert torch.equal(a, torch.eye(9)[:1].expand(2, 9)) and torch.equal(e, torch.zeros(2))
    assert torch.isfinite(tops.lpc(np.zeros((2, 256), np.float32), 8, device="cpu")).all()
    with pytest.raises(ValueError):
        tops.lpc_from_autocorr(torch.zeros(2, 9), 0)
    with pytest.raises(ValueError):
        tops.lpc_from_autocorr(torch.zeros(2, 4), 8)
    assert tops.lpc_mod.lpc is tops.lpc
