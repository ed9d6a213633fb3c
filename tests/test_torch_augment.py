"""The port's SpecAugment against the JAX package's on the CPU.

The port draws its masks from torch's random stream, the JAX package from
threefry, so the masks differ by design. The comparison replays the JAX
package's draws (``jax.random.split``/``randint`` as
``audioflow_tpu/ops/augment.py:29-32`` calls them) through the port's
``apply_masks``: the result must equal the JAX output bit for bit. The
bounds and ``value`` cases of ``tests/test_augment_trim.py`` run on the port
with a seeded ``torch.Generator``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu import ops as jops
from audioflow_torch import ops
from audioflow_torch.ops.augment import apply_masks, draw_masks


def _jax_draws(key, size, param, num_masks):
    """The (w, t0) pairs of the JAX package's ``_mask_axis``."""
    p = min(param, size)
    out = []
    for k in jax.random.split(key, num_masks):
        kw, ks = jax.random.split(k)
        w = jax.random.randint(kw, (), 0, p + 1)
        t0 = jax.random.randint(ks, (), 0, jnp.maximum(size - w, 0) + 1)
        out.append((int(w), int(t0)))
    return out


@pytest.mark.parametrize(
    "shape,time_param,freq_param,n_time,n_freq,value,seed",
    [((3, 50, 24), 20, 10, 2, 2, 0.0, 0), ((2, 31, 24), 8, 6, 1, 3, -5.0, 1), ((40, 12), 60, 20, 3, 1, 0.0, 2),
     ((2, 4, 6), 3, 2, 2, 2, 1.5, 3)],
)
def test_replayed_draws_equal_jax_bitwise(shape, time_param, freq_param, n_time, n_freq, value, seed):
    feats = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) + 10.0
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jops.spec_augment(jnp.asarray(feats), key, time_param, freq_param, n_time, n_freq, value))
    kt, kf = jax.random.split(key)
    nd = len(shape)
    got = apply_masks(torch.from_numpy(feats), _jax_draws(kf, shape[-1], freq_param, n_freq), nd - 1, value)
    got = apply_masks(got, _jax_draws(kt, shape[-2], time_param, n_time), nd - 2, value)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    # one axis alone, as time_mask and freq_mask
    for fn, axis, param in ((jops.time_mask, nd - 2, time_param), (jops.freq_mask, nd - 1, freq_param)):
        want1 = np.asarray(fn(jnp.asarray(feats), key, param, 2, value))
        got1 = apply_masks(torch.from_numpy(feats), _jax_draws(key, shape[axis], param, 2), axis, value)
        assert np.array_equal(got1.numpy(), want1)


def test_freq_time_masks_shapes_and_bounds():
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 50, 24)).astype(np.float32)) + 10.0
    fm = ops.freq_mask(feats, torch.Generator().manual_seed(0), param=6, num_masks=2).numpy()
    assert fm.shape == tuple(feats.shape)
    zero_bins = (fm == 0.0).all(axis=(0, 1))
    assert 0 < zero_bins.sum() <= 12  # masked bands, bounded by 2 * param
    tm = ops.time_mask(feats, torch.Generator().manual_seed(0), param=8, num_masks=1).numpy()
    zero_frames = (tm == 0.0).all(axis=(0, 2))
    assert zero_frames.sum() <= 8
    sa = ops.spec_augment(feats, torch.Generator().manual_seed(0))
    assert torch.isfinite(sa).all()
    with pytest.raises(ValueError):
        ops.freq_mask(feats, torch.Generator(), param=-1)
    # every draw within its bounds, over many seeds
    for seed in range(200):
        for w, t0 in draw_masks(24, torch.Generator().manual_seed(seed), 10, 2):
            assert 0 <= w <= 10 and 0 <= t0 <= 24 - w


def test_masks_value_and_zero_masks():
    feats = torch.ones((4, 6))
    out = ops.time_mask(feats, torch.Generator().manual_seed(1), param=2, num_masks=1, value=-5.0).numpy()
    assert set(np.unique(out)) <= {1.0, -5.0}
    same = ops.time_mask(feats, torch.Generator().manual_seed(1), param=3, num_masks=0)
    np.testing.assert_array_equal(same.numpy(), np.ones((4, 6)))


def test_no_masks_leave_the_input_unchanged_and_draws_repeat():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 30, 16)).astype(np.float32))
    out = ops.spec_augment(x, torch.Generator().manual_seed(0), n_time_masks=0, n_freq_masks=0)
    assert torch.equal(out, x)
    a = ops.spec_augment(x, torch.Generator().manual_seed(7))
    b = ops.spec_augment(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and not torch.equal(a, x)
    # the frequency masks are drawn first, then the time masks, from one stream
    g = torch.Generator().manual_seed(7)
    f_draws = draw_masks(16, g, 10, 2)
    t_draws = draw_masks(30, g, 20, 2)
    assert torch.equal(a, apply_masks(apply_masks(x, f_draws, 2, 0.0), t_draws, 1, 0.0))
