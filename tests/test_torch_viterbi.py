"""The port's banded max-plus steps and the pYIN Viterbi forward pass
against the JAX package on the CPU.

On the CPU the kernel's wrapper runs its plain version, which is held
against the JAX Pallas kernel in interpret mode: the forward pass adds and
compares only, so every output is exactly equal, ties included. Inputs are
seeded numpy; tie-heavy cases put every value on a 0.5 grid, where f32 sums
are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu.ops import pitch as jpitch
from audioflow_tpu.ops import sequence as jseq
from audioflow_tpu.ops.pallas import viterbi as jvit
from audioflow_torch import ops as tops
from audioflow_torch.ops import pitch as tpitch
from audioflow_torch.ops import sequence as tseq
from audioflow_torch.ops.kernels import viterbi as tvit

SR = 16000


def _tie_heavy(shape, taps, seed=0, rising=False):
    """``(log_obs_v, log_obs_u, log_kernel, log_init, log_stay, log_switch)``
    on a 0.5 grid: the unvoiced track constant per frame, as pYIN's is, every
    fifth frame quiet so that the tracks switch, a flat-topped triangular
    log-kernel or, with ``rising``, one that favours the farthest source
    above, so that offsets reach 2*half."""
    rng = np.random.default_rng(seed)
    ov = np.round(rng.uniform(-12, 0, shape) * 2) / 2
    ov[3::5] -= 10.0
    ou = np.broadcast_to(np.round(rng.uniform(-12, 0, shape[:-1] + (1,)) * 2) / 2, shape)
    half = taps // 2
    k = np.arange(2 * half + 1)
    lk = -np.round((2 * half - k if rising else np.abs(k - half)) / 8) / 2
    return ov.astype(np.float32), np.ascontiguousarray(ou, np.float32), lk, -3.0, -0.5, -1.0


def _vibrato(seed=0):
    """The 1 s vibrato with an unvoiced gap of the JAX package's exactness
    test (``tests/test_pitch.py:420-426``), and a copy shifted by 1000."""
    rng = np.random.default_rng(seed)
    t = np.arange(SR) / SR
    x = (0.5 * np.sin(2 * np.pi * (220 + 8 * np.sin(2 * np.pi * 3 * t)) * t)).astype(np.float32)
    x[6000:8000] = 0.001 * rng.standard_normal(2000)
    return np.stack([x, np.roll(x, 1000)])


@pytest.mark.parametrize("quantised", [False, True])
def test_max_plus_band_matches_jax(quantised):
    rng = np.random.default_rng(3)
    delta = rng.standard_normal((3, 50)).astype(np.float32)
    lk = np.log(np.linspace(0.2, 1.0, 11)).astype(np.float32)
    if quantised:  # force ties within the band
        delta = np.round(delta * 2) / 2
        lk = -np.round(np.abs(np.arange(-5, 6)) / 4) / 2
    lk = lk.astype(np.float32)
    got_b, got_a = tseq.max_plus_band_argmax(torch.from_numpy(delta), torch.from_numpy(lk))
    want_b, want_a = jseq.max_plus_band_argmax(jnp.asarray(delta), jnp.asarray(lk))
    assert got_a.dtype == torch.int16
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(
        tops.max_plus_band(torch.from_numpy(delta), torch.from_numpy(lk)).numpy(),
        np.asarray(jseq.max_plus_band(jnp.asarray(delta), jnp.asarray(lk))),
    )
    with pytest.raises(ValueError):
        tseq.max_plus_band(torch.from_numpy(delta), torch.zeros(4))


def test_transition_local_bit_identical():
    for n, width in [(7, 3), (30, 8), (5, 11)]:
        assert np.array_equal(tops.transition_local(n, width), jseq.transition_local(n, width))
    with pytest.raises(ValueError):
        tops.transition_local(0, 3)


def _assert_forward_equal(got, want):
    for name, g, w in zip(("dv", "du", "off", "pick"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# (a) tie-heavy with 11 taps; (b) 139 taps, offsets past 127
@pytest.mark.parametrize("shape,taps,rising", [((30, 3, 40), 11, False), ((12, 1, 150), 139, True)])
def test_reference_matches_pallas_kernel_exactly(shape, taps, rising):
    ov, ou, lk, *consts = _tie_heavy(shape, taps, rising=rising)
    got = tvit.pyin_viterbi_forward(torch.from_numpy(ov), torch.from_numpy(ou), lk, *consts)
    want = jvit.pyin_viterbi_forward(jnp.asarray(ov), jnp.asarray(ou), lk, *consts, interpret=True)
    _assert_forward_equal(got, want)
    assert int(got[3][:, 0].max()) == 1 and int(got[3][:, 1].max()) == 1  # both tracks switch
    if taps == 139:
        assert int(got[2].max()) + taps // 2 > 127


def test_reference_matches_pallas_kernel_on_pyin_observations():
    """(c) the JAX package's own observations of the vibrato pair at 0.5
    semitones and 32 thresholds (29 taps): real data, exactly equal."""
    fr = jpitch.frame(jnp.pad(jnp.asarray(_vibrato()), ((0, 0), (1024, 1024)), mode="reflect"), 2048, 256)
    obs_v, vprob, *_, n_bins, nbps = jpitch._pyin_observations(
        fr, SR, 80.0, 1200.0, resolution=0.5, n_thresholds=32
    )
    lv, lu = (np.moveaxis(np.array(a), -2, 0) for a in jpitch._pyin_log_obs(obs_v, vprob, n_bins))
    half, lk, _, _ = jpitch._pyin_hmm_consts(SR, 256, nbps, 35.92, 0.01, jnp.float32)
    consts = (-np.log(2 * n_bins), float(np.log1p(-0.01)), float(np.log(0.01)))
    assert lv.shape == (63, 2, 94) and 2 * half + 1 == 29
    got = tvit.pyin_viterbi_forward(torch.from_numpy(lv), torch.from_numpy(lu), np.asarray(lk), *consts)
    want = jvit.pyin_viterbi_forward(jnp.asarray(lv), jnp.asarray(lu), np.asarray(lk), *consts, interpret=True)
    _assert_forward_equal(got, want)


def test_wrapper_flattens_leading_axes():
    ov, ou, *args = _tie_heavy((15, 6, 60), 21, seed=2)
    want = tvit.pyin_viterbi_forward(torch.from_numpy(ov), torch.from_numpy(ou), *args)
    got = tvit.pyin_viterbi_forward(torch.from_numpy(ov).reshape(15, 2, 3, 60),
                                    torch.from_numpy(ou).reshape(15, 2, 3, 60), *args)
    assert got[0].shape == (2, 3, 60) and got[2].shape == (15, 2, 2, 3, 60)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)
    one = tvit.pyin_viterbi_forward(torch.from_numpy(ov[:, 0]), torch.from_numpy(ou[:, 0]), *args)
    assert one[0].shape == (60,) and torch.equal(one[2], want[2][:, :, 0])
    with pytest.raises(ValueError):
        tvit.pyin_viterbi_forward(torch.from_numpy(ov).double(), torch.from_numpy(ou).double(), *args)
    with pytest.raises(ValueError):
        tvit.pyin_viterbi_forward(torch.from_numpy(ov), torch.from_numpy(ou[:-1]), *args)
    with pytest.raises(ValueError):
        tvit.pyin_viterbi_forward(torch.from_numpy(ov), torch.from_numpy(ou), np.zeros(4), *args[1:])


def test_supported_accepts_every_jax_configuration():
    """The port's predicate adds shared memory to the JAX one's; on a grid
    of bands and bin counts, everything JAX takes the port takes."""
    n_jax = 0
    for n_bins in (1, 2, 40, 94, 318, 469, 602, 1000, 3000, 6000):
        for kernel_len in range(1, 300, 2):
            if jvit.supported(n_bins, kernel_len):
                n_jax += 1
                assert tvit.supported(n_bins, kernel_len), (n_bins, kernel_len)
        for kernel_len in (2, 138, 257, 277):
            assert not tvit.supported(n_bins, kernel_len)
    assert n_jax > 1000
    # a row split over a cluster of 8 blocks takes 20,000 bins; 200,000 do not fit
    assert not tvit.supported(0, 11) and tvit.supported(20000, 139) and not tvit.supported(200_000, 139)
    assert tvit.smem_bytes(602, 139) < 48 * 1024


@pytest.mark.parametrize("n_samples,resolution,n_thresholds,batched", [(4096, 0.1, 16, False), (SR, 0.5, 32, True)])
def test_scan_equals_the_kernel_path(n_samples, resolution, n_thresholds, batched):
    """The port's plain scan ("xla") and its kernel wrapper ("pallas", the
    plain version here) decode the same observations identically."""
    x = _vibrato()[:, :n_samples] if batched else _vibrato()[0, :n_samples]
    kw = dict(resolution=resolution, n_thresholds=n_thresholds, device="cpu")
    a = tops.pyin(x, SR, 80, 1200, viterbi_impl="xla", **kw)
    b = tops.pyin(x, SR, 80, 1200, viterbi_impl="pallas", **kw)
    c = tops.pyin(x, SR, 80, 1200, **kw)  # "auto" on the CPU: the scan
    for name, av, bv, cv in zip(("f0", "vflag", "vprob"), a, b, c):
        assert torch.equal(av, bv) and torch.equal(av, cv), name
    assert a[0].shape == x.shape[:-1] + (n_samples // 256 + 1,)


def test_viterbi_impl_validation():
    x = np.zeros(8000, np.float32)
    with pytest.raises(ValueError, match="viterbi impl"):
        tops.pyin(x, SR, 80, 1200, viterbi_impl="nope", device="cpu")
    with pytest.raises(ValueError, match="pallas"):  # 277 taps at 0.05 semitones
        tops.pyin(x, SR, resolution=0.05, viterbi_impl="pallas", device="cpu")
    assert tpitch._pyin_hmm_consts(SR, 256, 20, 35.92, 0.01)[0] == 138
    # a band too wide for the kernel still decodes under "auto" (the scan)
    f0, vf, vp = tops.pyin(x[:4096], SR, 200, 400, resolution=0.05, n_thresholds=8, device="cpu")
    assert f0.shape == (17,) and not vf.any()
