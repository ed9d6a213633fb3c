"""The port's MFCC and mel/MFCC inversion against the JAX package on the CPU.

Inputs are seeded numpy fed to both packages; every matmul of the port is
fp32, the JAX side runs at precision "highest" where it takes one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import ops as jops
from audioflow_torch import ops as tops


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("n_in,n_out,norm", [(128, 13, "ortho"), (40, 40, "ortho"), (64, 20, None)])
def test_dct_matrix_bit_identical(n_in, n_out, norm):
    assert np.array_equal(tops.dct_matrix(n_in, n_out, norm), jops.dct_matrix(n_in, n_out, norm))


def test_mfcc_and_inverse_match_jax(rng):
    lm = rng.standard_normal((2, 7, 128)).astype(np.float32)
    got = tops.mfcc(torch.from_numpy(lm), 13)
    want = np.asarray(jops.mfcc(jnp.asarray(lm), 13))
    assert got.shape == want.shape == (2, 7, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    back = tops.mfcc_to_log_mel(got, n_mels=128).numpy()
    np.testing.assert_allclose(back, np.asarray(jops.mfcc_to_log_mel(jnp.asarray(want), n_mels=128)), rtol=0,
                               atol=1e-5)
    # the full basis is exact
    full = tops.mfcc_to_log_mel(tops.mfcc(torch.from_numpy(lm), 128), n_mels=128).numpy()
    np.testing.assert_allclose(full, lm, rtol=0, atol=1e-4)


def test_mel_to_stft_matches_jax(rng):
    fb = jops.mel_filterbank(513, 64, 16000)
    s = (rng.random((2, 20, 513)) ** 2).astype(np.float32)
    m = np.array(jops.apply_mel(jnp.asarray(s), fb))
    want = np.asarray(jops.mel_to_stft(jnp.asarray(m), fb, n_iter=8, precision="highest"))
    got = tops.mel_to_stft(torch.from_numpy(m), fb, n_iter=8)
    assert got.shape == want.shape and (got >= 0).all()
    m_got = tops.apply_mel(got, fb).numpy()
    assert _rel(m_got, np.asarray(jops.apply_mel(jnp.asarray(want), fb))) < 1e-4


def test_mel_nnls_rel(rng):
    """The JAX package's validate row (validate.py:376-385): 64 mels, 64
    iterations, the reconstruction's mel projection within 5e-3 of the target."""
    fb = tops.mel_filterbank(513, 64, 16000)
    s = torch.from_numpy((rng.random((20, 513)) ** 2).astype(np.float32))
    m = tops.apply_mel(s, fb)
    m_rec = tops.apply_mel(tops.mel_to_stft(m, fb, n_iter=64), fb)
    assert ((m_rec - m).abs().max() / m.max()).item() < 5e-3


def test_mel_to_audio_recovers_tone():
    sr = 16000
    x = torch.from_numpy((0.5 * np.sin(2 * np.pi * 440.0 * np.arange(sr) / sr)).astype(np.float32))
    fb = tops.mel_filterbank(513, 128, sr)
    m = tops.apply_mel(tops.power(tops.stft(x, 1024, 256)), fb)
    y = tops.mel_to_audio(m, fb, 1024, 256, nnls_iter=32, gl_iter=16, length=sr).numpy()
    assert y.shape == (sr,) and np.isfinite(y).all()
    sp = np.abs(np.fft.rfft(y[2000:14000] * np.hanning(12000)))
    peak = np.fft.rfftfreq(12000, 1 / sr)[sp.argmax()]
    assert abs(peak - 440.0) < 8.0, peak


def test_mfcc_to_audio_runs_finite(rng):
    sr = 16000
    x = torch.from_numpy((0.3 * rng.standard_normal(sr)).astype(np.float32))
    fb = tops.mel_filterbank(513, 64, sr)
    c = tops.mfcc(tops.log_mel(tops.power(tops.stft(x, 1024, 256)), fb), 13)
    y = tops.mfcc_to_audio(c.numpy(), fb, 1024, 256, gl_iter=4, nnls_iter=8, length=sr, device="cpu")
    assert y.shape == (sr,) and torch.isfinite(y).all()
    with pytest.raises(ValueError):
        tops.mfcc_to_audio(c, fb, log_base="log2")
