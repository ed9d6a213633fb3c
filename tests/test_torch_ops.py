"""The port's main-path ops against the JAX package on the CPU.

Host designs (windows, resample plans, DFT banks, mel filterbanks) must be
bit-identical, so that drift in the coefficients cannot hide a fault in a
kernel; the ops must agree within f32 rounding.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import ops as jops
from audioflow_torch import ops as tops
from audioflow_torch.ops import _mm
from audioflow_torch.ops.framing import frame, num_frames

# `ops.resample` and `ops.stft` name functions; fetch the modules
jrs, trs, jstft, tstft, jmel = (
    importlib.import_module(m)
    for m in (
        "audioflow_tpu.ops.resample", "audioflow_torch.ops.resample",
        "audioflow_tpu.ops.stft", "audioflow_torch.ops.stft", "audioflow_tpu.ops.mel",
    )
)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize(
    "name", ["rect", "hann", "hamming", "blackman", "blackmanharris", "povey", "kaiser:8.6"]
)
@pytest.mark.parametrize("periodic", [True, False])
def test_windows_bit_identical(name, periodic):
    assert np.array_equal(
        tops.get_window(name, 400, periodic), jops.get_window(name, 400, periodic)
    )


@pytest.mark.parametrize(
    "rates,mode", [((44100, 16000), "kaiser"), ((48000, 16000), "kaiser"), ((16000, 44100), "cubic")]
)
def test_resample_plan_bit_identical(rates, mode):
    a, b = trs.make_plan(*rates, mode), jrs.make_plan(*rates, mode)
    assert np.array_equal(a.matrix, b.matrix)
    assert (a.up, a.down, a.offset, a.block_out, a.ipb, a.k_taps) == (
        b.up, b.down, b.offset, b.block_out, b.ipb, b.k_taps
    )


@pytest.mark.parametrize("rates,chunk", [((44100, 16000), 14112), ((48000, 16000), 4608)])
def test_stream_plan_bit_identical(rates, chunk):
    a = trs.make_stream_plan(*rates, chunk_in=chunk)
    b = jrs.make_stream_plan(*rates, chunk_in=chunk)
    assert np.array_equal(a.matrix, b.matrix)
    assert (a.n0, a.hist, a.n_out_chunk, a.ipb, a.k_taps) == (b.n0, b.hist, b.n_out_chunk, b.ipb, b.k_taps)
    assert trs.stream_chunk_multiple(*rates) == jrs.stream_chunk_multiple(*rates)


@pytest.mark.parametrize("n_fft,window,win_length", [(1024, "hann", None), (512, "hamming", 400)])
def test_dft_banks_bit_identical(n_fft, window, win_length):
    tc, ts = tstft._dft_banks(n_fft, window, win_length)
    jc, js = jstft._dft_banks(n_fft, window, win_length)
    assert np.array_equal(tc, jc) and np.array_equal(ts, js)


@pytest.mark.parametrize(
    "args", [(513, 128, 16000), (257, 40, 22050, 20.0, 8000.0, True, None)]
)
def test_mel_filterbank_bit_identical(args):
    assert np.array_equal(tops.mel_filterbank(*args), jops.mel_filterbank(*args))
    f = [0.0, 700.0, 4000.0]
    assert np.array_equal(tops.hz_to_mel(f), jmel.hz_to_mel(f))
    assert np.array_equal(tops.mel_to_hz(f), jmel.mel_to_hz(f))


def test_frame_matches_jax(rng):
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    assert num_frames(3000, 1024, 300) == 7
    want = np.asarray(jops.frame(jnp.asarray(x), 1024, 300))
    np.testing.assert_array_equal(frame(_t(x), 1024, 300).numpy(), want)
    with pytest.raises(ValueError):
        frame(_t(x), 4096, 256)


@pytest.mark.parametrize("rates", [(44100, 16000), (48000, 16000), (16000, 16000)])
def test_resample_matches_jax(rng, rates):
    x = rng.standard_normal((2, 9000)).astype(np.float32)
    got = tops.resample(_t(x), *rates).numpy()
    want = np.asarray(jops.resample(jnp.asarray(x), *rates, precision="highest"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_resample_stream_step_matches_jax(rng):
    plan = trs.make_stream_plan(44100, 16000, chunk_in=14112)
    carry = rng.standard_normal((2, plan.hist)).astype(np.float32)
    chunk = rng.standard_normal((2, 14112)).astype(np.float32)
    c_t, y_t = trs.resample_stream_step(plan, _t(carry), _t(chunk))
    c_j, y_j = jrs.resample_stream_step(
        jrs.make_stream_plan(44100, 16000, chunk_in=14112), jnp.asarray(carry), jnp.asarray(chunk),
        precision="highest",
    )
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    assert trs.resample_stream_init(plan, (3,)).shape == (3, plan.hist)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("power", [True, False])
def test_spectrogram_matches_jax(rng, center, power):
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    got = tops.spectrogram(_t(x), 1024, 256, center=center, power=power).numpy()
    want = np.asarray(
        jops.spectrogram(jnp.asarray(x), 1024, 256, center=center, power=power, precision="highest")
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got / want.max(), want / want.max(), atol=1e-5)


def test_spectrogram_impl_names(rng):
    x = _t(rng.standard_normal(2048).astype(np.float32))
    want = tops.spectrogram(x, 512, 128)
    for impl in tstft.IMPLS:
        torch.testing.assert_close(tops.spectrogram(x, 512, 128, impl=impl), want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tops.spectrogram(x, 512, 128, impl="bogus")
    with pytest.raises(ValueError):
        tops.spectrogram(x, 512, 128, pad_mode="wrap")


@pytest.mark.parametrize("log_base", ["ln", "log10", "db"])
def test_log_mel_matches_jax(rng, log_base):
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    spec = np.asarray(jops.spectrogram(jnp.asarray(x), 1024, 256, center=False, precision="highest"))
    fb = jops.mel_filterbank(513, 128, 16000)
    got = tops.log_mel(_t(spec), fb, log_base=log_base).numpy()
    want = np.asarray(jops.log_mel(jnp.asarray(spec), fb, log_base=log_base))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        tops.apply_mel(_t(spec), fb).numpy(), np.asarray(jops.apply_mel(jnp.asarray(spec), fb)),
        rtol=1e-5, atol=1e-6 * float(np.abs(spec).max()),
    )
    with pytest.raises(ValueError):
        tops.log_mel(_t(spec), fb, log_base="log2")


def test_fp32_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    a = torch.ones(2, 3)
    for p in (None, *_mm.PRECISIONS):
        torch.testing.assert_close(_mm.mm(a, a.T, p), torch.full((2, 2), 3.0))
    with pytest.raises(ValueError):
        _mm.mm(a, a.T, "tf32")
