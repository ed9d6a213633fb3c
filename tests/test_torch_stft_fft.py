"""``impl="fft"`` in the port is an FFT (``torch.fft``), as ``jnp.fft`` is in
the JAX package; every other impl name stays on the DFT banks.

The same seeded numpy inputs go through both packages on the CPU. Budgets:
the JAX validate's ``stft_magnitude`` row (max|Δ| over the peak < 1e-4,
``validate.py:72-76, 417-419``) for the transforms, and the time-stretch
tests' ``MATMUL_TOL`` for the stretch, whose absolute phase is summed in
fp32 in another order.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import ops as jops
from audioflow_torch import ops as tops
from audioflow_torch.ops._mm import mm
from audioflow_torch.ops.framing import frame

tstft = importlib.import_module("audioflow_torch.ops.stft")  # ops.stft names a function

# validate.py's stft_magnitude budget
STFT_TOL = 1e-4
# tests/test_torch_phase_vocoder.py: fp32 cumulative phase in another order
MATMUL_TOL = 2e-3


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def x():
    """tests/test_torch_phase_vocoder.py's signal: 2 x 1 s at 16 kHz, tones and noise."""
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    rows = [0.5 * np.sin(2 * np.pi * 523.0 * t) + 0.1 * rng.standard_normal(t.size),
            0.3 * np.sin(2 * np.pi * 240.0 * t) + 0.05 * rng.standard_normal(t.size)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("n_fft", [512, 1024])
@pytest.mark.parametrize("center", [True, False])
def test_stft_fft_matches_jax(x, n_fft, center):
    got = tops.stft(torch.from_numpy(x), n_fft, n_fft // 4, center=center)  # "fft" is the default
    want = np.asarray(jops.stft(jnp.asarray(x), n_fft, n_fft // 4, center=center, impl="fft"))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert _rel(got.numpy(), want) < STFT_TOL
    # the validate row's oracle: numpy's float64 rFFT of the windowed frames
    w = jops.get_window("hann", n_fft)
    xp = np.pad(x, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect") if center else x
    fr = np.stack([xp[:, i * (n_fft // 4) : i * (n_fft // 4) + n_fft] for i in range(got.shape[-2])], axis=1)
    assert _rel(got.abs().numpy(), np.abs(np.fft.rfft(fr.astype(np.float64) * w, axis=-1))) < STFT_TOL


@pytest.mark.parametrize("center", [True, False])
def test_istft_fft_matches_jax(x, center):
    spec = np.asarray(jops.stft(jnp.asarray(x), 1024, 256, center=center, impl="fft"))
    length = 16000 if center else None
    got = tops.istft(torch.from_numpy(spec), 1024, 256, center=center, length=length).numpy()
    want = np.asarray(jops.istft(jnp.asarray(spec), 1024, 256, center=center, length=length, impl="fft"))
    assert got.shape == want.shape
    # center=False keeps the edges, where the window-square sum falls to
    # 1e-10 and divides the rounding up: compare where it is whole
    edge = 0 if center else 1024
    assert _rel(got[:, edge : got.shape[-1] - edge], want[:, edge : want.shape[-1] - edge]) < STFT_TOL
    frames = tstft.frames_from_spec(torch.from_numpy(spec), 1024).numpy()
    np.testing.assert_array_equal(frames, torch.fft.irfft(torch.from_numpy(spec), 1024).numpy())


@pytest.mark.parametrize("power", [True, False])
def test_spectrogram_fft_matches_jax(x, power):
    got = tops.spectrogram(torch.from_numpy(x), 512, 128, power=power, impl="fft").numpy()
    want = np.asarray(jops.spectrogram(jnp.asarray(x), 512, 128, power=power, impl="fft"))
    assert got.shape == want.shape
    assert _rel(got, want) < STFT_TOL
    spec = tops.stft(torch.from_numpy(x), 512, 128)
    np.testing.assert_array_equal(got, (tops.power(spec) if power else spec.abs()).numpy())


@pytest.mark.parametrize("rate", [1.25, 0.5])
def test_time_stretch_fft_matches_jax(x, rate):
    got = tops.time_stretch(torch.from_numpy(x), rate, impl="fft").numpy()
    want = np.asarray(jops.time_stretch(jnp.asarray(x), rate, impl="fft"))
    assert got.shape == want.shape == (2, round(16000 / rate))
    assert _rel(got, want) < MATMUL_TOL
    # the FFT and the banks compute one function: the paths agree as closely
    mm_path = tops.time_stretch(torch.from_numpy(x), rate, impl="matmul").numpy()
    assert _rel(got, mm_path) < MATMUL_TOL


@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_griffin_lim_fft_one_iteration_matches_jax(x, momentum):
    """Elementwise, from a seeded random start phase: past the first
    magnitude replacement Griffin-Lim is chaotic, so one iteration only."""
    mag = tops.stft(torch.from_numpy(x), 1024, 256).abs().numpy()
    phase = np.random.default_rng(2).uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    want = np.asarray(jops.griffin_lim(jnp.asarray(mag), n_iter=1, momentum=momentum, impl="fft",
                                       init_phase=jnp.asarray(phase)))
    got = tops.griffin_lim(torch.from_numpy(mag), n_iter=1, momentum=momentum, impl="fft", init_phase=phase).numpy()
    assert got.shape == want.shape == (2, mag.shape[-2] * 256)
    assert _rel(got, want) <= 1e-4


def test_bank_names_compute_the_banks_bit_for_bit(x):
    """``matmul`` (and every other name but ``fft``) is the product with the
    window-folded banks, exactly."""
    xt = torch.from_numpy(x)
    frames = frame(tstft.pad_center(xt, 512), 512, 128)
    cosb, sinb = tstft.dft_banks(512, "hann", None, "cpu")
    re, im = mm(frames, cosb), mm(frames, sinb)
    for impl in ("matmul", "folded", "fourstep", "onedot", "radix2"):
        assert torch.equal(tops.stft(xt, 512, 128, impl=impl), torch.complex(re, im)), impl
        assert torch.equal(tops.spectrogram(xt, 512, 128, impl=impl), re * re + im * im), impl
    spec = torch.complex(re, im)
    ci, si = (torch.from_numpy(b) for b in tstft._idft_banks(512))
    assert torch.equal(tstft.frames_from_spec(spec, 512, impl="matmul"), mm(re, ci) + mm(im, si))
