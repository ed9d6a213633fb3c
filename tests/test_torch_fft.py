"""Host designs of the redesigned melspec and griffinlim kernels, on the CPU:
the plain-torch model of the shared-memory real FFT (``csrc/fft.cuh``)
against ``torch.fft``, the banded mel layout against the dense projection,
and the shape rules that pick each kernel's path. The kernels themselves
are tested on a card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from audioflow_torch.ops.kernels import fft, griffinlim, melspec
from audioflow_torch.ops.mel import mel_filterbank

SIZES = [16, 32, 64, 128, 256, 512, 1024, 2048]


@pytest.mark.parametrize("n_fft", SIZES)
def test_rfft_model_matches_torch(n_fft):
    rng = np.random.default_rng(n_fft)
    x = torch.from_numpy(rng.standard_normal((3, n_fft)).astype(np.float32))
    got = fft.rfft(x, torch.from_numpy(fft.twiddles(n_fft)))
    want = torch.fft.rfft(x.double())
    assert got.shape == want.shape == (3, n_fft // 2 + 1)
    # fp32 twiddles and sums over log2(n) passes, against float64
    assert ((got.to(torch.complex128) - want).abs().max() / want.abs().max()).item() <= 1e-6


@pytest.mark.parametrize("n_fft", SIZES)
def test_irfft_model_matches_torch(n_fft):
    """Nonzero imaginary parts at DC and Nyquist are ignored, as the bank
    form's near-zero sine rows ignore them."""
    rng = np.random.default_rng(n_fft + 1)
    n_bins = n_fft // 2 + 1
    spec = rng.standard_normal((3, n_bins)) + 1j * rng.standard_normal((3, n_bins))
    assert np.all(spec[:, [0, -1]].imag != 0)
    got = fft.irfft(torch.from_numpy(spec.astype(np.complex64)), torch.from_numpy(fft.twiddles(n_fft)))
    real_ends = spec.copy()
    real_ends[:, [0, -1]] = real_ends[:, [0, -1]].real
    want = torch.fft.irfft(torch.from_numpy(real_ends), n_fft)
    assert got.shape == want.shape == (3, n_fft)
    assert ((got.double() - want).abs().max() / want.abs().max()).item() <= 1e-6


def test_twiddles_are_rounded_float64_designs():
    tw = fft.twiddles(1024)
    ang = 2.0 * np.pi * np.arange(512) / 1024
    assert tw.dtype == np.float32 and tw.shape == (512, 2)
    assert np.array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    assert np.array_equal(tw[:, 1], (-np.sin(ang)).astype(np.float32))


def _project(p: torch.Tensor, fb: np.ndarray) -> torch.Tensor:
    """The kernel's banded projection of power rows ``p [F, n_bins]``, from
    the layout of :func:`melspec.mel_bands` alone."""
    layout, wts = melspec.mel_bands(fb)
    out = torch.zeros(p.shape[0], fb.shape[1])
    for m, (lo, count, off) in enumerate(layout.T):
        out[:, m] = p[:, lo : lo + count] @ torch.from_numpy(wts[off : off + count])
    return out


def _filterbanks():
    rng = np.random.default_rng(0)
    empty = mel_filterbank(513, 40, 16000)
    empty[:, 7] = 0.0
    empty[:, -1] = 0.0
    return {
        "slaney": mel_filterbank(513, 128, 16000),
        "htk": mel_filterbank(257, 64, 22050, htk=True, norm=None),
        "dense": rng.standard_normal((201, 80)).astype(np.float32),
        "empty_band": empty,
    }


@pytest.mark.parametrize("name", ["slaney", "htk", "dense", "empty_band"])
def test_banded_projection_matches_dense(name):
    fb = _filterbanks()[name].astype(np.float32)
    p = torch.from_numpy(np.random.default_rng(1).uniform(0, 10, (6, fb.shape[0])).astype(np.float32))
    got, want = _project(p, fb), p @ torch.from_numpy(fb)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6
    layout, wts = melspec.mel_bands(fb)
    assert wts.size == layout[1].sum()
    if name == "slaney":  # each band a contiguous run: 1,009 weights of 65,664
        assert wts.size == 1009 and layout[1].max() <= 24
    if name == "dense":
        assert np.all(layout[1] == fb.shape[0])
    if name == "empty_band":
        assert layout[1, 7] == 0 and layout[1, -1] == 0 and torch.equal(got[:, 7], torch.zeros(6))


def test_device_bands_follow_the_tensor():
    """Laid out once per filterbank tensor; an in-place edit is seen."""
    fb = torch.from_numpy(mel_filterbank(257, 32, 16000))
    a = melspec._device_bands(fb)
    assert melspec._device_bands(fb)[0] is a[0]
    fb[:, 3] = 0.0
    layout, _ = melspec._device_bands(fb)
    assert layout[1, 3].item() == 0 and a[0][1, 3].item() > 0


def test_kernel_paths():
    """The FFT path for the main paths' shapes and every power-of-two
    transform, the dense path for the rest."""
    for n_fft in (1024, 512, 2048, 16):
        assert melspec.kernel_path(n_fft) == "fft"
    for n_fft in (400, 501, 502, 8, 4096):
        assert melspec.kernel_path(n_fft) == "dense"
    for n_fft, hop in ((1024, 256), (512, 256), (2048, 512), (1024, 64), (2048, 1024)):
        assert griffinlim.kernel_path(n_fft, hop) == "fft", (n_fft, hop)
    for n_fft, hop in ((501, 167), (1024, 16), (1024, 32), (400, 100)):
        assert griffinlim.kernel_path(n_fft, hop) == "dense", (n_fft, hop)
    assert griffinlim.fft_tile(1024, 256) == 16 and griffinlim.smem_bytes(1024, 256) == 57_344
    assert griffinlim.smem_bytes(2048, 1024) <= 232_448  # the largest rows fit
    assert melspec.fft_frames(1024) == 8 and melspec.smem_bytes(1024) == 37_888


def _supported_before(n_fft, hop, win_length=None):
    """The predicate as the dense-only kernel had it: full window, hop |
    n_fft with k >= 2, and both dense blocks within 227 KB."""
    if win_length not in (None, n_fft) or hop < 1 or n_fft < 2 or n_fft % hop or n_fft // hop < 2:
        return False
    kpad = (n_fft // 2 + 1 + 3) & ~3
    group = min(n_fft // hop, 232_448 // (8 * kpad) - 16 + 1)
    smem = 4 * max(16 * ((n_fft + 3) & ~3), 2 * (16 + group - 1) * kpad)
    return group >= 1 and smem <= 232_448


def test_griffinlim_supported_is_unchanged():
    grid = [(n, h) for n in (16, 64, 256, 400, 501, 512, 1024, 2048, 2400, 3600, 4096)
            for h in (1, 4, 8, 16, 64, 100, 128, 167, 256, 512, 1024)]
    for n_fft, hop in grid:
        assert griffinlim.supported(n_fft, hop) == _supported_before(n_fft, hop), (n_fft, hop)
    assert not griffinlim.supported(1024, 256, win_length=800)
