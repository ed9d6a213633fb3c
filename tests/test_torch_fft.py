"""Host designs of the redesigned kernels, on the CPU: the plain-torch model
of the shared-memory real FFT (``csrc/fft.cuh``) against ``torch.fft``, the
banded mel layout against the dense projection, the shape rules that pick
each kernel's path (melspec, griffinlim, timestretch) or cluster size
(viterbi), and each ``supported()`` against its predecessor on a grid. The
kernels themselves are tested on a card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from audioflow_torch.ops.kernels import fft, griffinlim, melspec, timestretch, viterbi
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
    tw64 = fft.twiddles(1024, np.float64)
    assert tw64.dtype == np.float64 and np.array_equal(tw64, np.stack([np.cos(ang), -np.sin(ang)], 1))
    assert np.array_equal(tw64.astype(np.float32), tw)


@pytest.mark.parametrize("n_fft", [16, 1024, 2048])
def test_rfft_model_in_float64_matches_torch(n_fft):
    """The fp64 forward transform of timestretch's analysis: the same
    algorithm with float64 values and twiddles, near float64 rounding."""
    x = torch.from_numpy(np.random.default_rng(n_fft + 2).standard_normal((3, n_fft)))
    got = fft.rfft(x, torch.from_numpy(fft.twiddles(n_fft, np.float64)))
    want = torch.fft.rfft(x)
    assert got.dtype == torch.complex128
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-13


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
    """Laid out once per filterbank tensor; an in-place edit is seen. The
    entries that pin this test's own ``fb`` leave the cache with it: the
    edit bumps ``fb``'s version, and a later check that every cached tensor
    is unwritten must not meet it."""
    fb = torch.from_numpy(mel_filterbank(257, 32, 16000))
    try:
        a = melspec._device_bands(fb)
        assert melspec._device_bands(fb)[0] is a[0]
        fb[:, 3] = 0.0
        layout, _, longest = melspec._device_bands(fb)
        assert layout[1, 3].item() == 0 and a[0][1, 3].item() > 0
        assert longest == int(layout[1].max())
    finally:
        drop_bands_of(fb)


def drop_bands_of(fb: torch.Tensor) -> None:
    """Remove the ``melspec._BANDS`` entries that pin ``fb`` (leaf 0)."""
    with melspec._BANDS._lock:
        for key in [k for k, v in melspec._BANDS._data.items() if v[0] is fb]:
            del melspec._BANDS._data[key]


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
    # the benchmark's stream step: a run a row of 20 frames (its 5,888
    # samples staged, and room for their 0-3 float offset), ten warps a block,
    # the slaney weights (longest band 24) staged; two blocks an SM
    assert melspec.fft_plan(1024, 256, 5888, 768, 128, 24) == (20, 1, 1, 10, 5892, 1, 115_376)
    assert melspec.dense_smem_bytes(400) == 38_464


@pytest.mark.parametrize("n_fft", [16, 32, 64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("hop_of", ["1", "100", "160", "256", "n_fft", "2 n_fft"])
def test_melspec_fft_plan_fits(n_fft, hop_of):
    """The FFT path's plan for every transform length and hop: runs of one
    frame or more, that cover each row, and a block within shared memory,
    for one-frame rows, the benchmark's rows, a 160,000-sample row and a
    600 s recording, with and without a carry, for a slaney-like bank and
    for a dense one (whose weights, at the larger n_fft, leave shared
    memory for device memory)."""
    hop = {"n_fft": n_fft, "2 n_fft": 2 * n_fft}.get(hop_of) or int(hop_of)
    bins = n_fft // 2 + 1
    for t, c in ((n_fft, 0), (5888, 768), (160_000, 0), (9_600_000, n_fft - 1)):
        for n_mels, max_band in ((128, min(24, bins)), (128, bins)):
            plan = melspec.fft_plan(n_fft, hop, max(t, n_fft), min(c, t), n_mels, max_band)
            n_frames = (max(t, n_fft) - n_fft) // hop + 1
            assert plan.frames >= 1 and plan.warps >= 1 and plan.group >= 1
            assert plan.runs_row * plan.frames >= n_frames > (plan.runs_row - 1) * plan.frames
            assert plan.stage >= (plan.frames - 1) * hop + n_fft + 3  # the span and its 0-3 float offset
            assert plan.smem <= 232_448, (t, c, n_mels, max_band, plan)


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


def test_timestretch_kernel_paths():
    """The FFT path for every power-of-two n_fft from 16 to 2048 at any hop
    that divides it, its blocks within shared memory, the dense path for the
    rest; the mirror of timestretch_path."""
    for n_fft in (16, 64, 256, 512, 1024, 2048):
        for hop in (1, 4, n_fft // 8, n_fft // 4, n_fft // 2, n_fft):
            assert timestretch.kernel_path(n_fft, hop) == "fft", (n_fft, hop)
            assert timestretch.smem_bytes(n_fft, hop) <= 232_448, (n_fft, hop)
    for n_fft, hop in ((960, 240), (501, 167), (400, 160), (1000, 250), (4096, 1024), (1024, 300)):
        assert timestretch.kernel_path(n_fft, hop) == "dense", (n_fft, hop)
    assert timestretch.fft_tile(1024, 256) == 16 and timestretch.smem_bytes(1024, 256) == 79_872  # fp64 analysis
    assert timestretch.fft_tile(2048, 2048) == 16 and timestretch.smem_bytes(2048, 2048) == 215_040
    assert timestretch.smem_bytes(960, 240) == 73_568  # the dense synthesis block's staged spectra


def _timestretch_supported_before(rate, n_fft, hop):
    """The predicate as the dense-only kernel had it: a rational rate with
    q <= 12, hop | n_fft, and both dense blocks within 227 KB."""
    if timestretch._rationalize(rate) is None or hop < 1 or n_fft < 2 or n_fft % hop:
        return False
    kpad = (n_fft // 2 + 1 + 3) & ~3
    return 4 * max(16 * ((n_fft + 3) & ~3), 2 * (16 + n_fft // hop - 1) * kpad) <= 232_448


def test_timestretch_supported_is_unchanged_or_wider():
    grid = [(n, h) for n in (16, 64, 256, 400, 501, 512, 960, 1000, 1024, 2048, 2400, 4096)
            for h in (1, 4, 8, 16, 64, 100, 128, 167, 240, 256, 512, 1024)]
    wider = 0
    for rate in (1.25, 0.5, 2.0 / 3.0, 9 / 5, np.pi / 2):
        for n_fft, hop in grid:
            before, now = _timestretch_supported_before(rate, n_fft, hop), timestretch.supported(rate, n_fft, hop)
            assert now or not before, (rate, n_fft, hop)
            wider += now and not before
    assert wider > 0  # small hops at power-of-two n_fft: the FFT path's blocks fit where the dense ones did not
    assert timestretch.supported(1.25, 2048, 16) and not timestretch.supported(1.25, 4096, 1024)


def test_viterbi_cluster_rule():
    """batch x C fills the 132 SMs, at most 8 blocks a row, each owning at
    least one bin; the mirror of viterbi_cluster."""
    for batch in (1, 2, 3, 16, 20, 33, 64, 66, 67, 131, 132, 200):
        for n_bins in (1, 5, 20, 94, 301, 602, 3000, 20_000):
            for taps in (1, 11, 29, 139, 255):
                c = viterbi.kernel_path(batch, n_bins, taps)
                assert 1 <= c <= 8 and (c <= max(1, 132 // batch) or n_bins > 14_000), (batch, n_bins, taps)
                nb = -(-n_bins // c)
                assert (c - 1) * nb < n_bins, (batch, n_bins, taps)  # every block owns a bin
                assert viterbi.smem_bytes(n_bins, taps, c) <= 232_448
    assert viterbi.kernel_path(64, 602, 139) == 2 and viterbi.kernel_path(1, 602, 139) == 8
    assert viterbi.kernel_path(132, 602, 139) == 1 and viterbi.kernel_path(20, 602, 139) == 6
    assert viterbi.kernel_path(1, 10, 11) == 5  # 2 bins a block
    assert viterbi.kernel_path(1, 0, 11) == 0 and viterbi.kernel_path(0, 10, 11) == 0
    assert viterbi.smem_bytes(602, 139) == 12_464 and viterbi.smem_bytes(602, 139, 2) == 7_664


def _viterbi_supported_before(n_bins, kernel_len):
    """The predicate as the one-block-per-row kernel had it."""
    return (kernel_len % 2 == 1 and 1 <= kernel_len <= 255 and n_bins >= 1
            and 4 * (4 * (n_bins + kernel_len - 1) + kernel_len) <= 232_448)


def test_viterbi_supported_is_unchanged_or_wider():
    for n_bins in (1, 2, 3, 7, 40, 94, 602, 3000, 10_000, 14_000, 14_500, 50_000, 120_000):
        for kernel_len in (1, 2, 11, 29, 138, 139, 255, 257):
            before, now = _viterbi_supported_before(n_bins, kernel_len), viterbi.supported(n_bins, kernel_len)
            assert now or not before, (n_bins, kernel_len)
            if kernel_len % 2 == 0 or kernel_len > 255:
                assert not now
    assert viterbi.supported(50_000, 139) and not _viterbi_supported_before(50_000, 139)
