"""The port's CUDA kernels on a card, against their plain torch versions.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so that a machine with only PyTorch runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from audioflow_torch.graph import GriffinLim, Pyin, Spectrogram, chain
from audioflow_torch.models import log_mel_frontend
from audioflow_torch.ops import griffin_lim, mel_to_audio, pitch_shift, pyin, stft, time_stretch
from audioflow_torch.ops.kernels import griffinlim, melspec, timestretch, viterbi
from audioflow_torch.ops.mel import mel_filterbank
from audioflow_torch.ops.stft import dft_banks, padded_window

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, n_fft, n_mels, window, device, win_length=None):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    cosb, sinb = dft_banks(n_fft, window, win_length, device)
    w = torch.from_numpy(padded_window(n_fft, window, win_length).astype(np.float32)).to(device)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, 16000)).to(device)
    return x, cosb, sinb, w, fb


# the stream step's shape (FFT path); an n_fft that is not a multiple of 4
# with an uneven hop (dense); Whisper's and Kaldi's 400 (dense); a 2048
# transform (FFT); one frame of the povey window; a zero-padded window
@pytest.mark.parametrize(
    "shape,n_fft,hop,n_mels,window,log,win_length,path",
    [
        ((64, 5888), 1024, 256, 128, "hann", "ln", None, "fft"),
        ((3, 4001), 502, 100, 40, "hamming", None, None, "dense"),
        ((3, 4000), 400, 160, 80, "hann", "ln", None, "dense"),
        ((2, 9000), 2048, 512, 64, "hann", "log10", None, "fft"),
        ((5, 1024), 1024, 256, 128, "povey", "ln", None, "fft"),
        ((3, 6000), 512, 160, 64, "hann", "db", 400, "fft"),
    ],
)
def test_kernel_matches_plain(cuda_device, shape, n_fft, hop, n_mels, window, log, win_length, path):
    x, cosb, sinb, w, fb = _inputs(shape, n_fft, n_mels, window, cuda_device, win_length)
    assert melspec.kernel_path(n_fft) == path
    before = melspec.COUNT.launches
    got = melspec.mel_spectrogram(x, cosb, sinb, w, fb, hop, log=log)
    torch.cuda.synchronize()
    assert melspec.COUNT.launches == before + 1
    want = melspec.mel_spectrogram_reference(x, cosb, sinb, fb, hop, log=log)
    assert got.shape == want.shape
    if log is None:
        got, want = got.log(), want.log()
    if log == "db":
        got, want = got / 10.0, want / 10.0
    # both fp32 with TF32 off; the sums are taken in another order
    assert (got - want).abs().max().item() <= 1e-4


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x, cosb, sinb, w, fb = _inputs((4, 5888), 1024, 128, "hann", cuda_device)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x[:, ::2], cosb, sinb, w, fb, 256)  # not contiguous
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x.double(), cosb.double(), sinb.double(), w.double(), fb.double(), 256)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x, cosb, sinb, w, fb.cpu(), 256)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x, cosb, sinb, w.cpu(), fb, 256)


def test_slice_on_card_matches_cpu(cuda_device):
    """The fused frontend streamed on the card (kernel) against the same
    graph on the CPU (plain version), every frame."""
    chunk = 14112
    x = np.random.default_rng(1).standard_normal((4, 3 * chunk)).astype(np.float32)
    g = log_mel_frontend(44100, 16000, 1024, 256, 128)
    before = melspec.COUNT.launches
    got = g.scan_stream(torch.from_numpy(x).to(cuda_device), chunk).cpu()
    assert melspec.COUNT.launches == before + 3
    want = g.scan_stream(torch.from_numpy(x), chunk)
    assert got.shape == want.shape == (4, 60, 128)
    assert (got - want).abs().max().item() <= 1e-3


def _tones(shape, seed=0):
    """Two tones plus noise per row: every bin carries signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    f = rng.uniform(100, 3000, (shape[0], 2))
    x = 0.4 * np.sin(2 * np.pi * f[:, :1] * t) + 0.2 * np.sin(2 * np.pi * f[:, 1:] * t)
    return (x + 0.05 * rng.standard_normal(shape)).astype(np.float32)


# the pvoc rate, slow-downs that take many output frames per input frame,
# a speed-up past 1 frame per step, a long hop, a length no hop divides, an
# odd n_fft, a rate that skips 11 frames per step, one row barely longer
# than the reflect padding
@pytest.mark.parametrize(
    "shape,rate,n_fft,hop",
    [
        ((4, 16000), 1.25, 1024, 256),
        ((4, 16000), 0.8, 1024, 256),
        ((3, 16000), 2.0 / 3.0, 1024, 256),
        ((3, 16000), 0.5, 1024, 256),
        ((3, 16000), 2.0, 1024, 256),
        ((2, 20011), 1.25, 2048, 512),
        ((2, 20011), 0.75, 2048, 512),
        ((2, 9001), 1.5, 512, 128),
        ((2, 6000), 0.75, 501, 167),
        ((2, 30000), 11.0, 1024, 256),
        ((1, 700), 1.25, 1024, 256),
    ],
)
def test_timestretch_kernel_matches_plain(cuda_device, shape, rate, n_fft, hop):
    x = torch.from_numpy(_tones(shape)).to(cuda_device)
    before = timestretch.COUNT.launches
    got = timestretch.time_stretch_fused(x, rate, n_fft, hop)
    torch.cuda.synchronize()
    assert timestretch.COUNT.launches == before + 1
    want = timestretch.time_stretch_reference(x, rate, n_fft, hop)
    assert got.shape == want.shape == (shape[0], round(shape[1] / rate))
    # every sample, tail included: both follow the kernel's tail convention;
    # fp32 sums in another order, carried through the phase product
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 1e-4, rel


def test_timestretch_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.from_numpy(_tones((2, 16000))).to(cuda_device)
    with pytest.raises(ValueError):
        timestretch.time_stretch_fused(x[:, ::2], 1.25)  # not contiguous
    with pytest.raises(ValueError):
        timestretch.time_stretch_fused(x.double(), 1.25)
    with pytest.raises(ValueError):
        timestretch.time_stretch_fused(x, 3.14159)  # not a small rational


def test_time_stretch_auto_takes_the_kernel(cuda_device):
    x = _tones((2, 16000))
    before = timestretch.COUNT.launches
    got = time_stretch(x, 1.25)  # numpy input goes to the card
    assert got.device.type == "cuda" and timestretch.COUNT.launches == before + 1
    time_stretch(x, 1.25, impl="matmul")
    time_stretch(x, 2 ** (7 / 12))  # not a small rational: the matmul path
    assert timestretch.COUNT.launches == before + 1


def test_time_stretch_takes_the_kernel_for_leading_axes(cuda_device):
    """[2, 3, T] goes through the kernel in one launch, rows flattened, and
    equals the kernel on the [6, T] view."""
    x = torch.from_numpy(_tones((6, 16000))).to(cuda_device)
    before = timestretch.COUNT.launches
    got = time_stretch(x.reshape(2, 3, -1), 1.25)
    torch.cuda.synchronize()
    assert timestretch.COUNT.launches == before + 1
    assert got.shape == (2, 3, 12800)
    want = timestretch.time_stretch_fused(x, 1.25)
    torch.testing.assert_close(got.reshape(6, -1), want, rtol=0, atol=0)


def test_pitch_shift_on_card_matches_cpu(cuda_device):
    """+12 semitones on the card (kernel at rate 1/2, then resample) against
    the CPU (matmul path, then resample): the two stretch paths accumulate
    phase in different forms and differ at the tail frame by convention, so
    this is the JAX package's kernel-vs-matmul gate (6e-3, validate.py)
    over all but the last 1024 samples."""
    x = _tones((2, 16000))
    before = timestretch.COUNT.launches
    got = pitch_shift(x, 12.0).cpu().numpy()
    assert timestretch.COUNT.launches == before + 1
    want = pitch_shift(x, 12.0, device="cpu").numpy()
    assert got.shape == want.shape == x.shape
    rel = np.abs(got - want)[:, :-1024].max() / np.abs(want).max()
    assert rel < 6e-3, rel


def _magnitude(shape, n_fft=1024, hop=256, device="cpu"):
    """|stft| of two tones plus noise per row, [rows, frames, n_fft//2 + 1]."""
    return stft(torch.from_numpy(_tones(shape)).to(device), n_fft, hop).abs().contiguous()


def _specconv(y, mag, n_fft=1024, hop=256):
    m2 = stft(y, n_fft, hop).abs()[..., : mag.shape[-2], :]
    return (torch.linalg.norm(m2 - mag) / torch.linalg.norm(mag)).item()


# the main path's n_fft and hop (FFT path, and more frames than one tile);
# k = 2 (FFT); a 2048 transform (FFT); the largest k the FFT path takes;
# an odd n_fft (dense); a hop of 16 (dense: 64 segments, taken in groups);
# one frame (FFT)
@pytest.mark.parametrize(
    "shape,n_fft,hop,path",
    [((3, 40000), 1024, 256, "fft"), ((2, 9001), 512, 256, "fft"), ((2, 20000), 2048, 512, "fft"),
     ((2, 9000), 1024, 64, "fft"), ((2, 6000), 501, 167, "dense"), ((1, 4096), 1024, 16, "dense"),
     ((2, 600), 1024, 256, "fft")],
)
def test_griffinlim_projection_matches_plain(cuda_device, shape, n_fft, hop, path):
    assert griffinlim.kernel_path(n_fft, hop) == path
    mag = _magnitude(shape, n_fft, hop, cuda_device)
    zeros = torch.zeros_like(mag)
    before = griffinlim.COUNT.launches
    got = griffinlim.griffin_lim_iteration(mag, zeros, mag, zeros, mag, 0.0, n_fft, hop)
    torch.cuda.synchronize()
    assert griffinlim.COUNT.launches == before + 1
    d = griffinlim.designs(n_fft, hop, "hann", mag.shape[1], cuda_device)
    want = griffinlim.griffin_lim_iteration_reference(mag, zeros, mag, zeros, mag, 0.0, d)
    # one projection is linear in the magnitude: fp32 sums in another order
    peak = torch.maximum(want[0].abs().max(), want[1].abs().max())
    for g, w in zip(got, want):
        assert g.shape == w.shape == mag.shape
        assert ((g - w).abs().max() / peak).item() <= 1e-5


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (501, 167)])
def test_griffinlim_is_deterministic(cuda_device, n_fft, hop):
    """Two launches on the same planes are bitwise equal: the overlap-add
    is summed in one fixed order, without atomics, on both paths."""
    mag = _magnitude((3, 40000), n_fft, hop, cuda_device)
    rng = np.random.default_rng(3)
    phase = torch.from_numpy(rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)).to(cuda_device)
    r_re, r_im = (mag * torch.cos(phase)).contiguous(), (mag * torch.sin(phase)).contiguous()
    a = griffinlim.griffin_lim_iteration(r_re, r_im, mag, torch.zeros_like(mag), mag, 0.99, n_fft, hop)
    b = griffinlim.griffin_lim_iteration(r_re, r_im, mag, torch.zeros_like(mag), mag, 0.99, n_fft, hop)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_griffinlim_iterations_match_plain(cuda_device):
    """8 iterations: kernel and plain version converge alike (elementwise
    comparison is meaningless past the first magnitude replacement)."""
    mag = _magnitude((4, 32000), device=cuda_device)
    before = griffinlim.COUNT.launches
    got = griffinlim.griffin_lim_fused(mag, n_iter=8)
    torch.cuda.synchronize()
    assert griffinlim.COUNT.launches == before + 8
    want = griffinlim.griffin_lim_reference(mag, n_iter=8)
    assert got.shape == want.shape == (4, mag.shape[1] * 256)
    assert abs(_specconv(got, mag) - _specconv(want, mag)) <= 0.02


def test_griffinlim_oracle_and_zeros(cuda_device):
    x = torch.from_numpy(_tones((2, 24000))).to(cuda_device)
    spec = stft(x, 1024, 256)
    y = griffin_lim(spec.abs(), n_iter=2, init_phase=spec.angle(), length=x.shape[-1])
    sl = slice(2048, x.shape[-1] - 2048)
    assert ((y[:, sl] - x[:, sl]).abs().max() / x.abs().max()).item() < 1e-3
    y = griffin_lim(torch.zeros(2, 12, 513, device=cuda_device), n_iter=3)
    assert torch.equal(y, torch.zeros_like(y))


def test_griffin_lim_auto_takes_the_kernel(cuda_device):
    """impl="auto" on the card: one launch per iteration whatever the rank,
    through the op, the node and mel_to_audio; the matmul path launches none."""
    mag = _magnitude((6, 16000))
    before = griffinlim.COUNT.launches
    y = griffin_lim(mag.numpy(), n_iter=3)  # numpy input goes to the card
    assert y.device.type == "cuda" and griffinlim.COUNT.launches == before + 3
    y3 = griffin_lim(mag.reshape(2, 3, *mag.shape[1:]).to(cuda_device), n_iter=3)
    assert griffinlim.COUNT.launches == before + 6 and y3.shape == (2, 3, y.shape[-1])
    torch.testing.assert_close(y3.reshape(6, -1), y, rtol=0, atol=0)
    griffin_lim(mag.to(cuda_device), n_iter=3, impl="matmul")
    assert griffinlim.COUNT.launches == before + 6
    g = chain(Spectrogram(512, 128, power=False), GriffinLim(512, 128, n_iter=4), input_rate=16000)
    g.compile()(_tones((2, 8000)))
    assert griffinlim.COUNT.launches == before + 10
    fb = mel_filterbank(513, 128, 16000)
    m = torch.matmul(mag.to(cuda_device) ** 2, torch.from_numpy(fb).to(cuda_device))
    mel_to_audio(m, fb, gl_iter=5, nnls_iter=4)
    assert griffinlim.COUNT.launches == before + 15


def test_griffinlim_kernel_rejects_what_it_does_not_take(cuda_device):
    mag = _magnitude((2, 8000), device=cuda_device)
    zeros = torch.zeros_like(mag)
    with pytest.raises(ValueError):
        griffinlim.griffin_lim_iteration(mag.double(), zeros, mag, zeros, mag)
    with pytest.raises(ValueError):
        griffinlim.griffin_lim_iteration(mag.transpose(0, 1), zeros, mag, zeros, mag)  # shapes differ
    with pytest.raises(ValueError):
        griffinlim.griffin_lim_iteration(mag, zeros, mag, zeros.cpu(), mag)  # devices differ
    with pytest.raises(ValueError):
        griffin_lim(mag, impl="pallas", n_iter=0)
    with pytest.raises(ValueError):
        griffin_lim(mag, 1024, 300, impl="pallas")


def _tie_heavy(shape, taps, seed=0, rising=False):
    """``(log_obs_v, log_obs_u, log_kernel, log_init, log_stay, log_switch)``
    all on a 0.5 grid, so that every sum is exact in f32 and ties abound: the
    unvoiced track constant per frame, as pYIN's is, with every fifth frame
    quiet so that the tracks switch; a flat-topped triangular log-kernel of
    ``taps`` taps, or with ``rising`` one that favours the farthest source
    above, so that offsets reach 2*half."""
    rng = np.random.default_rng(seed)
    ov = np.round(rng.uniform(-12, 0, shape) * 2) / 2
    ov[3::5] -= 10.0
    ou = np.broadcast_to(np.round(rng.uniform(-12, 0, shape[:-1] + (1,)) * 2) / 2, shape)
    half = taps // 2
    k = np.arange(2 * half + 1)
    lk = -np.round((2 * half - k if rising else np.abs(k - half)) / 8) / 2
    obs = (torch.from_numpy(a.astype(np.float32)) for a in (ov, np.ascontiguousarray(ou)))
    return (*obs, lk, -3.0, -0.5, -1.0)


# the 0.5-semitone band of the tests, the pYIN defaults' 139 taps (offsets
# past 127), and the widest band int8 offsets take
@pytest.mark.parametrize("shape,taps,rising", [((30, 3, 40), 11, False), ((40, 4, 300), 139, True),
                                               ((25, 2, 400), 255, False)])
def test_viterbi_kernel_matches_plain_exactly(cuda_device, shape, taps, rising):
    ov, ou, *args = _tie_heavy(shape, taps, rising=rising)
    before = viterbi.COUNT.launches
    got = viterbi.pyin_viterbi_forward(ov.to(cuda_device), ou.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert viterbi.COUNT.launches == before + 1
    want = viterbi.pyin_viterbi_forward_reference(ov.to(cuda_device), ou.to(cuda_device), *args)
    for name, g, w in zip(("dv", "du", "off", "pick"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    # both tracks switch somewhere; at 139 and 255 taps some offsets pass 127
    assert int(got[3][:, 0].max()) == 1 and int(got[3][:, 1].max()) == 1
    assert taps < 139 or int(got[2].max()) + taps // 2 > 127


def test_viterbi_kernel_takes_leading_axes(cuda_device):
    ov, ou, *args = _tie_heavy((20, 6, 100), 29, seed=1)
    ov, ou = ov.to(cuda_device), ou.to(cuda_device)
    before = viterbi.COUNT.launches
    got = viterbi.pyin_viterbi_forward(ov.reshape(20, 2, 3, 100), ou.reshape(20, 2, 3, 100), *args)
    assert viterbi.COUNT.launches == before + 1
    want = viterbi.pyin_viterbi_forward(ov, ou, *args)
    assert got[0].shape == (2, 3, 100) and got[2].shape == (20, 2, 2, 3, 100)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)
    one = viterbi.pyin_viterbi_forward(ov[:, 0], ou[:, 0], *args)  # [F, N]: one row
    assert one[0].shape == (100,) and torch.equal(one[2], want[2][:, :, 0])


def _vibrato(seconds=1.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.5 * np.sin(2 * np.pi * (220 + 8 * np.sin(2 * np.pi * 3 * t)) * t)
    x[6000:8000] = 0.001 * rng.standard_normal(2000)  # unvoiced gap
    return np.stack([x, np.roll(x, 1000)]).astype(np.float32)


def test_pyin_auto_takes_the_kernel(cuda_device):
    """pyin's defaults on the card: one launch per call, the decode equal to
    the plain scan's; the Pyin node the same through Graph.compile()."""
    x = _vibrato()
    before = viterbi.COUNT.launches
    f0, vf, vp = pyin(x, 16000)  # numpy goes to the card
    assert f0.device.type == "cuda" and viterbi.COUNT.launches == before + 1
    f0s, vfs, vps = pyin(x, 16000, viterbi_impl="xla")
    assert viterbi.COUNT.launches == before + 1
    assert torch.equal(f0, f0s) and torch.equal(vf, vfs) and torch.equal(vp, vps)
    pyin(torch.from_numpy(x).to(cuda_device), 16000, viterbi_impl="pallas", resolution=0.5)
    assert viterbi.COUNT.launches == before + 2
    out = chain(Pyin(), input_rate=16000).compile()(x)
    assert viterbi.COUNT.launches == before + 3
    assert out.shape == (2, f0.shape[-1], 3) and torch.equal(out[..., 0], f0)


def test_viterbi_kernel_rejects_what_it_does_not_take(cuda_device):
    ov, ou, lk, *_ = _tie_heavy((5, 2, 50), 11)
    ov, ou = ov.to(cuda_device), ou.to(cuda_device)
    with pytest.raises(ValueError):
        viterbi.pyin_viterbi_forward(ov, ou, np.zeros(10), -5.0, -0.01, -4.6)  # even taps
    with pytest.raises(ValueError):
        viterbi.pyin_viterbi_forward(ov, ou, np.zeros(257), -5.0, -0.01, -4.6)  # over int8
    with pytest.raises(ValueError):
        viterbi.pyin_viterbi_forward(ov.double(), ou.double(), lk, -5.0, -0.01, -4.6)
    with pytest.raises(ValueError):
        viterbi.pyin_viterbi_forward(ov, ou.cpu(), lk, -5.0, -0.01, -4.6)
    with pytest.raises(ValueError):  # 277 taps at 0.05 semitones
        pyin(_vibrato(0.5), 16000, resolution=0.05, viterbi_impl="pallas")
