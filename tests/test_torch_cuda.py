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
from audioflow_torch.ops import griffin_lim, istft, mel_to_audio, pitch_shift, pyin, stft, time_stretch
from audioflow_torch.ops.kernels import griffinlim, melspec, timestretch, viterbi
from audioflow_torch.ops.kernels import resample as resample_kernel
from audioflow_torch.ops.mel import mel_filterbank
from audioflow_torch.ops.resample import make_stream_plan, resample_stream_step_reference
from audioflow_torch.ops.stft import dft_banks, padded_window
from logging_guard import restore_audioflow_logger  # noqa: F401  (autouse)

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
# transform (FFT); one frame of the povey window; a zero-padded window. The
# FFT path's staged runs: a 160,000-sample row (32 runs a row); 1,000 rows,
# which no grid of two blocks an SM divides; hop > n_fft (a run a frame);
# hops that are not multiples of 4; n_fft 16, whose 8 mels hold an empty
# column, and one frame a row (several rows a step)
@pytest.mark.parametrize(
    "shape,n_fft,hop,n_mels,window,log,win_length,path",
    [
        ((64, 5888), 1024, 256, 128, "hann", "ln", None, "fft"),
        ((3, 4001), 502, 100, 40, "hamming", None, None, "dense"),
        ((3, 4000), 400, 160, 80, "hann", "ln", None, "dense"),
        ((2, 9000), 2048, 512, 64, "hann", "log10", None, "fft"),
        ((5, 1024), 1024, 256, 128, "povey", "ln", None, "fft"),
        ((3, 6000), 512, 160, 64, "hann", "db", 400, "fft"),
        ((2, 160000), 1024, 256, 128, "hann", "ln", None, "fft"),
        ((1000, 5888), 1024, 256, 128, "hann", "ln", None, "fft"),
        ((3, 9000), 512, 700, 64, "hann", "ln", None, "fft"),
        ((4, 7001), 1024, 259, 128, "hann", "ln", None, "fft"),
        ((3, 4001), 2048, 250, 128, "hann", "ln", None, "fft"),
        ((3, 400), 16, 3, 8, "hann", "ln", None, "fft"),
        ((9, 16), 16, 4, 4, "hamming", None, None, "fft"),
    ],
)
def test_kernel_matches_plain(cuda_device, shape, n_fft, hop, n_mels, window, log, win_length, path):
    x, cosb, sinb, w, fb = _inputs(shape, n_fft, n_mels, window, cuda_device, win_length)
    assert melspec.kernel_path(n_fft) == path
    before = melspec.COUNT.launches, melspec.COUNT.carry_launches, melspec.COUNT.staged_launches
    got = melspec.mel_spectrogram(x, cosb, sinb, w, fb, hop, log=log)
    torch.cuda.synchronize()
    # one launch, which reads no carry; an FFT-path launch takes the staged runs
    assert (melspec.COUNT.launches, melspec.COUNT.carry_launches, melspec.COUNT.staged_launches) == (
        before[0] + 1, before[1], before[2] + (path == "fft"))
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
    spec = melspec.prepare(cosb, sinb, w, fb, 256)
    carry, chunk = x[:, :768].contiguous(), x[:, 768:]
    with pytest.raises(ValueError, match="float32"):
        spec.step(carry.double(), chunk.double())
    with pytest.raises(ValueError):
        spec.step(carry.cpu(), chunk)
    with pytest.raises(ValueError, match="lead axes"):
        spec.step(carry[:2], chunk)
    with pytest.raises(ValueError, match="shorter than n_fft"):
        spec.step(carry[:, :100], chunk[:, :100])


def test_slice_on_card_matches_cpu(cuda_device):
    """The fused frontend streamed on the card (kernel) against the same
    graph on the CPU (plain version), every frame."""
    chunk = 14112
    x = np.random.default_rng(1).standard_normal((4, 3 * chunk)).astype(np.float32)
    g = log_mel_frontend(44100, 16000, 1024, 256, 128)
    before, before_carry = melspec.COUNT.launches, melspec.COUNT.carry_launches
    got = g.scan_stream(torch.from_numpy(x).to(cuda_device), chunk).cpu()
    assert melspec.COUNT.launches == before + 3
    assert melspec.COUNT.carry_launches == before_carry + 3  # each step reads its carry in place
    want = g.scan_stream(torch.from_numpy(x), chunk)
    assert got.shape == want.shape == (4, 60, 128)
    assert (got - want).abs().max().item() <= 1e-3


# --- the melspec kernel's stream step: [carry | chunk] read in place ---


def _carry_and_chunk(rows, carry_len, n, width, device, seed=0):
    """A carry ``[rows, carry_len]`` and a chunk that is the first n columns
    of ``[rows, width]``: rows ``width`` apart, a narrow view where width > n."""
    rng = np.random.default_rng(seed)
    carry = torch.from_numpy(rng.standard_normal((rows, carry_len)).astype(np.float32)).to(device)
    wide = torch.from_numpy(rng.standard_normal((rows, width)).astype(np.float32)).to(device)
    return carry, wide[:, :n]


# the cell's step (768 carried + 5120 new samples at n_fft 1024) with the
# chunk a narrow view of rows 5,359, 5,376, 5,377 and 5,378 apart (each
# row's chunk 3, 0, 1 and 2 floats, in turn, off a 16-byte boundary; odd, as
# graph.align's buffer leaves it); a chunk shorter than the carry; n_fft 400,
# hop 160 (the dense path) on a narrow view and on a short chunk. The FFT
# path's staged runs: 1,000 rows, which no grid of two blocks an SM divides;
# rows of four runs; carries shorter than n_fft - hop (n_fft 1024 and 2048);
# hop > n_fft (a run a frame), with a carry inside the last run's span and
# one that starts before it; n_fft 16 at an odd hop
@pytest.mark.parametrize(
    "rows,carry_len,n,width,n_fft,hop,n_mels,path",
    [
        (2048, 768, 5120, 5359, 1024, 256, 128, "fft"),
        (2048, 768, 5120, 5376, 1024, 256, 128, "fft"),
        (64, 768, 256, 256, 1024, 256, 128, "fft"),
        (64, 320, 1600, 1759, 400, 160, 80, "dense"),
        (64, 320, 160, 160, 400, 160, 80, "dense"),
        (2048, 768, 5120, 5377, 1024, 256, 128, "fft"),
        (2048, 768, 5120, 5378, 1024, 256, 128, "fft"),
        (1000, 768, 5120, 5359, 1024, 256, 128, "fft"),
        (16, 768, 20000, 20001, 1024, 256, 128, "fft"),
        (64, 100, 5120, 5121, 1024, 256, 128, "fft"),
        (8, 768, 5120, 5123, 2048, 512, 64, "fft"),
        (64, 1000, 3000, 3001, 512, 700, 64, "fft"),
        (16, 3000, 1000, 1002, 512, 700, 64, "fft"),
        (8, 15, 100, 103, 16, 3, 8, "fft"),
    ],
)
def test_carry_launch_matches_plain(cuda_device, rows, carry_len, n, width, n_fft, hop, n_mels, path):
    _, cosb, sinb, w, fb = _inputs((1, n_fft), n_fft, n_mels, "hann", cuda_device)
    assert melspec.kernel_path(n_fft) == path
    carry, chunk = _carry_and_chunk(rows, carry_len, n, width, cuda_device)
    assert chunk.stride(0) == width
    spec = melspec.prepare(cosb, sinb, w, fb, hop)
    before = melspec.COUNT.launches, melspec.COUNT.carry_launches, melspec.COUNT.staged_launches
    new_carry, got = spec.step(carry, chunk)
    torch.cuda.synchronize()
    assert (melspec.COUNT.launches, melspec.COUNT.carry_launches, melspec.COUNT.staged_launches) == (
        before[0] + 1, before[1] + 1, before[2] + (path == "fft"))
    buf = torch.cat([carry, chunk], dim=-1)
    # each frame's arithmetic is the offline launch's on the concatenation
    assert torch.equal(_bits(got), _bits(spec(buf)))
    assert torch.equal(_bits(new_carry), _bits(buf[:, -carry_len:]))
    want = melspec.mel_spectrogram_reference(buf, cosb, sinb, fb, hop)
    assert got.shape == want.shape == (rows, (carry_len + n - n_fft) // hop + 1, n_mels)
    # both fp32 with TF32 off; the sums are taken in another order. The dense
    # path sums each bin's n_fft products in a row where cuBLAS tiles them:
    # over 64 rows of white noise its largest gap in ln units read 1.7e-4,
    # at bins far below their frame's loudest
    assert (got - want).abs().max().item() <= (1e-4 if path == "fft" else 5e-4)


def test_carry_launch_repeats_its_bits(cuda_device):
    """Two launches on the same inputs give the same bits: each frame's
    FFT and band sums run in one fixed order, whichever block and warp take
    it, and nothing is atomic."""
    _, cosb, sinb, w, fb = _inputs((1, 1024), 1024, 128, "hann", cuda_device)
    spec = melspec.prepare(cosb, sinb, w, fb, 256)
    carry, chunk = _carry_and_chunk(1000, 768, 5120, 5359, cuda_device, seed=3)
    first = spec.step(carry, chunk)
    second = spec.step(carry, chunk)
    for a, b in zip(first, second):
        assert torch.equal(_bits(a), _bits(b))


def test_carry_launch_new_carry_is_its_own(cuda_device):
    """The new carry is a fresh tensor: writing into the chunk's buffer after
    the step changes neither it nor the next step's output."""
    _, cosb, sinb, w, fb = _inputs((1, 1024), 1024, 128, "hann", cuda_device)
    spec = melspec.prepare(cosb, sinb, w, fb, 256)
    carry, chunk = _carry_and_chunk(64, 768, 256, 512, cuda_device, seed=1)  # the new carry spans both segments
    _, nxt = _carry_and_chunk(64, 768, 5120, 5120, cuda_device, seed=2)
    new_carry, _ = spec.step(carry, chunk)
    kept = new_carry.clone()
    want = spec.step(kept, nxt)[1]
    chunk.fill_(7.0)
    assert torch.equal(new_carry, kept)
    assert torch.equal(spec.step(new_carry, nxt)[1], want)


# --- the streaming resampler's kernel (csrc/resample.cu) against its plain version ---

# Both sum in fp32, in other orders: the kernel over a group's span of
# shifted taps (97 to 117 at 44.1 to 16 kHz), cuBLAS over the dense band in
# its own tiles. With unit-normal inputs and taps below 1 each sum's
# rounding is at most about span x 2^-24 x sum|tap x input|, a few 1e-6;
# 2e-5 leaves room and sits far below the 1e-2 that one wrong tap gives.
RESAMPLE_TOL = 2e-5


def _step_inputs(plan, lead, device, seed=0):
    rng = np.random.default_rng(seed)
    carry = torch.from_numpy(rng.standard_normal((*lead, plan.hist)).astype(np.float32)).to(device)
    chunk = torch.from_numpy(rng.standard_normal((*lead, plan.chunk_in)).astype(np.float32)).to(device)
    return carry, chunk


def _bits(t):
    return t.contiguous().view(torch.int32)


# the benchmark's pair, the dictation trunk's decimation, an interpolating
# pair, cubic and linear (no carry), and 96 to 8 kHz, whose 385 taps take
# the generic path
@pytest.mark.parametrize(
    "rates,mode,chunk_in,path",
    [
        ((44100, 16000), "kaiser", 14112, "tile"),
        ((48000, 16000), "kaiser", 1536, "tile"),
        ((16000, 48000), "kaiser", 344, "tile"),
        ((44100, 16000), "cubic", 882, "tile"),
        ((44100, 16000), "linear", 882, "tile"),
        ((96000, 8000), "kaiser", 3072, "generic"),
    ],
)
@pytest.mark.parametrize("lead", [(), (3,), (2, 4)])
def test_resample_kernel_matches_plain(cuda_device, rates, mode, chunk_in, path, lead):
    plan = make_stream_plan(*rates, mode, chunk_in=chunk_in)
    assert resample_kernel.kernel_path(plan) == path
    carry, chunk = _step_inputs(plan, lead, cuda_device)
    before = resample_kernel.COUNT.launches
    c_k, y_k = resample_kernel.resample_stream_step(plan, carry, chunk)
    torch.cuda.synchronize()
    assert resample_kernel.COUNT.launches == before + 1
    c_p, y_p = resample_stream_step_reference(plan, carry, chunk)
    assert y_k.shape == y_p.shape == (*lead, plan.n_out_chunk) and c_k.shape == c_p.shape
    assert (y_k - y_p).abs().max().item() <= RESAMPLE_TOL
    assert torch.equal(_bits(c_k), _bits(chunk[..., chunk_in - plan.hist :]))


def test_resample_kernel_at_the_cells_step_shape(cuda_device):
    """256 rows of the benchmark's 14,112-sample chunk at 44.1 to 16 kHz,
    after a carry of real samples."""
    plan = make_stream_plan(44100, 16000, chunk_in=14112)
    carry, chunk = _step_inputs(plan, (256,), cuda_device, seed=5)
    c_k, y_k = resample_kernel.resample_stream_step(plan, carry, chunk)
    c_p, y_p = resample_stream_step_reference(plan, carry, chunk)
    assert y_k.shape == (256, 5120)
    assert (y_k - y_p).abs().max().item() <= RESAMPLE_TOL
    assert torch.equal(_bits(c_k), _bits(chunk[:, -plan.hist :]))
    c_2, y_2 = resample_kernel.resample_stream_step(plan, c_k, chunk)
    assert (y_2 - resample_stream_step_reference(plan, c_k, chunk)[1]).abs().max().item() <= RESAMPLE_TOL


def test_resample_kernel_reads_strided_rows_bit_for_bit(cuda_device):
    """A column slice of a wider tensor (rows 16-byte aligned, and not)
    gives the bits of its contiguous copy, and two launches the same bits."""
    plan = make_stream_plan(44100, 16000, chunk_in=14112)
    rng = np.random.default_rng(2)
    carry = torch.from_numpy(rng.standard_normal((64, plan.hist)).astype(np.float32)).to(cuda_device)
    for extra, offset in ((0, plan.chunk_in), (5, 1)):
        wide = torch.from_numpy(rng.standard_normal((64, 3 * plan.chunk_in + extra)).astype(np.float32))
        chunk = wide.to(cuda_device)[:, offset : offset + plan.chunk_in]
        assert not chunk.is_contiguous()
        runs = [resample_kernel.resample_stream_step(plan, carry, c) for c in (chunk, chunk.contiguous(), chunk)]
        for c_k, y_k in runs[1:]:
            assert torch.equal(_bits(c_k), _bits(runs[0][0])) and torch.equal(_bits(y_k), _bits(runs[0][1]))


def test_resample_kernel_launches_once_a_chunk(cuda_device):
    graph = log_mel_frontend(44100, 16000, 1024, 256, 128, center=False)
    chunk = graph.chunk_granularity() * max(1, 14112 // graph.chunk_granularity())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 5 * chunk)).astype(np.float32))
    before = resample_kernel.COUNT.launches
    graph.scan_stream(x.to(cuda_device), chunk)
    torch.cuda.synchronize()
    assert resample_kernel.COUNT.launches - before == 5


def test_resample_kernel_rejects_what_it_does_not_take(cuda_device):
    plan = make_stream_plan(44100, 16000, chunk_in=882)
    carry, chunk = _step_inputs(plan, (2,), cuda_device)
    with pytest.raises(ValueError, match="float32"):
        resample_kernel.resample_stream_step(plan, carry.double(), chunk.double())
    with pytest.raises(ValueError, match="float32"):
        resample_kernel.resample_stream_step(plan, carry.to(torch.int32), chunk.to(torch.int32))
    with pytest.raises(ValueError, match="chunk_in"):
        resample_kernel.resample_stream_step(plan, carry, chunk[:, :-1])
    with pytest.raises(ValueError, match="carry"):
        resample_kernel.resample_stream_step(plan, carry[:, 1:], chunk)


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


# both paths: the FFT path at three power-of-two transforms, the dense path
# at an n_fft that is not one; the pvoc rate and two slow-downs
@pytest.mark.parametrize("rate", [1.25, 0.5, 2.0 / 3.0])
@pytest.mark.parametrize("n_fft,hop,path", [(1024, 256, "fft"), (512, 128, "fft"), (2048, 512, "fft"),
                                            (960, 240, "dense")])
def test_timestretch_paths_match_plain(cuda_device, n_fft, hop, path, rate):
    assert timestretch.kernel_path(n_fft, hop) == path
    x = torch.from_numpy(_tones((3, 16000))).to(cuda_device)
    got = timestretch.time_stretch_fused(x, rate, n_fft, hop)
    want = timestretch.time_stretch_reference(x, rate, n_fft, hop)
    assert got.shape == want.shape == (3, round(16000 / rate))
    # fp32 sums in another order, carried through the phase product
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (960, 240)])
def test_timestretch_is_deterministic(cuda_device, n_fft, hop):
    """Two launches on the same signal are bitwise equal: the overlap-add is
    summed in one fixed order, without atomics, on both paths."""
    x = torch.from_numpy(_tones((4, 24000))).to(cuda_device)
    a = timestretch.time_stretch_fused(x, 0.8, n_fft, hop)
    assert torch.equal(a, timestretch.time_stretch_fused(x, 0.8, n_fft, hop))


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


def test_stft_fft_on_card_matches_cpu(cuda_device):
    """impl="fft" is cuFFT on the card and torch's FFT on the CPU: the same
    transform, rounded in another order."""
    x = torch.from_numpy(_tones((3, 16000)))
    got, want = stft(x.to(cuda_device), 1024, 256), stft(x, 1024, 256)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert ((got.cpu() - want).abs().max() / want.abs().max()).item() <= 1e-5
    y, y_cpu = istft(got, 1024, 256, length=16000), istft(want, 1024, 256, length=16000)
    assert y.device.type == "cuda" and ((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item() <= 1e-5


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


# cluster sizes 1 (140 rows), 2 (64 rows, an odd bin count) and 8 (one row,
# the pYIN band; a band whose margins span more than one neighbour: 5 bins
# a block under 14 taps a side; 255 taps, 88 bins a block under 127)
@pytest.mark.parametrize(
    "shape,taps,cluster",
    [((12, 140, 41), 11, 1), ((20, 64, 301), 139, 2), ((20, 1, 602), 139, 8), ((30, 2, 40), 29, 8),
     ((25, 1, 700), 255, 8)],
)
def test_viterbi_clusters_match_plain_exactly(cuda_device, shape, taps, cluster):
    assert viterbi.kernel_path(shape[1], shape[2], taps) == cluster
    ov, ou, lk, *consts = _tie_heavy(shape, taps, seed=2, rising=True)
    ov, ou = ov.to(cuda_device), ou.to(cuda_device)
    want = viterbi.pyin_viterbi_forward_reference(ov, ou, lk, *consts)
    before = viterbi.COUNT.launches
    got = viterbi.pyin_viterbi_forward(ov, ou, lk, *consts)
    assert viterbi.COUNT.launches == before + 1
    for name, g, w in zip(("dv", "du", "off", "pick"), got, want):
        assert torch.equal(g, w), name


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


# --- the biquad engine and the dynamics: plain torch on the card -----------

@pytest.mark.parametrize("t_len,lead,with_zi", [(160000, (4,), False), (5120, (3, 2), True), (129, (2,), True),
                                                (37, (), False), (0, (2,), True)])
def test_iir_apply_on_card_matches_cpu(cuda_device, t_len, lead, with_zi):
    """The doubling scan on the card against the same code on the CPU (both
    fp32, TF32 off; cuBLAS sums in another order)."""
    from audioflow_torch.models import eq_bands_default
    from audioflow_torch.ops import biquad

    plan = biquad.make_iir_plan(eq_bands_default(16000.0))
    rng = np.random.default_rng(t_len)
    x = torch.from_numpy((0.3 * rng.standard_normal((*lead, t_len))).astype(np.float32))
    zi = biquad.iir_apply(torch.from_numpy((0.3 * rng.standard_normal((*lead, 300))).astype(np.float32)),
                          plan)[1] if with_zi else None
    y, s = biquad.iir_apply(x.to(cuda_device), plan, None if zi is None else zi.to(cuda_device))
    y_cpu, s_cpu = biquad.iir_apply(x, plan, zi)
    assert y.device.type == s.device.type == "cuda" and y.shape == y_cpu.shape and s.shape == s_cpu.shape
    assert (y.cpu() - y_cpu).abs().max().item() <= 1e-5 if t_len else y.numel() == 0
    assert (s.cpu() - s_cpu).abs().max().item() <= 1e-5


def test_dynamics_on_card_match_cpu(cuda_device):
    from audioflow_torch import ops

    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((2, 3, 16000))).astype(np.float32)
    x[..., 4000:9000] *= 1e-3
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).to(cuda_device)
    for name, fn in {
        "limiter": lambda z: ops.limiter(z, -6.0), "compressor": lambda z: ops.compressor(z, knee_db=6.0),
        "noise_gate": lambda z: ops.noise_gate(z, -30.0), "agc": lambda z: ops.agc(z, block=512, gain0=3.0)[0],
        "preemphasis": ops.preemphasis, "deemphasis": ops.deemphasis, "to_mono": lambda z: ops.to_mono(z, 2),
        "gain_db": lambda z: ops.gain_db(z, -4.0), "rms_normalize": ops.rms_normalize,
        "peak_normalize": ops.peak_normalize, "cmvn": lambda z: ops.cmvn(z.reshape(2, 3, 500, 32), True),
    }.items():
        got, want = fn(xg), fn(xc)
        assert got.device.type == "cuda" and got.shape == want.shape, name
        assert (got.cpu() - want).abs().max().item() <= 1e-5, name
    assert ops.split_silence(xg[0, 0]) == ops.split_silence(xc[0, 0])
    assert ops.trim_silence(xg[0, 0])[1] == ops.trim_silence(xc[0, 0])[1]


def test_configs_3_and_5_on_card_match_cpu(cuda_device):
    """Config 3 through Graph.compile() on numpy input, and config 5
    streamed with one melspec launch per chunk, against the CPU."""
    from audioflow_torch.models import eq_bands_default, master_chain_graph

    x = _tones((3, 70000))
    master = master_chain_graph(16000).compile()
    got, want = master(x), master(x, device="cpu")
    assert got.device.type == "cuda" and (got.cpu() - want).abs().max().item() <= 1e-5
    chunk = 14112
    x = np.random.default_rng(1).standard_normal((4, 3 * chunk)).astype(np.float32)
    g = log_mel_frontend(44100, 16000, 1024, 256, 128, eq=eq_bands_default(16000.0))
    before = melspec.COUNT.launches
    got = g.scan_stream(x, chunk).cpu()
    assert melspec.COUNT.launches == before + 3
    want = g.scan_stream(x, chunk, device="cpu")
    assert got.shape == want.shape == (4, 60, 128)
    assert (got - want).abs().max().item() <= 1e-3


def _wav_files(tmp_path, n, rate=44100, seconds=0.5):
    from audioflow_torch.io import write_wav

    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        p = tmp_path / f"f{i:02d}.wav"
        write_wav(p, (0.4 * rng.standard_normal(int(rate * seconds) + 97 * i)).astype(np.float32), rate)
        paths.append(str(p))
    return paths


def test_run_batches_pinned_ring_recycles_without_races(cuda_device, tmp_path):
    """More batches than the pinned staging ring holds (11 batches, 5 slots):
    each lane equals one offline call on its own decoded samples, so no copy
    to the card read a slot the decoder had already refilled."""
    from audioflow_torch.io import BatchLoader, decode_batch, native
    from audioflow_torch.runner import run_batches
    from audioflow_torch.sinks import ArraySink

    files = _wav_files(tmp_path, 21)
    stride = 1024 * -(-(22050 + 97 * 20) // 1024)
    g = log_mel_frontend(44100)
    loader = BatchLoader(files, 2, stride=stride)
    sink = ArraySink()
    calls = native.STATS.calls
    m = run_batches(g, loader, sinks=[sink])
    assert native.STATS.calls - calls == m.batches == 11 and m.files == 21 and m.failed_files == 0
    got = sink.result()
    ref = decode_batch(files, stride=stride)
    want = torch.cat([g.chain(torch.from_numpy(ref.samples[i : i + 1]).to(cuda_device)) for i in range(21)])
    assert got.shape == tuple(want.shape)
    # the log-mel port tolerance; a race would show as O(1) garbage
    np.testing.assert_allclose(got, want.cpu().numpy(), atol=5e-4, rtol=0)


def test_cli_run_defaults_to_the_card(cuda_device, tmp_path, capsys):
    import json

    from audioflow_torch.cli import main

    files = _wav_files(tmp_path, 3)
    before = melspec.COUNT.launches
    out = tmp_path / "o.npy"
    assert main(["run", "-i", *files, "-g", "logmel", "-o", str(out), "--stats", str(tmp_path / "s.json")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["files"] == 3 and line["failed_files"] == 0
    # the melspec kernel launches only on tensors on the card
    assert melspec.COUNT.launches > before
    assert np.isfinite(np.load(out)).all()


# ------------------------------------------------------------ the dictation path

def test_quantize_and_vad_scan_on_the_card_equal_the_cpu(cuda_device):
    """quantize_i16 maps NaN to 0 and +-inf to +-32767 on the card as on the
    CPU; vad_scan's states on the card equal the CPU's on frames whose levels
    stay clear of the threshold."""
    from audioflow_torch.ops import quantize_i16, vad_scan

    x = torch.tensor([np.nan, np.inf, -np.inf, 0.99999, -0.99999, 1.5, -1.5, 0.25, 0.0])
    q = quantize_i16(x.to(cuda_device)).cpu()
    assert torch.equal(q, quantize_i16(x)) and q[:4].tolist() == [0, 32767, -32767, 32766]
    rng = np.random.default_rng(0)
    frames = torch.from_numpy((rng.standard_normal((8, 200, 320)) * rng.choice([1e-5, 0.1], (8, 200, 1)))
                              .astype(np.float32))
    c_cpu, s_cpu = vad_scan(frames)
    c_gpu, s_gpu = vad_scan(frames.to(cuda_device))
    assert torch.equal(s_gpu.cpu(), s_cpu) and torch.equal(c_gpu.state.cpu(), c_cpu.state)


def test_session_on_the_card_equals_scan_stream(cuda_device, tmp_path):
    """Ragged pushes through the dictation fork on the card: results equal
    Fork.scan_stream exactly, the melspec kernel launches once a chunk and
    once for the warm-up, and a snapshot restores on the CPU."""
    from audioflow_torch.graph import LogMelSpec, QuantizeI16, Resample, Vad, VadGate, chain, fork
    from audioflow_torch.session import StreamSession

    f = fork(chain(Resample(48000, 16000), input_rate=48000),
             wire=chain(VadGate(320), QuantizeI16(), input_rate=16000), vad=chain(Vad(320), input_rate=16000),
             features=chain(LogMelSpec(1024, 256, 128, center=False), input_rate=16000))
    rng = np.random.default_rng(1)
    x = (0.2 * rng.standard_normal((4, 48000))).astype(np.float32)
    before = melspec.COUNT.launches
    s = StreamSession(f, lead_shape=(4,)).open()
    for i in range(0, 24000, 1000):
        s.push(x[:, i : i + 1000])
    s.snapshot(tmp_path / "snap")
    for i in range(24000, 48000, 1000):
        s.push(x[:, i : i + 1000])
    res = s.poll_all()
    assert melspec.COUNT.launches - before == len(res) + 1 == 12 + 1
    scan = f.scan_stream(torch.from_numpy(x[:, : 12 * s.chunk_in]).to(cuda_device), s.chunk_in)
    for k in ("wire", "vad", "features"):
        got = np.concatenate([r.data[k] for r in res], axis=1)
        np.testing.assert_array_equal(got, scan[k].cpu().numpy())
    cpu = StreamSession(f, lead_shape=(4,), device="cpu").restore(tmp_path / "snap")
    assert cpu._chunk_index == 6 and cpu._pending == 24000 - 6 * s.chunk_in


# --- the mastering, effects and feature families: plain torch on the card ---

def _voice(seconds=1.0, lead=(2,), seed=2, rate=16000):
    """Tone bursts over a -45 dBFS noise floor."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 10 ** (-45 / 20) * rng.standard_normal((*lead, n))
    for a, b, f in ((0.1, 0.4, 220.0), (0.55, 0.85, 330.0)):
        sl = slice(int(a * n), int(b * n))
        x[..., sl] += 0.3 * np.sin(2 * np.pi * f * t[sl]) * np.hanning(sl.stop - sl.start)
    return x.astype(np.float32)


@pytest.mark.parametrize("impl,taps", [("direct", 101), ("fft", 101), ("auto", 1025)])
def test_fir_on_card_matches_cpu(cuda_device, impl, taps):
    """``conv1d`` (cuDNN, fp32 with TF32 off) and cuFFT against the CPU,
    within 1e-6 of the peak; the carried state exactly."""
    from audioflow_torch.ops import fir_apply, fir_design

    assert torch.backends.cudnn.allow_tf32 is False
    h = fir_design(taps, 2000.0, 16000.0)
    rng = np.random.default_rng(taps)
    x = torch.from_numpy((0.3 * rng.standard_normal((4, 20000))).astype(np.float32))
    zi = torch.from_numpy((0.3 * rng.standard_normal((4, taps - 1))).astype(np.float32))
    y, zf = fir_apply(x.to(cuda_device), h, zi.to(cuda_device), impl=impl)
    y_cpu, zf_cpu = fir_apply(x, h, zi, impl=impl)
    assert y.device.type == "cuda"
    assert (y.cpu() - y_cpu).abs().max().item() <= 1e-6 * y_cpu.abs().max().item()
    assert torch.equal(zf.cpu(), zf_cpu)


def test_spectral_gate_on_card_matches_cpu(cuda_device):
    """Within 1e-5 of the peak, after checking that no bin's gate decision
    sits closer to its threshold than the card and the CPU differ."""
    from audioflow_torch.ops import noise_profile, spectral_gate, stft

    x = torch.from_numpy(_voice())

    def parts(dev):
        mag = stft(x.to(dev), 1024, 256, impl="matmul").abs()
        mean, std = noise_profile(mag)
        return torch.log10(torch.clamp_min(mag, 1e-10)).cpu(), (mean + 1.5 * std).cpu()

    (lg, tg), (lc, tc) = parts(cuda_device), parts("cpu")
    slack = (lc - tc[..., None, :]).abs() - (lg - lc).abs() - (tg - tc).abs()[..., None, :]
    assert slack.min().item() > 0
    got = spectral_gate(x.to(cuda_device), prop_decrease=0.9).cpu()
    want = spectral_gate(x, prop_decrease=0.9)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_pcen_on_card_matches_cpu(cuda_device):
    """The doubling-scan smoother with a carry and the reseed, and PCEN,
    within 2e-6 of the peak."""
    from audioflow_torch.ops import pcen, pcen_smoother

    rng = np.random.default_rng(5)
    e = torch.from_numpy(np.abs(rng.standard_normal((8, 300, 40))).astype(np.float32))
    m0 = torch.from_numpy(rng.random((8, 40)).astype(np.float32))
    for fi in (None, 0, 17):
        got = pcen_smoother(e.to(cuda_device), 0.05, m0.to(cuda_device), fi)
        want = pcen_smoother(e, 0.05, m0, fi)
        for a, b in zip(got, want):
            assert (a.cpu() - b).abs().max().item() <= 2e-6 * b.abs().max().item()
    got, want = pcen(e.to(cuda_device)).cpu(), pcen(e)
    assert (got - want).abs().max().item() <= 2e-6 * want.abs().max().item()


def test_feedback_delay_and_chorus_on_card(cuda_device):
    """The delay within 1e-6 of the CPU and streamed exactly equal to
    offline on the card; the chorus within one fp32 spacing of its read
    position at the signal's end (2^-8 at 48,000 samples), times its wet
    weight and the signal's largest step between samples: the card's and
    the CPU's ``sin`` differ by an ulp, which can move a read position by
    one spacing."""
    from audioflow_torch.ops import chorus, feedback_delay

    x = torch.from_numpy((0.3 * np.random.default_rng(6).standard_normal((4, 48000))).astype(np.float32))
    xg = x.to(cuda_device)
    off, _ = feedback_delay(xg, 2880, 0.35, 0.3)
    want, _ = feedback_delay(x, 2880, 0.35, 0.3)
    assert (off.cpu() - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    carry, outs = None, []
    for i in range(0, 48000, 16384):
        y, carry = feedback_delay(xg[:, i : i + 16384], 2880, 0.35, 0.3, carry)
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=-1), off)
    got = chorus(xg, 16000, 0.9, 0.0025, 0.018, 3, 0.4).cpu()
    spacing = 2.0 ** (np.floor(np.log2(48000 + 330)) - 23)
    bound = 0.4 * spacing * x.diff(dim=-1).abs().max().item()
    assert (got - chorus(x, 16000, 0.9, 0.0025, 0.018, 3, 0.4)).abs().max().item() <= bound


def test_integrated_loudness_on_card_matches_cpu(cuda_device):
    """Within 1e-4 LU of the CPU; the 997 Hz anchor reads -3.0103 LKFS
    within the JAX package's 1e-2 budget."""
    from audioflow_torch.ops import integrated_loudness

    x = torch.from_numpy(_voice(seconds=4.0))
    got = integrated_loudness(x.to(cuda_device), 16000).cpu()
    assert (got - integrated_loudness(x, 16000)).abs().max().item() <= 1e-4
    tone = torch.sin(2 * np.pi * 997.0 * torch.arange(5 * 48000, dtype=torch.float64) / 48000).float()
    assert abs(integrated_loudness(tone.to(cuda_device), 48000).item() + 3.0103) < 1e-2


@pytest.mark.parametrize("impl", ["onedot", "split", "direct"])
def test_cqt_on_card_matches_cpu(cuda_device, impl):
    """The CQT's hop-block correlation (cuDNN, TF32 off) at the framework
    default, 8 x 2 s at 16 kHz, within 1e-5 of the CPU's peak; the product
    on the framed view beside it."""
    from audioflow_torch.ops import cqt
    from audioflow_torch.ops import cqt_mod

    rng = np.random.default_rng(7)
    x = torch.from_numpy((0.3 * rng.standard_normal((8, 32000))).astype(np.float32))
    got = cqt(x.to(cuda_device), 16000, output="complex", impl=impl).cpu()
    want = cqt(x, 16000, output="complex", impl=impl)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    f0, _, bank = cqt_mod._design(16000, 256, 84, cqt_mod.FMIN_C1, 12, "hann", 1.0)
    xp = torch.nn.functional.pad(x.to(cuda_device), (f0 // 2, f0 - f0 // 2))
    n = (xp.shape[-1] - f0) // 256 + 1
    conv = cqt_mod._framed_dot(xp, bank, 256, n, "conv")
    unfold = cqt_mod._framed_dot(xp, bank, 256, n, "unfold")
    assert (conv - unfold).abs().max().item() <= 1e-5 * unfold.abs().max().item()


def test_icqt_on_card_matches_cpu(cuda_device):
    """The hybrid inverse (the dual branch a cuDNN conv, the sinusoid
    branch elementwise) on the CPU's coefficients, after the decision
    margins of ``decision_margins.py``, and the multirate inverse; within
    2e-5 of the CPU's peak (the conv's 12,144-term sums in another order)."""
    from audioflow_torch.ops import cqt, cqt_frequencies, icqt
    from decision_margins import hybrid_decisions_clear

    f = cqt_frequencies(84)
    n = np.arange(48000)
    x = np.stack([np.sin(2 * np.pi * f[k] * n / 16000) for k in (1, 42, 63)]
                 + [sum((0.5 / (i + 1)) * np.sin(2 * np.pi * 150.0 * (i + 1) * n / 16000) for i in range(12))])
    x = torch.from_numpy(x.astype(np.float32))
    c = cqt(x, 16000, output="complex")
    hybrid_decisions_clear(c)
    hybrid_decisions_clear(c.to(cuda_device))
    got = icqt(c.to(cuda_device), 16000, length=48000).cpu()
    want = icqt(c, 16000, length=48000)
    assert (got - want).abs().max().item() <= 2e-5 * want.abs().max().item()
    mr = cqt(x, 16000, multirate=True, output="complex")
    mr_card = type(mr)([o.to(cuda_device) for o in mr.octaves], mr.meta)
    got, want = icqt(mr_card).cpu(), icqt(mr)
    assert (got - want).abs().max().item() <= 2e-5 * want.abs().max().item()


def test_beat_track_on_card_matches_cpu(cuda_device):
    """The DP's forward loop and backtrace on the card: the CPU's beat mask
    and tempo on click envelopes whose decisions clear the margins of
    ``decision_margins.py``."""
    from audioflow_torch.ops import beat_track
    from decision_margins import dp_margins_clear

    rng = np.random.default_rng(8)
    env = 0.05 * rng.random((3, 500))
    for row, bpm in zip(env, (90.0, 120.0, 150.0)):
        for k in np.arange(0.0, 500, 60.0 * 16000 / (256 * bpm)):
            row[int(round(k))] += 1.0
    env = torch.from_numpy(env.astype(np.float32))
    dp_margins_clear(env)
    dp_margins_clear(env.to(cuda_device))
    mask, bpm = beat_track(env.to(cuda_device), 16000, 256)
    want_mask, want_bpm = beat_track(env, 16000, 256)
    assert mask.device.type == "cuda" and torch.equal(mask.cpu(), want_mask) and torch.equal(bpm.cpu(), want_bpm)


def test_dense_viterbi_and_lpc_on_card_match_cpu(cuda_device):
    """The dense Viterbi's max-plus is elementwise fp32 adds and maxima, so
    the card's decode is the CPU's exactly; LPC within the CPU test's 1e-4
    of the peak (the autocorrelation's sums in another order)."""
    from audioflow_torch.ops import lpc, viterbi as dense_viterbi

    rng = np.random.default_rng(3)
    lo = rng.standard_normal((2, 3, 40, 6)).astype(np.float32)
    a = rng.random((6, 6))
    la = np.log(a / a.sum(1, keepdims=True)).astype(np.float32)
    got, glp = dense_viterbi(lo, la)
    want, wlp = dense_viterbi(lo, la, device="cpu")
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want) and torch.equal(glp.cpu(), wlp)
    x = rng.standard_normal((3, 5, 1024)).astype(np.float32)
    for order in (4, 12):
        g, w = lpc(x, order).cpu(), lpc(x, order, device="cpu")
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_dtw_on_card_matches_cpu(cuda_device):
    """From a given cost the wavefront's sums are the CPU's, in order: the
    accumulated costs and the path exactly. From features the cost's
    products round differently: the path where its steps clear the margin."""
    from audioflow_torch.ops import dtw
    from decision_margins import dtw_path_margin

    rng = np.random.default_rng(4)
    c = rng.random((57, 43)).astype(np.float32)
    acc, path = dtw(cost=c)
    wacc, wpath = dtw(cost=c, device="cpu")
    assert acc.device.type == "cuda" and torch.equal(acc.cpu(), wacc) and np.array_equal(path, wpath)
    x = rng.standard_normal((60, 13)).astype(np.float32)
    y = np.concatenate([x[::2], x[30:]]) + 0.1 * rng.standard_normal((60, 13)).astype(np.float32)
    acc, path = dtw(x, y, metric="cosine")
    wacc, wpath = dtw(x, y, metric="cosine", device="cpu")
    diff = (acc.cpu() - wacc).abs().max().item()
    assert diff <= 1e-5 * wacc[-1, -1].item() and dtw_path_margin(wacc, wpath) > 2 * diff
    assert np.array_equal(path, wpath)


def test_segment_ops_on_card_match_cpu(cuda_device):
    """Similarities within 1e-5; the novelty within the summed-area table's
    fp32 bound (the card's cumsum sums in another order); the recurrence
    matrix and the boundaries where their decisions clear the margins."""
    from audioflow_torch.ops import novelty_curve, recurrence_matrix, segment_boundaries, self_similarity
    from decision_margins import knn_margin, peak_pick_margins, sat_bound

    rng = np.random.default_rng(5)
    c = np.eye(3, 13, dtype=np.float32) * 4
    feats = np.concatenate([np.tile(c[i], (80, 1)) for i in range(3)]) + 0.3 * rng.standard_normal((240, 13)).astype(
        np.float32)
    s, ws = self_similarity(feats), self_similarity(feats, device="cpu")
    sim_diff = (s.cpu() - ws).abs().max().item()
    assert sim_diff <= 1e-5
    nov, wnov = novelty_curve(s, 32).cpu(), novelty_curve(ws, 32)
    assert ((nov - wnov).abs().numpy() <= 2 * sat_bound(ws, 16) + 1e-5).all()
    assert knn_margin(ws, 16, 1) > 2 * sim_diff
    assert torch.equal(recurrence_matrix(feats).cpu(), recurrence_matrix(feats, device="cpu"))
    mask, nov = segment_boundaries(feats)
    wmask, wnov = segment_boundaries(feats, device="cpu")
    diff = (nov.cpu() - wnov).abs().max().item()
    m = peak_pick_margins(wnov, 16, 16, 16, 16, 0.05, slack=2 * diff)
    assert min(m.values()) > 2 * diff and torch.equal(mask.cpu(), wmask) and int(wmask.sum()) >= 2


def test_piptrack_on_card_matches_cpu(cuda_device):
    from audioflow_torch.ops import piptrack

    rng = np.random.default_rng(6)
    s = np.abs(rng.standard_normal((2, 30, 1025))).astype(np.float32) + 5.0 * np.eye(30, 1025, 40, np.float32)
    p, m = piptrack(s, 22050, 2048)
    wp, wm = piptrack(s, 22050, 2048, device="cpu")
    assert p.device.type == "cuda" and torch.equal(p.cpu() > 0, wp > 0)
    assert (p.cpu() - wp).abs().max() <= 1e-5 * wp.max() and (m.cpu() - wm).abs().max() <= 1e-5 * wm.max()


def test_pyin_online_on_card_matches_cpu_and_streams(cuda_device):
    """The fixed-lag tracker on the card against the CPU: equal where the
    decisions reaching an emission are the same on both (each place where
    they part a near tie of the messages, ``online_pyin_flips_explained``);
    the OnlinePyin node streamed on the card equal to its offline form at
    the declared latency, for two chunk sizes."""
    from audioflow_torch.graph import OnlinePyin
    from audioflow_torch.ops import frame, make_online_pyin_plan, pyin_online
    from decision_margins import online_pyin_flips_explained, online_pyin_trace

    rng = np.random.default_rng(7)
    t = np.arange(20000) / 8000
    x = (0.4 * np.sin(2 * np.pi * np.cumsum(180 + 40 * np.sin(2 * np.pi * 0.7 * t)) / 8000)).astype(np.float32)
    x = np.stack([x, np.roll(x, 3000)]) + 0.01 * rng.standard_normal((2, 20000)).astype(np.float32)
    kw = dict(n_thresholds=16, resolution=0.5)
    plan = make_online_pyin_plan(8000, 100.0, 400.0, 512, 128, 10, **kw)
    got = pyin_online(x, 8000, 100.0, 400.0, 512, 128, 10, **kw)
    want = pyin_online(x, 8000, 100.0, 400.0, 512, 128, 10, device="cpu", **kw)
    fr = frame(torch.from_numpy(x), 512, 128)
    card, cpu = online_pyin_trace(plan, fr.to(cuda_device)), online_pyin_trace(plan, fr)
    score_diff = float(np.abs(card["score"] - cpu["score"]).max())
    equal = online_pyin_flips_explained(plan, cpu, card, score_diff)["equal"]
    assert equal.mean() > 0.9
    assert torch.equal(got[1].cpu()[equal], want[1][equal])
    assert ((got[0].cpu() / want[0] - 1.0).abs()[equal] <= 1e-5).all()
    assert (got[2].cpu() - want[2]).abs().max() <= 1e-5
    g = chain(OnlinePyin(100.0, 400.0, 512, 128, 10, **kw), input_rate=8000)
    xd = torch.from_numpy(x).to(cuda_device)
    offline = g.chain(xd)
    for chunk in (512, 2048):
        n_use = x.shape[-1] // chunk * chunk
        streamed = g.scan_stream(xd[:, :n_use], chunk)
        lat = g.stream_latency(chunk)
        n = streamed.shape[-2] - lat
        assert streamed.device.type == "cuda" and torch.equal(streamed[:, lat : lat + n], offline[:, :n])


def test_first_maximum_rules_on_card(cuda_device):
    """The online tracker's three first-maximum rules on tie-heavy values
    (a coarse grid): the band's offsets (``max`` over the window), the
    best state (``argmax``) and the refinement's best candidate (``max``
    with its index) take the first maximum on the card, as on the CPU."""
    from audioflow_torch.ops import sequence

    rng = np.random.default_rng(9)
    x = torch.from_numpy((np.round(rng.standard_normal((16, 602)) * 2) / 2).astype(np.float32))
    lk = torch.from_numpy((np.round(rng.standard_normal(139) * 2) / 2).astype(np.float32))
    got = sequence.max_plus_band_argmax(x.to(cuda_device), lk.to(cuda_device))
    want = sequence.max_plus_band_argmax(x, lk)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert torch.equal(x.to(cuda_device).argmax(dim=-1).cpu(), x.argmax(dim=-1))
    assert torch.equal(x.to(cuda_device).max(dim=-1)[1].cpu(), x.max(dim=-1)[1])
    assert ((x == x.max(dim=-1, keepdim=True).values).sum(dim=-1) > 1).any()  # the case has ties


def test_train_step_on_card_matches_cpu(cuda_device):
    """One train step of the trainable frontend (MLP head) on the card
    against the CPU: the loss 1e-5 relative, each gradient within 1e-4 of
    its parameter's largest (cuFFT against the CPU's FFT, fp32 sums in
    another order), as tests/test_torch_trainable.py holds the port to the
    JAX package."""
    from audioflow_torch.models import TrainableFrontend, make_train_step

    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((16, 8000))).astype(np.float32)
    y = rng.integers(0, 4, 16)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        m = TrainableFrontend(n_fft=256, hop=128, n_mels=16, n_classes=4, hidden=32, device=dev)
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        m.loss(xd, yd).backward()
        grads = {k: p.grad.cpu().numpy() for k, p in m.named_parameters()}
        step, _ = make_train_step(TrainableFrontend(n_fft=256, hop=128, n_mels=16, n_classes=4, hidden=32,
                                                    device=dev))
        out[dev.type] = (float(step(xd, yd)), grads)
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    for k, g in gp.items():
        assert np.abs(gc[k] - g).max() <= 1e-4 * np.abs(g).max(), k


def test_time_sharded_spectrogram_in_a_gloo_world_on_the_card(cuda_device, tmp_path):
    """Two gloo ranks that share the card: the time-sharded spectrogram,
    its halo staged through page-locked host memory, equals the unsharded
    one on the card within 1e-5 of the peak, with one halo exchange a rank."""
    import torch_parallel_worker as W

    from audioflow_torch.ops import spectrogram
    from audioflow_torch.parallel._worlds import run_world

    x = np.random.default_rng(0).standard_normal((2, 4 * 4096)).astype(np.float32)
    ranks = run_world(W.run_cases, 2, ({"spectrogram": {"x": x}}, "cuda"), timeout=300,
                      workdir=str(tmp_path / "world"))
    for r in ranks:
        assert "error" not in r["spectrogram"], r["spectrogram"].get("error")
        assert r["spectrogram"]["counts"] == {"batch_isend_irecv": 1}
    got = np.concatenate([r["spectrogram"]["out"] for r in ranks], axis=1)
    want = spectrogram(torch.from_numpy(x).to(cuda_device), 512, 256, center=False).cpu().numpy()
    n = want.shape[1]
    assert got.shape == (2, x.shape[1] // 256, 257)
    assert np.abs(got[:, :n] - want).max() / want.max() < 1e-5


def test_bench_pvoc_on_card_runs_the_timestretch_kernel(cuda_device, tmp_path):
    """``run_benchmark("pvoc")`` on the card: a finite row that counts the
    JAX keys' throughput, its calls through the timestretch kernel (2
    warm-up, 10 timed and 1 under the flop counter), whose kernels the trace
    of ``profile_trace`` names."""
    import json

    from audioflow_torch.bench import run_benchmark
    from audioflow_torch.obs import profile_trace

    before = timestretch.COUNT.launches
    with profile_trace(str(tmp_path)):
        row = run_benchmark("pvoc", batch=4, seconds=1.0)
    assert timestretch.COUNT.launches - before == 13
    assert row["benchmark"] == "pvoc" and row["batch"] == 4 and row["audio_seconds"] == 40.0
    assert all(np.isfinite(row[k]) and row[k] > 0 for k in ("wall_seconds", "realtime_factor_per_chip"))
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "kernel"}
    assert any("fft_analysis_kernel" in n for n in names) and any("phase_kernel" in n for n in names), names


def test_the_device_intervals_of_a_pass_tile_it(cuda_device):
    """Three traced ``scan_stream`` passes of the headline graph at the
    benchmark's 2048 rows and 14,112-sample chunks (the later ones on events
    the earlier ones gave back): the output equals the untraced pass's, and
    the CUDA-event intervals of the node spans, of the graph's alignment and
    of the passes' edges (the passes less their steps) tile the passes' own
    intervals within 2%."""
    from audioflow_torch.obs import trace

    g = log_mel_frontend()
    chunk, chunks, passes = 14112, 8, 3
    x = torch.randn(2048, chunk * chunks, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
    want = g.scan_stream(x, chunk)
    with trace.enable():
        got = [g.scan_stream(x, chunk) for _ in range(passes)]
    spans = trace.snapshot()["spans"]
    assert all(torch.equal(y, want) for y in got)
    align = spans.pop("graph.align")
    assert align["count"] == align["device_count"] >= passes * chunks
    assert {k: (v["count"], v["device_count"]) for k, v in spans.items()} == {
        k: (passes * n, passes * n) for k, n in (
            ("graph.scan_stream", 1), ("graph.init_state", 1), ("graph.concat", 1),
            ("graph.stream_step", chunks), ("node.Resample", chunks), ("node.LogMelSpec", chunks))}
    dev = {k: v["device_s"] for k, v in spans.items()}
    edges = dev["graph.scan_stream"] - dev["graph.stream_step"]
    nodes = dev["node.Resample"] + dev["node.LogMelSpec"]
    assert edges >= dev["graph.concat"] > 0 and nodes > 0 and align["device_s"] > 0
    total = nodes + align["device_s"] + edges
    assert abs(total - dev["graph.scan_stream"]) <= 0.02 * dev["graph.scan_stream"], dev
