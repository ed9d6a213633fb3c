"""The port's CUDA kernels on a card, against their plain torch versions.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so that a machine with only PyTorch runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from audioflow_torch.models import log_mel_frontend
from audioflow_torch.ops.kernels import melspec
from audioflow_torch.ops.mel import mel_filterbank
from audioflow_torch.ops.stft import dft_banks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, n_fft, n_mels, window, device):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    cosb, sinb = dft_banks(n_fft, window, None, device)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, 16000)).to(device)
    return x, cosb, sinb, fb


# the stream step's shape; an n_fft that is not a multiple of 4 with an
# uneven hop; a transform whose bins fill two full passes; one frame
@pytest.mark.parametrize(
    "shape,n_fft,hop,n_mels,window,log",
    [
        ((64, 5888), 1024, 256, 128, "hann", "ln"),
        ((3, 4001), 502, 100, 40, "hamming", None),
        ((2, 9000), 2048, 512, 64, "hann", "log10"),
        ((5, 1024), 1024, 256, 128, "povey", "ln"),
    ],
)
def test_kernel_matches_plain(cuda_device, shape, n_fft, hop, n_mels, window, log):
    x, cosb, sinb, fb = _inputs(shape, n_fft, n_mels, window, cuda_device)
    before = melspec.COUNT.launches
    got = melspec.mel_spectrogram(x, cosb, sinb, fb, hop, log=log)
    torch.cuda.synchronize()
    assert melspec.COUNT.launches == before + 1
    want = melspec.mel_spectrogram_reference(x, cosb, sinb, fb, hop, log=log)
    assert got.shape == want.shape
    if log is None:
        got, want = got.log(), want.log()
    # both fp32 with TF32 off; the sums are taken in another order
    assert (got - want).abs().max().item() <= 1e-4


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x, cosb, sinb, fb = _inputs((4, 5888), 1024, 128, "hann", cuda_device)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x[:, ::2], cosb, sinb, fb, 256)  # not contiguous
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x.double(), cosb.double(), sinb.double(), fb.double(), 256)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x, cosb, sinb, fb.cpu(), 256)


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
