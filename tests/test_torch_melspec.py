"""The fused mel-spectrogram: the port's plain version against the JAX
package's Pallas kernel (interpret mode), and the wrapper's checks. The
hand-written kernel itself is tested on a card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu.ops.pallas import mel_spectrogram_pallas
from audioflow_torch.ops.kernels import melspec
from audioflow_torch.ops.mel import floor_log, mel_filterbank
from audioflow_torch.ops.stft import dft_banks, padded_window, spectrogram


def _inputs(rng, shape, n_fft, n_mels, device="cpu"):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    cosb, sinb = dft_banks(n_fft, "hann", None, device)
    w = torch.from_numpy(padded_window(n_fft, "hann").astype(np.float32)).to(device)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, 16000)).to(device)
    return x, cosb, sinb, w, fb


# the stream step's shape (768 carried + 5120 new samples -> 20 frames) and
# a non-power-of-two frame count at a smaller transform
@pytest.mark.parametrize("t,n_fft,hop,n_mels", [(5888, 1024, 256, 128), (10000, 512, 128, 64)])
def test_plain_matches_pallas(rng, t, n_fft, hop, n_mels):
    x, cosb, sinb, w, fb = _inputs(rng, (2, t), n_fft, n_mels)
    got = melspec.mel_spectrogram(x, cosb, sinb, w, fb, hop).numpy()
    want = np.asarray(
        mel_spectrogram_pallas(
            jnp.asarray(x.numpy()), n_fft, hop, n_mels, 16000, precision="highest", interpret=True
        )
    )
    assert got.shape == want.shape
    # the tolerance of the JAX package's own Pallas tests (tests/test_pallas.py)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("log", [None, "ln", "log10", "db"])
def test_cpu_wrapper_is_plain_version(rng, log):
    x, cosb, sinb, w, fb = _inputs(rng, (3, 1, 3000), 512, 40)
    before = melspec.COUNT.launches
    got = melspec.mel_spectrogram(x, cosb, sinb, w, fb, 128, log=log, floor=1e-6)
    assert got.shape == (3, 1, 20, 40)
    want = floor_log(torch.matmul(spectrogram(x, 512, 128, center=False), fb), 1e-6, log)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert melspec.COUNT.launches == before  # the CPU path launches nothing


def test_wrapper_rejects_bad_inputs(rng):
    x, cosb, sinb, w, fb = _inputs(rng, (2, 2048), 512, 40)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x, cosb, sinb, w, fb, 128, log="log2")
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x, cosb, sinb[:, :-1], w, fb, 128)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x, cosb, sinb, w, fb[:-1], 128)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x[:, :100], cosb, sinb, w, fb, 128)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x, cosb, sinb, w, fb, 0)
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x, cosb, sinb, w[:-1], fb, 128)  # the window of another n_fft
    with pytest.raises(ValueError):
        melspec.mel_spectrogram(x, cosb, sinb, w, fb.to("meta"), 128)

