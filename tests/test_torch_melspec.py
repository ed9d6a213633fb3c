"""The fused mel-spectrogram: the port's plain version against the JAX
package's Pallas kernel (interpret mode), the wrapper's carry form and
prepared launches, and its checks. The hand-written kernel itself is tested
on a card in test_torch_cuda.py."""

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
    with pytest.raises(ValueError, match="lead axes"):
        melspec.prepare(cosb, sinb, w, fb, 128).step(x[:1, :384], x)



# the stream step's shape at two lead axes; a chunk shorter than the carry
# (the new carry then spans both segments); a narrowed chunk whose rows lie
# an odd stride apart; the dense path's n_fft 400 on a narrowed chunk
@pytest.mark.parametrize(
    "lead,carry_len,n,n_fft,hop,narrow",
    [
        ((2, 2), 768, 5120, 1024, 256, False),
        ((3,), 768, 256, 1024, 256, False),
        ((2,), 768, 5120, 1024, 256, True),
        ((2,), 320, 1600, 400, 160, True),
    ],
)
def test_cpu_carry_form_is_plain_over_the_cat(rng, lead, carry_len, n, n_fft, hop, narrow):
    x, cosb, sinb, w, fb = _inputs(rng, (*lead, carry_len + n + 239), n_fft, 64)
    carry = x[..., :carry_len].contiguous()
    chunk = x[..., carry_len : carry_len + n]
    if not narrow:
        chunk = chunk.contiguous()
    assert chunk.is_contiguous() != narrow
    before = melspec.COUNT.launches, melspec.COUNT.carry_launches
    new_carry, out = melspec.prepare(cosb, sinb, w, fb, hop).step(carry, chunk)
    buf = torch.cat([carry, chunk], dim=-1)
    assert torch.equal(out, melspec.mel_spectrogram_reference(buf, cosb, sinb, fb, hop))
    assert torch.equal(new_carry, buf[..., -carry_len:])
    assert out.shape == (*lead, (carry_len + n - n_fft) // hop + 1, 64)
    assert (melspec.COUNT.launches, melspec.COUNT.carry_launches) == before  # the CPU path launches nothing


def test_prepare_once_per_design_set(rng):
    """One :class:`MelSpec` per set of design tensors and settings; an
    in-place edit of the filterbank prepares anew."""
    _, cosb, sinb, w, fb = _inputs(rng, (1, 8), 512, 40)
    fb = fb.clone()
    spec = melspec.prepare(cosb, sinb, w, fb, 128)
    assert melspec.prepare(cosb, sinb, w, fb, 128) is spec
    assert melspec.prepare(cosb, sinb, w, fb, 64) is not spec
    assert melspec.prepare(cosb, sinb, w, fb, 128, log="db") is not spec
    fb[:, 0] = 0.0
    assert melspec.prepare(cosb, sinb, w, fb, 128) is not spec
