"""Host designs of the shared-memory real FFT (``csrc/fft.cuh``), and a
plain-torch model of it.

The kernels' twiddles are designed here in float64 and rounded to float32
once: ``e^{-2πi t/n}`` for ``t < n/2`` (:func:`twiddles`). The model runs the
kernel's algorithm step for step: the length-``n/2`` complex Stockham FFT of
``x[2j] + i·x[2j+1]`` (radix 16 while 4 or more bits are left, then one
pass of radix 2, 4 or 8), then the real-split post-twiddle; the inverse runs
the pre-twiddle first and ignores the imaginary parts of bin 0 and bin
``n/2``, as the bank form of ``ops/stft.py`` does. The CPU tests hold it against ``torch.fft``,
so the kernel's index arithmetic is checked where there is no card.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.cache import BoundedCache

# the transforms the kernels take the FFT path for: m = 8 (one radix-8
# pass) to m = 1024, the largest whose passes the registers hold
MIN_FFT = 16
MAX_FFT = 2048

_TWIDDLES = BoundedCache(maxsize=16)


def is_fft_size(n_fft: int) -> bool:
    """True for the transform lengths the FFT paths take: a power of two
    from :data:`MIN_FFT` to :data:`MAX_FFT`."""
    return MIN_FFT <= n_fft <= MAX_FFT and n_fft & (n_fft - 1) == 0


def twiddles(n_fft: int, dtype=np.float32) -> np.ndarray:
    """``e^{-2πi t/n_fft}`` for ``t < n_fft // 2`` as ``[n_fft // 2, 2]``
    (cos, -sin), designed in float64 and rounded to ``dtype`` (float32, or
    float64 for the fp64 transform). Cached: callers must not write to it."""
    key = (n_fft, np.dtype(dtype).name)
    if key not in _TWIDDLES:
        ang = 2.0 * np.pi * np.arange(n_fft // 2, dtype=np.float64) / n_fft
        _TWIDDLES[key] = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(dtype)
    return _TWIDDLES[key]


def _table(tw: torch.Tensor) -> torch.Tensor:
    """The complex twiddles over the whole circle, ``[2m]``, from the
    half-circle table as the kernel extends it (``-w`` past ``m``)."""
    w = torch.complex(tw[:, 0], tw[:, 1])
    return torch.cat([w, -w])


def _stockham(z: torch.Tensor, w: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The kernel's Stockham passes over the last axis of complex ``z [..., m]``."""
    m = z.shape[-1]
    if inverse:
        w = w.conj()
    ns = 1
    while ns < m:
        r = min(16, m // ns)
        q = m // r
        j = torch.arange(q)
        k = j % ns
        v = torch.stack([z[..., j + i * q] * w[i * k * (2 * m // (ns * r))] for i in range(r)], -1)
        # the butterfly: a DFT of r points, W_r^{i·o} from the same table
        v = v @ w[(torch.arange(r)[:, None] * torch.arange(r) % r) * (2 * m // r)]
        out = torch.empty_like(z)
        dst = (j - k) * r + k
        for i in range(r):
            out[..., dst + i * ns] = v[..., i]
        z, ns = out, ns * r
    return z


def rfft(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The kernel's forward real FFT of ``x [..., n]`` (float32): complex
    ``[..., n/2 + 1]``, as ``torch.fft.rfft``."""
    w = _table(tw)
    m = x.shape[-1] // 2
    z = _stockham(torch.complex(x[..., 0::2], x[..., 1::2]), w, inverse=False)
    k = torch.arange(m + 1)
    a = z[..., k % m]
    b = z[..., (m - k) % m].conj()
    return (a + b) / 2 + w[k] * (-0.5j * (a - b))


def irfft(spec: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The kernel's inverse real FFT of ``spec [..., n/2 + 1]`` (complex64):
    float32 ``[..., n]``, as ``torch.fft.irfft`` with the imaginary parts of
    bin 0 and bin n/2 taken as zero."""
    w = _table(tw)
    m = spec.shape[-1] - 1
    spec = spec.clone()
    spec[..., 0] = spec[..., 0].real
    spec[..., m] = spec[..., m].real
    k = torch.arange(m)
    xk, xc = spec[..., k], spec[..., m - k].conj()
    z = (xk + xc) + 1j * ((xk - xc) * w[k].conj())
    z = _stockham(z, w, inverse=True)
    return torch.stack([z.real, z.imag], dim=-1).reshape(*z.shape[:-1], 2 * m) / (2 * m)
