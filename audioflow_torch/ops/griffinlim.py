"""Griffin-Lim phase reconstruction (magnitude spectrogram -> waveform).

Mirrors ``audioflow_tpu/ops/griffinlim.py``: fast Griffin-Lim, the momentum
update of librosa.griffinlim (Perraudin et al., "A fast Griffin-Lim
algorithm", WASPAA 2013). Two paths compute it:

* ``"matmul"`` and ``"fft"``: each iteration is one ``istft`` -> ``stft``
  round trip in plain torch (the transforms as products with the DFT banks,
  or as ``torch.fft``, cuFFT on the card), then the momentum and
  magnitude-replacement step;
* ``"pallas"`` (the JAX package's name for its fused kernel): the
  hand-written CUDA kernel of :mod:`audioflow_torch.ops.kernels.griffinlim`,
  one launch per iteration, with the Pallas kernel's edge-frame convention.

``impl="auto"`` takes the kernel for a CUDA tensor when the configuration
is eligible, the matmul path otherwise (so always on the CPU, as the JAX
package off a TPU).
"""

from __future__ import annotations

import torch

from ..utils import as_tensor
from .kernels.griffinlim import griffin_lim_fused, supported
from .stft import istft, stft

IMPLS = ("auto", "pallas", "matmul", "fft")


def griffin_lim(
    mag,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    n_iter: int = 32,
    momentum: float = 0.99,
    center: bool = True,
    length: int | None = None,
    impl: str = "auto",
    precision: str | None = "default",
    init_phase=None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Reconstruct a waveform whose STFT magnitude approximates ``mag``.

    ``mag [..., F, n_fft//2 + 1]`` is a magnitude (not power) spectrogram, a
    tensor or a numpy array that goes to ``device`` ("cuda" unless given;
    see :func:`audioflow_torch.utils.as_tensor`). ``momentum`` is in [0, 1);
    0 is classic Griffin-Lim. ``length`` is the output sample count (the
    istft's natural length by default). ``impl`` is "auto", "pallas" (force
    the fused kernel; its plain version on the CPU), "matmul" (the round
    trip against the DFT banks) or "fft" (through ``torch.fft``). ``precision`` is accepted for parity: the port
    computes in fp32. ``init_phase`` (the shape of ``mag``) seeds the phase;
    zeros by default. Returns ``[..., T]``.
    """
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    if impl not in IMPLS:
        raise ValueError(f"unknown griffin_lim impl {impl!r}; known: {', '.join(IMPLS)}")
    mag = as_tensor(mag, device)
    if impl in ("auto", "pallas"):
        eligible = (
            center
            and n_iter >= 1
            and mag.ndim >= 2
            and precision in ("default", "highest")
            and supported(n_fft, hop, precision=precision)
        )
        if impl == "pallas" and not eligible:
            raise ValueError(
                "impl='pallas' needs center=True, n_iter >= 1, batched mag, "
                "precision in ('default', 'highest') and a supported "
                f"(n_fft={n_fft}, hop={hop}) config"
            )
        if impl == "pallas" or (eligible and mag.device.type == "cuda"):
            return griffin_lim_fused(
                mag, n_fft, hop, window=window, n_iter=n_iter, momentum=momentum,
                length=length, init_phase=init_phase, precision=precision,
            )
        impl = "matmul"
    mag = mag.to(torch.float32)
    if init_phase is None:
        spec = torch.complex(mag, torch.zeros_like(mag))
    else:
        p = as_tensor(init_phase, mag.device).to(torch.float32)
        spec = torch.complex(mag * torch.cos(p), mag * torch.sin(p))
    n_frames = mag.shape[-2]

    def project(s):
        """istft -> stft round trip (projection onto consistent spectrograms)."""
        x = istft(s, n_fft, hop, window=window, center=center, impl=impl, precision=precision)
        r = stft(x, n_fft, hop, window=window, center=center, impl=impl, precision=precision)
        # stft of the istft can gain or lose a trailing frame when lengths
        # do not divide; clamp to the magnitude's frame count
        if r.shape[-2] < n_frames:
            r = torch.nn.functional.pad(r, (0, 0, 0, n_frames - r.shape[-2]))
        return r[..., :n_frames, :]

    prev = torch.zeros_like(spec)
    for _ in range(n_iter):
        rebuilt = project(spec)
        # momentum extrapolation, then magnitude replacement
        accel = rebuilt + momentum * (rebuilt - prev)
        phase = accel / torch.clamp_min(accel.abs(), 1e-16)
        spec, prev = mag * phase, rebuilt
    return istft(spec, n_fft, hop, window=window, center=center, length=length, impl=impl,
                 precision=precision)
