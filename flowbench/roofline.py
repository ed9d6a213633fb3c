"""The card's published peaks and the work of a kernel's call, counted from
its shapes.

The count does not depend on how the kernel is written: a redesigned kernel
is judged by the same work. Each input byte is read once and each output
byte written once; a DFT counts as a real FFT.
"""

from __future__ import annotations

import math

# dense peaks by device name (the data sheet of the SXM part, at 700 W)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def rfft_flops(n: int) -> float:
    """Operations of one real FFT of ``n`` points: half of a complex FFT's
    ``5 n log2 n``."""
    return 2.5 * n * math.log2(n)


def melspec_work(rows: int, samples: int, n_fft: int, hop: int, n_mels: int, fb_nnz: int) -> tuple[float, float]:
    """Operations and bytes of one fused log-mel call over ``[rows, samples]``
    (center=False frames): per frame the window, the real FFT, the power,
    the product with the filterbank's nonzeros, the floor and the log; the
    signal, the window, the FFT's twiddles, the band table and the weights
    read, the mel frames written."""
    frames = (samples - n_fft) // hop + 1
    n_bins = n_fft // 2 + 1
    flops = rows * frames * (n_fft + rfft_flops(n_fft) + 3 * n_bins + 2 * fb_nnz + 2 * n_mels)
    nbytes = 4 * (rows * samples + 2 * n_fft + 3 * n_mels + fb_nnz + rows * frames * n_mels)
    return flops, nbytes


def least_seconds(device_kind: str, flops: float, nbytes: float) -> float | None:
    """The least time the card could take: the larger of operations over
    the float32 peak and bytes over the memory's; None for a card not in
    :data:`PEAKS`."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    return max(flops / peak["fp32_flops"], nbytes / peak["hbm_bytes_s"])
