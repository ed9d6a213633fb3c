"""ITU-R BS.1770-4 loudness: K-weighting, gated LUFS, LRA, true peak.

Mirrors ``audioflow_tpu/ops/loudness.py``. K-weighting is two biquads
through the port's biquad engine (``ops/biquad.py``), block energies one
framed mean-square, gating masked means over whole tensors (no host
round trip), and true peak rides the polyphase resampler. Mono lanes
``[..., T]``; multichannel content is downmixed upstream or measured per
lane. The K-weighting design reproduces the spec's 48 kHz coefficient
tables at any sample rate, in float64, bit for bit the JAX package's.
"""

from __future__ import annotations

import math

import torch

from .biquad import Biquad, biquad_chain
from .framing import frame, num_frames
from .resample import resample

#: absolute gating threshold (LKFS), BS.1770-4 §4.7.1
ABS_GATE_LUFS = -70.0
#: the spec's calibration offset: -0.691 makes a 997 Hz 0 dBFS sine read
#: -3.01 LKFS (it cancels the K-weighting shelf's gain at 997 Hz)
_OFFSET = -0.691


def k_weighting(sample_rate: float) -> tuple[Biquad, Biquad]:
    """K-weighting prefilter pair (high shelf + RLB high-pass), designed by
    the bilinear transform at ``sample_rate``; at 48 kHz it reproduces the
    BS.1770-4 Table 1/2 coefficients to about 1e-6."""
    # stage 1: +4 dB high shelf (head effects)
    f0, g_db, q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    k = math.tan(math.pi * f0 / sample_rate)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    shelf = Biquad(
        (vh + vb * k / q + k * k) / a0,
        2.0 * (k * k - vh) / a0,
        (vh - vb * k / q + k * k) / a0,
        2.0 * (k * k - 1.0) / a0,
        (1.0 - k / q + k * k) / a0,
    )
    # stage 2: RLB high-pass (revised low-frequency B-curve)
    f0, q = 38.13547087602444, 0.5003270373238773
    k = math.tan(math.pi * f0 / sample_rate)
    a0 = 1.0 + k / q + k * k
    hp = Biquad(
        1.0,
        -2.0,
        1.0,
        2.0 * (k * k - 1.0) / a0,
        (1.0 - k / q + k * k) / a0,
    )
    return shelf, hp


def k_weight(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Apply the K-weighting prefilter to ``x [..., T]``."""
    return biquad_chain(x, k_weighting(sample_rate))[0]


def _block_power(z: torch.Tensor, sample_rate: float, window_s: float, step_s: float) -> torch.Tensor:
    """Mean-square power of K-weighted ``z`` over overlapping gating blocks,
    ``[..., n_blocks]``; block i covers ``[i*step, i*step + window)``.
    Tail samples that do not fill a block are dropped (the spec gates only
    complete blocks)."""
    win = int(round(window_s * sample_rate))
    hop = int(round(step_s * sample_rate))
    if z.shape[-1] < win:
        raise ValueError(
            f"signal too short for a {window_s} s gating block ({z.shape[-1]} < {win} samples)"
        )
    blocks = frame(z, win, hop)  # [..., n_blocks, win]
    return (blocks * blocks).mean(dim=-1)


def _lufs(power: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return _OFFSET + 10.0 * torch.log10(torch.clamp_min(power, eps))


def momentary_loudness(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Momentary loudness (400 ms blocks, 100 ms step), LKFS ``[..., n]``."""
    return _lufs(_block_power(k_weight(x, sample_rate), sample_rate, 0.4, 0.1))


def shortterm_loudness(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Short-term loudness (3 s blocks, 100 ms step), LKFS ``[..., n]``."""
    return _lufs(_block_power(k_weight(x, sample_rate), sample_rate, 3.0, 0.1))


def _gated_mean_power(p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``p`` where ``mask``, per lane (0 where no block survives)."""
    n = torch.clamp_min(mask.sum(dim=-1), 1)
    return torch.where(mask, p, 0.0).sum(dim=-1) / n


def integrated_loudness(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Gated integrated loudness (BS.1770-4 §4.7), LKFS per lane ``[...]``.

    Two-stage gating: blocks below -70 LKFS absolute are dropped; the mean
    power of the survivors sets a relative threshold 10 LU lower; the
    loudness is the mean power of the blocks above it. A lane whose blocks
    are all gated (silence) reads -inf.
    """
    p = _block_power(k_weight(x, sample_rate), sample_rate, 0.4, 0.1)
    l_blk = _lufs(p)
    m_abs = l_blk > ABS_GATE_LUFS
    rel_thresh = _lufs(_gated_mean_power(p, m_abs)) - 10.0
    m_rel = m_abs & (l_blk > rel_thresh[..., None])
    silent = m_rel.sum(dim=-1) == 0
    return torch.where(silent, -math.inf, _lufs(_gated_mean_power(p, m_rel)))


def _masked_percentile(v: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Percentile of ``v`` where ``mask`` (same shape): the lower value on
    the sorted survivor prefix, its index ``q * (n - 1)`` truncated as int32."""
    big = torch.finfo(v.dtype).max
    sv = torch.sort(torch.where(mask, v, big), dim=-1).values
    n = mask.sum(dim=-1)
    idx = torch.clamp((q * (n - 1)).to(torch.int32), 0, v.shape[-1] - 1)
    return torch.gather(sv, -1, idx[..., None].long())[..., 0]


def loudness_range(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Loudness range LRA (EBU TECH 3342), LU per lane ``[...]``: short-term
    loudness gated at -70 LKFS absolute and -20 LU relative to the gated
    mean; LRA = p95 - p10 of the survivors (0 where none survives)."""
    p = _block_power(k_weight(x, sample_rate), sample_rate, 3.0, 0.1)
    l_blk = _lufs(p)
    m_abs = l_blk > ABS_GATE_LUFS
    rel = _lufs(_gated_mean_power(p, m_abs)) - 20.0
    m = m_abs & (l_blk > rel[..., None])
    out = _masked_percentile(l_blk, m, 0.95) - _masked_percentile(l_blk, m, 0.10)
    return torch.where(m.sum(dim=-1) == 0, 0.0, out)


def true_peak(x: torch.Tensor, sample_rate: float, oversample: int = 4) -> torch.Tensor:
    """True-peak level, dBTP per lane ``[...]`` (BS.1770-4 Annex 2):
    inter-sample peaks by the port's kaiser-sinc polyphase upsampler at
    ``oversample`` x; ``oversample=1`` is the sample peak."""
    peak = x.abs().amax(dim=-1)
    if oversample > 1:
        up = resample(x, int(sample_rate), int(sample_rate) * oversample)
        # the inter-sample estimate can only raise the peak
        peak = torch.maximum(up.abs().amax(dim=-1), peak)
    return 20.0 * torch.log10(torch.clamp_min(peak, 1e-12))


def normalize_loudness(
    x: torch.Tensor,
    sample_rate: float,
    target_lufs: float = -23.0,
    max_true_peak_db: float | None = -1.0,
    oversample: int = 4,
) -> torch.Tensor:
    """Scale each lane to ``target_lufs`` integrated loudness (EBU R128), a
    pure gain. With ``max_true_peak_db`` the gain is capped so the true
    peak stays at or below it (the R128 -1 dBTP ceiling). Silent lanes pass
    through unscaled."""
    gain_db = target_lufs - integrated_loudness(x, sample_rate)
    if max_true_peak_db is not None:
        gain_db = torch.minimum(gain_db, max_true_peak_db - true_peak(x, sample_rate, oversample))
    gain = torch.where(torch.isfinite(gain_db), torch.pow(10.0, gain_db / 20.0), 1.0)
    return x * gain[..., None]


def gating_block_count(n_samples: int, sample_rate: float, window_s: float = 0.4, step_s: float = 0.1) -> int:
    """Number of complete gating blocks a signal yields (host-side helper)."""
    return num_frames(n_samples, int(round(window_s * sample_rate)), int(round(step_s * sample_rate)))
