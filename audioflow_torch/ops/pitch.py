"""YIN and pYIN fundamental-frequency estimation.

Mirrors ``audioflow_tpu/ops/pitch.py`` (YIN, de Cheveigné & Kawahara 2002;
pYIN, Mauch & Dixon 2014) with the conventions of librosa: ``win =
frame//2``, a lag range from fmin/fmax, parabolic refinement. The
difference function over all frames at once is ``e0 + e(tau) - 2*acf(tau)``
with the energies from a cumulative sum; the autocorrelation is an rFFT
correlation (``impl="fft"``, cuFFT on the card) or three fp32 matmuls
against real DFT banks at the minimal transform length (``"matmul"``).
``"auto"`` is ``"fft"``, the JAX package's rule off a TPU.

pYIN keeps the JAX order of operations: lag-axis loops for the
per-threshold candidate counts and the rank weights (``lax.scan`` there),
the split candidate histogram (masked matmuls against a one-hot lag->bin
bank for all but the shortest lags, a compare loop for those), then the
two-track banded Viterbi. Its forward pass is the hand-written CUDA kernel
of :mod:`audioflow_torch.ops.kernels.viterbi` on the card; ``"xla"`` names
the plain per-frame loop. The backtrace and the f0 refinement are plain
torch with width-1 gathers.

Host designs (DFT correlation banks, beta masses, the histogram split, the
bin centres, the HMM constants) are float64 numpy copied from the JAX
package, bit for bit.

The streaming tracker (:func:`online_pyin_step`, fixed-lag Viterbi
smoothing) runs the same per-frame forward step as the offline plain scan,
a Python loop over frames. Its frame clock ``seen`` is a host int, as the
ring's cursors are, so warm-up gating is a host branch; every frame still
emits the decode JAX emits. The lag walk is ``lag`` width-1 gathers (the
JAX package's one-hot masked reduces are a TPU lowering choice; they read
the same integers). :func:`piptrack` is the spectral-peak tracker.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..utils import as_tensor
from ._mm import mm
from .framing import frame
from .kernels import viterbi as _viterbi
from .sequence import max_plus_band_argmax
from .stft import pad_center

ACF_PRECISION_DEFAULT = "high"  # the JAX default's name; the port computes in fp32

#: half-width of the matmul histogram's deviation window (see the histogram
#: in _pyin_observations): host analysis bounds |bin - base| <= 2 for the
#: matmul-group lags in float64, +1 margin for f32 rounding at .5 boundaries
_BIN_SPLIT_D = 3

VITERBI_IMPLS = ("auto", "xla", "pallas")
ACF_IMPLS = ("auto", "fft", "matmul")


@lru_cache(maxsize=32)
def _pyin_bin_split(sample_rate, fmin, n_bins, nbps, l_grid, dmax):
    """Host split of the candidate-histogram lag grid: (l_star, base,
    s0ext). ``base[l]`` is the pitch bin of INTEGER lag l; ``l_star`` is
    the smallest lag index such that every lag >= l_star keeps its whole
    parabolic-refinement bin interval (endpoints lag -/+ 0.5, clipping
    included, float64) within ``dmax - 1`` of base. ``s0ext`` is the one-hot
    lag->bin bank ``[l_grid - l_star, n_bins + 2*dmax]`` with
    ``s0ext[j, dmax + base[l_star + j]] = 1``. Cached: do not write to it."""
    ls = np.arange(l_grid, dtype=np.float64)

    def bin_of(f):
        return np.clip(
            np.round(12.0 * nbps * np.log2(np.maximum(f, 1e-9) / fmin)),
            0, n_bins - 1,
        ).astype(np.int64)

    base = bin_of(sample_rate / np.maximum(ls, 1.0))
    lo = bin_of(sample_rate / np.maximum(ls + 0.5, 1.0))
    hi = bin_of(sample_rate / np.maximum(ls - 0.5, 1.0))
    ok = (np.abs(lo - base) <= dmax - 1) & (np.abs(hi - base) <= dmax - 1)
    bad = np.nonzero(~ok)[0]
    l_star = int(bad.max()) + 1 if len(bad) else 0
    s0 = np.zeros((l_grid - l_star, n_bins + 2 * dmax), np.float32)
    if l_star < l_grid:
        s0[np.arange(l_grid - l_star), dmax + base[l_star:]] = 1.0
    return l_star, base.astype(np.int32), s0


@lru_cache(maxsize=32)
def _dft_corr_parts(n_rows: int, n: int, t_max: int):
    """Forward cos/sin matrices ``[n_rows, K]`` at transform length ``n`` and
    the Hermitian-weighted truncated-irfft cos/sin ``[K, t_max + 1]``.
    float64 design, float32 ship. Cached: do not write to them."""
    k_count = n // 2 + 1
    j = np.arange(n_rows, dtype=np.float64)[:, None]
    k = np.arange(k_count, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / n
    cosb, sinb = np.cos(ang), np.sin(ang)
    tau = np.arange(t_max + 1, dtype=np.float64)[None, :]
    wk = np.full((k_count, 1), 2.0)
    wk[0, 0] = 1.0
    if n % 2 == 0:
        wk[-1, 0] = 1.0
    angi = 2.0 * np.pi * np.arange(k_count, dtype=np.float64)[:, None] * tau / n
    icos, isin = wk * np.cos(angi) / n, wk * np.sin(angi) / n
    return (cosb.astype(np.float32), sinb.astype(np.float32),
            icos.astype(np.float32), isin.astype(np.float32))


def min_even_length(m: int) -> int:
    """Minimal even no-wraparound transform length >= m."""
    return m + (m & 1)


@lru_cache(maxsize=16)
def _acf_banks(w: int, t_max: int):
    """Cross-correlation packing of :func:`_dft_corr_parts`: forward bank
    ``[w + t_max, 2K]`` -> (Re | Im) DFT, inverse bank ``[2K, t_max + 1]``,
    and K. Cached: do not write to them."""
    m = w + t_max
    n = min_even_length(m)
    cosb, sinb, icos, isin = _dft_corr_parts(m, n, t_max)
    fwd = np.concatenate([cosb, -sinb], axis=1)  # [m, 2K]
    inv = np.concatenate([icos, -isin], axis=0)  # [2K, T+1]
    return fwd, inv, n // 2 + 1


def _acf_fft(fr: torch.Tensor, w: int, t_max: int) -> torch.Tensor:
    """acf(tau) = sum_{j<w} x_j x_{j+tau} via zero-padded rFFT correlation."""
    n = 1 << (w + 2 * t_max).bit_length()
    spec_full = torch.fft.rfft(fr, n=n, dim=-1)
    spec_win = torch.fft.rfft(fr[..., :w], n=n, dim=-1)
    return torch.fft.irfft(spec_full * torch.conj(spec_win), n=n, dim=-1)[..., : t_max + 1]


def _acf_matmul(fr: torch.Tensor, w: int, t_max: int, precision: str | None) -> torch.Tensor:
    """Same correlation as :func:`_acf_fft`, as three fp32 matmuls."""
    fwd_np, inv_np, k_count = _acf_banks(w, t_max)
    fwd = torch.from_numpy(fwd_np).to(fr.device)
    inv = torch.from_numpy(inv_np).to(fr.device)
    p = precision or ACF_PRECISION_DEFAULT
    f_spec = mm(fr, fwd, p)  # [..., 2K] (Re | Im)
    w_spec = mm(fr[..., :w], fwd[:w], p)
    re_f, im_f = f_spec[..., :k_count], f_spec[..., k_count:]
    re_w, im_w = w_spec[..., :k_count], w_spec[..., k_count:]
    # F * conj(W), packed (Re | Im) to feed one inverse product
    prod = torch.cat([re_f * re_w + im_f * im_w, im_f * re_w - re_f * im_w], dim=-1)
    return mm(prod, inv, p)


def _resolve_acf_impl(impl: str) -> str:
    """"auto" -> "fft": the JAX rule for every backend that is not a TPU."""
    if impl not in ACF_IMPLS:
        raise ValueError(f"unknown acf impl {impl!r}; known: auto, fft, matmul")
    return "fft" if impl == "auto" else impl


def _resolve_viterbi_impl(impl: str, device: torch.device, n_bins: int, kernel_len: int) -> bool:
    """True -> the fused forward pass (:mod:`..kernels.viterbi`).

    "auto" takes the kernel for a CUDA tensor when the band is supported and
    the plain scan otherwise, so always on the CPU. The JAX package keeps
    its scan under "auto" because its Pallas kernel spilled registers on the
    TPU; that reason does not hold on the card, where the plain scan is a
    loop of small launches per frame. "xla" is the plain scan; "pallas"
    forces the wrapper (its plain version on the CPU)."""
    if impl not in VITERBI_IMPLS:
        raise ValueError(f"unknown viterbi impl {impl!r}; known: auto, xla, pallas")
    ok = _viterbi.supported(n_bins, kernel_len)
    if impl == "pallas" and not ok:
        raise ValueError(
            "viterbi_impl='pallas' needs a supported band "
            f"(got n_bins={n_bins}, kernel_len={kernel_len})"
        )
    return impl == "pallas" or (impl == "auto" and ok and device.type == "cuda")


def _div(a, b) -> torch.Tensor:
    """``a / b`` as one float32 division, as JAX divides by or into a weakly
    typed Python number. torch computes ``float / tensor`` as a reciprocal
    times the float, and on the card ``tensor / float`` as a product with
    the reciprocal; a 0-d tensor on the other operand's device avoids both."""
    ref = b if isinstance(b, torch.Tensor) else a
    a = a if isinstance(a, torch.Tensor) else ref.new_tensor(a)
    b = b if isinstance(b, torch.Tensor) else ref.new_tensor(b)
    return torch.div(a, b)


def _parabolic_refine(prev, cur, nxt):
    """Vertex offset in [-0.5, 0.5] of the parabola through three equally
    spaced samples (flat/degenerate curvature guarded to 0)."""
    denom = prev - 2.0 * cur + nxt
    delta = torch.where(
        denom.abs() > 1e-12,
        0.5 * (prev - nxt) / torch.where(denom == 0, torch.ones_like(denom), denom),
        torch.zeros_like(denom),
    )
    return torch.clamp(delta, -0.5, 0.5)


def cmnd_frames(
    frames: torch.Tensor,
    win: int | None = None,
    max_lag: int | None = None,
    impl: str = "auto",
    precision: str | None = None,
) -> torch.Tensor:
    """Cumulative-mean-normalized difference d'(tau) for frames ``[..., F, L]``.

    Lags 0..T inclusive (T = ``max_lag`` or W = win or L//2); d'(0) = 1 by
    definition. ``impl`` picks the autocorrelation ("auto"/"fft"/"matmul");
    ``precision`` is checked and computes in fp32.
    """
    impl = _resolve_acf_impl(impl)
    l = frames.shape[-1]
    w = win or l // 2
    t_max = w if max_lag is None else min(int(max_lag), w)
    if w + t_max > l:
        raise ValueError(f"win {w} + max_lag {t_max} needs frame_length >= {w + t_max}, got {l}")
    frames = frames[..., : w + t_max]  # samples beyond W + max_lag never used
    acf = _acf_matmul(frames, w, t_max, precision) if impl == "matmul" else _acf_fft(frames, w, t_max)
    # both cumsums accumulate in float64 and round each entry once, as
    # torch's CPU cumsum does for float32: the card's fp32 scan sums in an
    # order that depends on the batch's shape, which the streaming nodes'
    # chunked frames would see as a difference from offline
    cs = torch.cumsum(frames * frames, dim=-1, dtype=torch.float64).to(frames.dtype)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)  # cs[k] = sum of first k squares
    e0 = cs[..., w : w + 1]
    # e(tau) = sum_{j=tau}^{tau+w-1} x_j^2, tau = 0..t_max
    e_tau = cs[..., w : w + t_max + 1] - cs[..., 0 : t_max + 1]
    d = torch.clamp_min(e0 + e_tau - 2.0 * acf, 0.0)
    # cumulative mean normalization: d'(tau) = d(tau) * tau / sum_{1..tau} d
    csd = torch.cumsum(d[..., 1:], dim=-1, dtype=torch.float64).to(d.dtype)
    tau = torch.arange(1, t_max + 1, dtype=frames.dtype, device=frames.device)
    dn = torch.where(csd > 0, d[..., 1:] * tau / torch.clamp_min(csd, 1e-30), torch.ones_like(csd))
    return torch.cat([torch.ones_like(d[..., :1]), dn], dim=-1)


def _lag_range(sample_rate, fmin, fmax, w):
    tau_lo = max(int(np.floor(sample_rate / fmax)), 2)
    tau_hi = min(int(np.ceil(sample_rate / fmin)), w - 1)
    if tau_lo >= tau_hi:
        raise ValueError(
            f"empty lag range for fmin={fmin}, fmax={fmax} at sr={sample_rate} "
            f"(win={w}); need sr/fmax < sr/fmin within [2, win-1]"
        )
    return tau_lo, tau_hi


def _neighbours(dn: torch.Tensor):
    """``dn`` shifted one lag right and left, edges repeated."""
    prev = torch.cat([dn[..., :1], dn[..., :-1]], dim=-1)
    nxt = torch.cat([dn[..., 1:], dn[..., -1:]], dim=-1)
    return prev, nxt


def yin_frames(
    frames: torch.Tensor,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    threshold: float = 0.1,
    win: int | None = None,
    impl: str = "auto",
    precision: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame ``(f0_hz, aperiodicity)`` from frames ``[..., F, L]``.

    Picks the first CMND trough below ``threshold`` within the lag range
    [sr/fmax, sr/fmin] (else the range's global minimum), refines the lag by
    parabolic interpolation, and reports the CMND value there as the
    aperiodicity.
    """
    w = win or frames.shape[-1] // 2
    tau_lo, tau_hi = _lag_range(sample_rate, fmin, fmax, w)
    # one lag past tau_hi so the trough test and the refinement at the range
    # edge see a real neighbour
    dn = cmnd_frames(frames, w, min(tau_hi + 1, w), impl, precision)  # [..., F, T+1]
    lags = torch.arange(dn.shape[-1], device=dn.device)
    in_range = (lags >= tau_lo) & (lags <= tau_hi)
    prev, nxt = _neighbours(dn)
    trough = (dn < prev) & (dn <= nxt) & (dn < threshold) & in_range
    has_trough = trough.any(dim=-1)
    first_trough = torch.argmax(trough.to(torch.uint8), dim=-1)  # argmax refuses bool
    big = torch.finfo(dn.dtype).max
    global_min = torch.argmin(torch.where(in_range, dn, torch.full_like(dn, big)), dim=-1)
    tau_star = torch.where(has_trough, first_trough, global_min)

    def at(idx):
        return torch.gather(dn, -1, idx[..., None])[..., 0]

    d0 = at(tau_star)
    dm = at(torch.clamp_min(tau_star - 1, 0))
    dp = at(torch.clamp_max(tau_star + 1, dn.shape[-1] - 1))
    tau_ref = tau_star.to(dn.dtype) + _parabolic_refine(dm, d0, dp)
    f0 = _div(sample_rate, torch.clamp_min(tau_ref, 1.0))
    return f0, d0


def _framed(x, frame_length: int, hop: int, center: bool, device):
    x = as_tensor(x, device)
    if center:
        x = pad_center(x, frame_length)
    return frame(x, frame_length, hop)


def yin_voicing(
    x,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    threshold: float = 0.1,
    center: bool = True,
    impl: str = "auto",
    precision: str | None = None,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`yin` but also returns the per-frame aperiodicity."""
    fr = _framed(x, frame_length, hop, center, device)
    return yin_frames(fr, sample_rate, fmin, fmax, threshold, None, impl, precision)


def yin(
    x,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    threshold: float = 0.1,
    center: bool = True,
    impl: str = "auto",
    precision: str | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Frame-wise f0 (Hz) of a signal ``[..., T]`` -> ``[..., F]``.

    ``x`` is a tensor, or a numpy array that goes to ``device`` ("cuda"
    unless given; :func:`audioflow_torch.utils.as_tensor`). ``center=True``
    reflect-pads by frame_length//2 so frame i is centred on sample i*hop.
    """
    return yin_voicing(x, sample_rate, fmin, fmax, frame_length, hop, threshold, center, impl, precision,
                       device)[0]


# ---------------------------------------------------------------------------
# pYIN: probabilistic YIN with HMM smoothing. Every CMND trough in the lag
# range becomes a pitch candidate; candidates are histogrammed into pitch
# bins and decoded by a voiced/unvoiced HMM whose pitch transitions are a
# local triangular band. The JAX package documents two deviations from the
# row-renormalized convention, kept here: edge bins use the truncated
# (substochastic) kernel, and trough depths are thresholded raw.
# ---------------------------------------------------------------------------


def _beta_interval_masses(a: float, b: float, n_thresholds: int) -> np.ndarray:
    """Probability mass of Beta(a, b) on each of ``n_thresholds`` equal
    intervals of [0, 1]: host-side trapezoid quadrature, float64."""
    grid = np.linspace(0.0, 1.0, 1 << 17)
    with np.errstate(divide="ignore", invalid="ignore"):
        pdf = grid ** (a - 1.0) * (1.0 - grid) ** (b - 1.0)
    pdf[~np.isfinite(pdf)] = 0.0
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(grid))])
    cdf /= cdf[-1]
    edges = np.linspace(0.0, 1.0, n_thresholds + 1)
    return np.diff(np.interp(edges, grid, cdf))


def _pitch_bin_centers(fmin, n_bins, nbps, device=None) -> torch.Tensor:
    """The centre frequency of every pitch bin, float32 (designed in float64)."""
    c = (fmin * 2.0 ** (np.arange(n_bins, dtype=np.float64) / (12.0 * nbps))).astype(np.float32)
    return torch.from_numpy(c).to(device)


def _pyin_bins(resolution: float, fmin: float, fmax: float) -> tuple[int, int]:
    """``(nbps, n_bins)``: bins per semitone and the bin count of [fmin, fmax]."""
    if not 0.0 < resolution <= 12.0:
        raise ValueError(f"resolution (semitones/bin) must be in (0, 12], got {resolution}")
    nbps = max(1, int(round(1.0 / resolution)))
    return nbps, int(np.floor(12.0 * nbps * np.log2(fmax / fmin))) + 1


def _pyin_log_obs(obs_v: torch.Tensor, voiced_prob: torch.Tensor, n_bins: int):
    """``(log_obs_voiced, log_obs_unvoiced)`` ``[.., F, N]`` from the linear
    bin observations: the unvoiced track spreads 1 - P(voiced) uniformly."""
    log_floor = float(np.float32(np.log(1e-30)))
    log_obs_v = torch.log(torch.clamp_min(obs_v, 1e-30))
    log_obs_u = torch.clamp_min(torch.log(torch.clamp_min(_div(1.0 - voiced_prob, float(n_bins)), 1e-30)),
                                log_floor)
    return log_obs_v, log_obs_u[..., None].expand(*log_obs_u.shape, n_bins)


def _pyin_hmm_consts(sample_rate, hop, nbps, max_transition_rate, switch_prob, device=None):
    """Banded two-track HMM constants: ``(half, log_kernel, log_stay,
    log_switch)``, float32 tensors. ``half`` is the largest pitch movement
    in bins per frame."""
    half = max(1, int(round(max_transition_rate * 12.0 * nbps * hop / sample_rate)))
    tri = 1.0 - np.abs(np.arange(-half, half + 1, dtype=np.float64)) / (half + 1.0)
    log_kernel = torch.from_numpy(np.log(tri / tri.sum()).astype(np.float32)).to(device)
    log_stay = torch.tensor(np.float32(np.log1p(-switch_prob)), device=device)
    log_switch = torch.tensor(np.float32(np.log(switch_prob)), device=device)
    return half, log_kernel, log_stay, log_switch


def _pyin_observations(
    frames,
    sample_rate,
    fmin,
    fmax,
    *,
    win=None,
    n_thresholds=100,
    beta_parameters=(2.0, 18.0),
    boltzmann_parameter=2.0,
    resolution=0.1,
    no_trough_prob=0.01,
    impl="auto",
    precision=None,
):
    """Frame-local pYIN candidate stage: frames ``[..., F, L]`` ->
    ``(obs_v [.., F, N], voiced_prob [.., F], trough, prob, f0_lag, bins
    [.., F, T+1], n_bins, nbps)``, everything before the HMM decode."""
    nbps, n_bins = _pyin_bins(resolution, fmin, fmax)
    w = win or frames.shape[-1] // 2
    tau_lo, tau_hi = _lag_range(sample_rate, fmin, fmax, w)
    dn = cmnd_frames(frames, w, min(tau_hi + 1, w), impl, precision)  # [..., F, T+1]
    dtype, dev = dn.dtype, dn.device
    lags = torch.arange(dn.shape[-1], device=dev)
    in_range = (lags >= tau_lo) & (lags <= tau_hi)
    prev, nxt = _neighbours(dn)
    trough = (dn < prev) & (dn <= nxt) & in_range  # all local minima, no cap

    # parabolic refinement at every lag (only trough lags are ever read)
    delta = _parabolic_refine(prev, dn, nxt)
    f0_lag = _div(sample_rate, torch.clamp_min(lags.to(dtype) + delta, 1.0))

    # --- per-threshold candidate weighting, as two loops over the lag axis ---
    # pass 1 counts, per frame and threshold, the troughs below it; pass 2
    # carries the rank weight exp(-lam * count) multiplicatively (decay at
    # each qualifying trough), as the JAX package's two lax.scans do
    lam = float(boltzmann_parameter)
    m_count = int(n_thresholds)
    masses = torch.from_numpy(_beta_interval_masses(*beta_parameters, m_count).astype(np.float32)).to(dev)
    thresholds = torch.from_numpy(np.linspace(0.0, 1.0, m_count + 1)[1:].astype(np.float32)).to(dev)
    decay = torch.exp(torch.tensor(-lam, dtype=dtype, device=dev))
    geo = 1.0 - decay
    tr_t = trough.movedim(-1, 0)  # [L, .., F]
    dn_t = dn.movedim(-1, 0)
    n_q = torch.zeros((*dn.shape[:-1], m_count), dtype=dtype, device=dev)
    for tr, dnl in zip(tr_t, dn_t):
        n_q += (tr[..., None] & (dnl[..., None] < thresholds)).to(dtype)
    norm_inv = torch.where(n_q > 0, 1.0 / (1.0 - torch.exp(-lam * n_q)), torch.ones_like(n_q))
    cmn = masses * norm_inv * geo  # [.., F, M]
    nt_mass = (masses * (n_q <= 0)).sum(dim=-1)

    wgt = torch.ones_like(n_q)
    prob_t = []
    for tr, dnl in zip(tr_t, dn_t):
        q_m = tr[..., None] & (dnl[..., None] < thresholds)  # [.., F, M]
        prob_t.append(torch.where(q_m, wgt * cmn, 0.0).sum(dim=-1))
        wgt = torch.where(q_m, wgt * decay, wgt)
    prob = torch.stack(prob_t, dim=-1)  # [.., F, L]

    # thresholds nothing cleared: no_trough_prob of their mass goes to the
    # globally deepest trough (frames with no troughs at all keep prob 0)
    big = torch.finfo(dtype).max
    gmin = torch.argmin(torch.where(trough, dn, torch.full_like(dn, big)), dim=-1)
    has_any = trough.any(dim=-1)
    gmin_hot = (lags == gmin[..., None]) & has_any[..., None]
    prob = prob + gmin_hot * (no_trough_prob * nt_mass)[..., None]

    # summed in float64 and rounded once: on the card an fp32 sum over a
    # 249-lag row splits by the row's address alignment, so a frame's sum
    # would depend on its position in the batch (chunked against offline)
    voiced_prob = torch.clamp(prob.sum(dim=-1, dtype=torch.float64).to(dtype), 0.0, 1.0)

    # --- candidate probabilities -> pitch-bin observations ---
    bins = torch.clamp(
        torch.round(12.0 * nbps * torch.log2(_div(f0_lag, fmin))).to(torch.int32), 0, n_bins - 1
    )
    # the split histogram: for lags >= l_star a candidate's bin is the static
    # bin of its integer lag plus a deviation |d| <= _BIN_SPLIT_D, so those
    # lags reduce to 2*_BIN_SPLIT_D+1 masked matmuls against a one-hot
    # lag->bin bank; the short-lag head keeps a compare loop
    ngrid = torch.arange(n_bins, dtype=torch.int32, device=dev)
    l_grid = dn.shape[-1]
    l_star, base_np, s0ext_np = _pyin_bin_split(
        float(sample_rate), float(fmin), n_bins, nbps, l_grid, _BIN_SPLIT_D
    )
    obs_v = torch.zeros((*dn.shape[:-1], n_bins), dtype=dtype, device=dev)
    if l_star < l_grid:
        base_t = torch.from_numpy(base_np[l_star:]).to(dev)
        s0ext = torch.from_numpy(s0ext_np).to(dev)
        prob_g = prob[..., l_star:]
        dev_bins = bins[..., l_star:] - base_t
        obs_m = None
        for d in range(-_BIN_SPLIT_D, _BIN_SPLIT_D + 1):
            yd = mm(torch.where(dev_bins == d, prob_g, 0.0), s0ext, precision or ACF_PRECISION_DEFAULT)
            part = yd[..., _BIN_SPLIT_D - d : _BIN_SPLIT_D - d + n_bins]
            obs_m = part if obs_m is None else obs_m + part
        obs_v = obs_v + obs_m
    for p, b in zip(prob[..., :l_star].movedim(-1, 0), bins[..., :l_star].movedim(-1, 0)):
        obs_v = obs_v + torch.where(b[..., None] == ngrid, p[..., None], 0.0)
    return obs_v, voiced_prob, trough, prob, f0_lag, bins, n_bins, nbps


def _viterbi_scan(ov, ou, log_init, log_kernel, log_stay, log_switch):
    """The plain forward pass: a loop over frames of the banded max-plus step
    per track and :func:`~..kernels.viterbi.merge_tracks`, as the JAX
    package's ``vit_step`` scan. ``ov``/``ou`` are ``[F, ..., N]``; returns
    the final messages, and per step the offsets (int16, 0..2*half) and the
    picks ``[F-1, 2, ..., N]``, track 0 voiced."""
    dv, du = log_init + ov[0], log_init + ou[0]
    off = torch.zeros((ov.shape[0] - 1, 2, *ov.shape[1:]), dtype=torch.int16, device=ov.device)
    pick = torch.zeros_like(off, dtype=torch.bool)
    for t in range(1, ov.shape[0]):
        bv, av = max_plus_band_argmax(dv, log_kernel)
        bu, au = max_plus_band_argmax(du, log_kernel)
        dv, du, off[t - 1, 0], pick[t - 1, 0], off[t - 1, 1], pick[t - 1, 1] = _viterbi.merge_tracks(
            bv, av, bu, au, ov[t], ou[t], log_stay, log_switch
        )
    return dv, du, off, pick


def pyin_frames(
    frames: torch.Tensor,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    *,
    hop: int = 256,
    win: int | None = None,
    n_thresholds: int = 100,
    beta_parameters: tuple[float, float] = (2.0, 18.0),
    boltzmann_parameter: float = 2.0,
    resolution: float = 0.1,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    max_transition_rate: float = 35.92,
    impl: str = "auto",
    precision: str | None = None,
    viterbi_impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pYIN from frames ``[..., F, L]`` -> ``(f0_hz, voiced_flag, voiced_prob)``.

    The knobs are the JAX package's: a beta-distributed grid of
    ``n_thresholds`` YIN thresholds, a truncated-geometric rank prior
    (``boltzmann_parameter``), ``no_trough_prob`` of unclaimed mass to the
    deepest trough, pitch bins of ``resolution`` semitones, an HMM with local
    triangular pitch movement up to ``max_transition_rate`` octaves/s at
    analysis hop ``hop`` and voicing switch probability ``switch_prob``,
    decoded exactly by a banded Viterbi. ``f0_hz`` is reported for every
    frame, refined to the winning candidate's parabolic lag when the decoded
    bin has one.

    ``viterbi_impl``: "auto" (the CUDA kernel for a CUDA tensor where the
    band is supported, the plain scan otherwise), "xla" (the plain scan) or
    "pallas" (the kernel's wrapper, forced: its plain version on the CPU).
    The decodes are identical.
    """
    if not 0.0 < switch_prob < 1.0:
        raise ValueError(f"switch_prob must be in (0, 1), got {switch_prob}")
    nbps, n_bins = _pyin_bins(resolution, fmin, fmax)
    half, log_kernel, log_stay, log_switch = _pyin_hmm_consts(
        sample_rate, hop, nbps, max_transition_rate, switch_prob, frames.device
    )
    fused = _resolve_viterbi_impl(viterbi_impl, frames.device, n_bins, 2 * half + 1)
    obs_v, voiced_prob, trough, prob, f0_lag, bins, _, _ = _pyin_observations(
        frames, sample_rate, fmin, fmax, win=win, n_thresholds=n_thresholds,
        beta_parameters=beta_parameters, boltzmann_parameter=boltzmann_parameter,
        resolution=resolution, no_trough_prob=no_trough_prob, impl=impl, precision=precision,
    )
    log_obs_v, log_obs_u = _pyin_log_obs(obs_v, voiced_prob, n_bins)
    ov = log_obs_v.movedim(-2, 0)  # [F, ..., N]
    ou = log_obs_u.movedim(-2, 0)
    log_init = -np.log(2 * n_bins)

    # forward pass: offsets (0..2*half) and unvoiced-source picks per step,
    # [F-1, 2, ..., N] with track 0 voiced
    if fused:
        dv, du, off, pick = _viterbi.pyin_viterbi_forward(
            ov, ou, log_kernel, log_init, np.log1p(-switch_prob), np.log(switch_prob)
        )
        # offsets come back centred (int8-safe); add half back
        off, pick = off[1:].to(torch.int32) + half, pick[1:].to(torch.bool)
    else:
        dv, du, off, pick = _viterbi_scan(
            ov, ou, ov.new_tensor(np.float32(log_init)), log_kernel, log_stay, log_switch
        )
    # prev-state maps [F-1, ..., 2N]: entry s of step t is the state at frame
    # t that state s (voiced bins, then unvoiced) at frame t+1 came from
    grid = torch.arange(n_bins, dtype=torch.int32, device=dv.device)
    prev_map = torch.clamp(grid + off.to(torch.int32) - half, 0, n_bins - 1) + n_bins * pick.to(torch.int32)
    prev_map = prev_map.movedim(1, -2).flatten(-2).to(torch.int64)

    # backtrace from the first maximum over both tracks, width-1 gathers
    state = torch.argmax(torch.cat([dv, du], dim=-1), dim=-1, keepdim=True)
    states = [state]
    for t in range(prev_map.shape[0] - 1, -1, -1):
        state = torch.gather(prev_map[t], -1, state)
        states.append(state)
    states = torch.cat(states[::-1], dim=-1)  # [..., F]

    voiced_flag = states < n_bins
    bin_dec = states - n_bins * (~voiced_flag).to(states.dtype)

    # refine: the decoded bin's best candidate (the first maximum) carries
    # the f0, else the bin centre
    score = torch.where(trough & (bins == bin_dec[..., None]), prob, -1.0)
    mx, hit = score.max(dim=-1)
    f0_cand = torch.gather(f0_lag, -1, hit[..., None])[..., 0]
    centers = _pitch_bin_centers(fmin, n_bins, nbps, f0_lag.device)
    f0 = torch.where(mx > 0.0, f0_cand, centers[bin_dec])
    return f0, voiced_flag, voiced_prob


def pyin(
    x,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    center: bool = True,
    device: torch.device | str | None = None,
    **kwargs,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pYIN over a signal ``[..., T]`` -> ``(f0 [..., F], voiced_flag,
    voiced_prob)``; see :func:`pyin_frames` for the knobs. ``x`` is a tensor,
    or a numpy array that goes to ``device`` ("cuda" unless given).
    ``center=True`` reflect-pads so frame i is centred on sample i*hop."""
    fr = _framed(x, frame_length, hop, center, device)
    return pyin_frames(fr, sample_rate, fmin, fmax, hop=hop, **kwargs)


# ---------------------------------------------------------------------------
# Streaming pYIN: fixed-lag Viterbi smoothing. At every consumed frame t the
# decode backtracks ``lag`` steps from the current best state and emits the
# decision for frame t - lag. State: the pair of max-plus messages, a
# lag-deep ring of prev-state maps and lag+1-deep rings of the frame-local
# candidate tables the f0 refinement needs (newest at index 0, as in the
# JAX package). Streamed equals the offline run of the same algorithm.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OnlinePyinPlan:
    """Static configuration of the fixed-lag streaming pYIN tracker."""

    sample_rate: float
    fmin: float
    fmax: float
    frame_length: int
    hop: int
    lag: int
    n_thresholds: int = 100
    beta_parameters: tuple = (2.0, 18.0)
    boltzmann_parameter: float = 2.0
    resolution: float = 0.1
    switch_prob: float = 0.01
    no_trough_prob: float = 0.01
    max_transition_rate: float = 35.92
    impl: str = "auto"
    precision: str | None = None

    @property
    def nbps(self) -> int:
        return _pyin_bins(self.resolution, self.fmin, self.fmax)[0]

    @property
    def n_bins(self) -> int:
        return _pyin_bins(self.resolution, self.fmin, self.fmax)[1]

    @property
    def t_max(self) -> int:
        w = self.frame_length // 2
        tau_hi = min(int(np.ceil(self.sample_rate / self.fmin)), w - 1)
        return min(tau_hi + 1, w)


def make_online_pyin_plan(
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    lag: int = 25,
    **kwargs,
) -> OnlinePyinPlan:
    """Validated :class:`OnlinePyinPlan`; ``lag`` is the decode delay in
    frames (latency = lag * hop samples on top of the framing overlap)."""
    if lag < 1:
        raise ValueError(f"lag must be >= 1 frame, got {lag}")
    plan = OnlinePyinPlan(sample_rate, fmin, fmax, int(frame_length), int(hop), int(lag), **kwargs)
    if not 0.0 < plan.resolution <= 12.0:
        raise ValueError(f"resolution (semitones/bin) must be in (0, 12], got {plan.resolution}")
    if not 0.0 < plan.switch_prob < 1.0:
        raise ValueError(f"switch_prob must be in (0, 1), got {plan.switch_prob}")
    return plan


def online_pyin_init(plan: OnlinePyinPlan, lead_shape=(), dtype=torch.float32, device=None) -> dict:
    """Zero streaming state: uniform max-plus messages (re-seeded at the
    first consumed frame), empty prev-state and candidate rings, and the
    frame clock ``seen`` (a host int). The prev-state ring holds int64
    state indices, what ``torch.gather`` takes (int32 in the JAX package)."""
    n, t1, lag = plan.n_bins, plan.t_max + 1, plan.lag
    return {
        "dv": torch.zeros((*lead_shape, n), dtype=dtype, device=device),
        "du": torch.zeros((*lead_shape, n), dtype=dtype, device=device),
        "prev": torch.zeros((*lead_shape, lag, 2 * n), dtype=torch.int64, device=device),
        "score": torch.full((*lead_shape, lag + 1, t1), -1.0, dtype=dtype, device=device),
        "f0r": torch.zeros((*lead_shape, lag + 1, t1), dtype=dtype, device=device),
        "bins": torch.zeros((*lead_shape, lag + 1, t1), dtype=torch.int32, device=device),
        "vp": torch.zeros((*lead_shape, lag + 1), dtype=dtype, device=device),
        "seen": 0,
    }


def _push(ring: torch.Tensor, new: torch.Tensor, axis: int) -> torch.Tensor:
    """``new`` in front of ``ring`` along ``axis`` (-1 or -2), the oldest
    entry dropped."""
    return torch.cat([new.unsqueeze(axis), ring.narrow(axis, 0, ring.shape[axis] - 1)], dim=axis)


def online_pyin_step(
    plan: OnlinePyinPlan,
    state: dict,
    frames: torch.Tensor,
    skip_first: int = 0,
) -> tuple[dict, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Consume frames ``[..., F, L]`` -> ``(state, (f0, voiced_flag,
    voiced_prob))`` each ``[..., F]``.

    The emission at frame index j is the fixed-lag decode of consumed frame
    ``j - plan.lag``. ``skip_first`` ignores the first ``skip_first`` frames
    the state ever sees (a streaming node's zero-prehistory framing tail),
    tracked across chunks by the state's frame clock, so the caller passes a
    constant. Callers discard the first ``skip_first + lag`` emissions: they
    decode skipped or not-yet-seen frames (the ``OnlinePyin`` node does so
    through its declared latency). They are computed all the same, from the
    state as the JAX package computes them, so every emission equals its.
    """
    dtype, dev = frames.dtype, frames.device
    lag, n_bins = plan.lag, plan.n_bins
    obs_v, voiced_prob, trough, prob, f0_lag, bins, n_bins_o, nbps = _pyin_observations(
        frames, plan.sample_rate, plan.fmin, plan.fmax, n_thresholds=plan.n_thresholds,
        beta_parameters=plan.beta_parameters, boltzmann_parameter=plan.boltzmann_parameter,
        resolution=plan.resolution, no_trough_prob=plan.no_trough_prob, impl=plan.impl,
        precision=plan.precision,
    )
    assert n_bins_o == n_bins, (n_bins_o, n_bins)
    log_obs_v, log_obs_u = _pyin_log_obs(obs_v, voiced_prob, n_bins)
    half, log_kernel, log_stay, log_switch = _pyin_hmm_consts(
        plan.sample_rate, plan.hop, nbps, plan.max_transition_rate, plan.switch_prob, dev
    )
    centers = _pitch_bin_centers(plan.fmin, n_bins, nbps, dev)
    log_init = torch.tensor(np.float32(-np.log(2 * n_bins)), device=dev)
    score = torch.where(trough, prob, -1.0)
    grid = torch.arange(n_bins, dtype=torch.int64, device=dev)

    c = dict(state)
    f0s, vfs, vps = [], [], []
    for t in range(frames.shape[-2]):
        lv, lu = log_obs_v[..., t, :], log_obs_u[..., t, :]
        live = c["seen"] >= skip_first
        # the forward max-plus step; the uniform-init form at the first
        # consumed frame is the offline tracker's delta_0
        bv, av = max_plus_band_argmax(c["dv"], log_kernel)
        bu, au = max_plus_band_argmax(c["du"], log_kernel)
        new_v, new_u, off_v, pick_v, off_u, pick_u = _viterbi.merge_tracks(
            bv, av, bu, au, lv, lu, log_stay, log_switch
        )
        prev_v = torch.clamp(grid + off_v - half, 0, n_bins - 1) + n_bins * pick_v
        prev_u = torch.clamp(grid + off_u - half, 0, n_bins - 1) + n_bins * pick_u
        if c["seen"] == skip_first:
            dv, du = log_init + lv, log_init + lu
        else:
            dv, du = new_v, new_u
        # rings, newest at index 0 (the map pushed at the first consumed
        # frame is never walked: valid emissions stop at frame >= 1)
        new_c = {
            "dv": dv, "du": du,
            "prev": _push(c["prev"], torch.cat([prev_v, prev_u], dim=-1), -2),
            "score": _push(c["score"], score[..., t, :], -2),
            "f0r": _push(c["f0r"], f0_lag[..., t, :], -2),
            "bins": _push(c["bins"], bins[..., t, :], -2),
            "vp": _push(c["vp"], voiced_prob[..., t], -1),
        }
        # fixed-lag decode: the first maximum now, walked `lag` maps back
        s = torch.argmax(torch.cat([dv, du], dim=-1), dim=-1, keepdim=True)
        for k in range(lag):
            s = torch.gather(new_c["prev"][..., k, :], -1, s)
        unvoiced = s[..., 0] >= n_bins
        b = s[..., 0] - n_bins * unvoiced
        sc_e = new_c["score"][..., lag, :]
        cand = torch.where((new_c["bins"][..., lag, :] == b[..., None]) & (sc_e > 0.0), sc_e, -1.0)
        mx, hit = cand.max(dim=-1)  # the first maximum, as the JAX package's cumsum rule
        f0_cand = torch.gather(new_c["f0r"][..., lag, :], -1, hit[..., None])[..., 0]
        f0s.append(torch.where(mx > 0.0, f0_cand, torch.take(centers, b)))
        vfs.append(~unvoiced)
        vps.append(new_c["vp"][..., lag])
        if live:
            c.update(new_c)
        c["seen"] += 1
    return c, (torch.stack(f0s, dim=-1), torch.stack(vfs, dim=-1), torch.stack(vps, dim=-1))


def pyin_online(
    x,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    lag: int = 25,
    device: torch.device | str | None = None,
    **kwargs,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-lag streaming pYIN over a whole signal ``[..., T]`` -> ``(f0,
    voiced_flag, voiced_prob)`` each ``[..., F]`` on the emission timeline:
    index j decodes frame j - ``lag`` (the first ``lag`` outputs are
    warm-up). The offline run of exactly what the ``OnlinePyin`` node
    streams (center=False framing, zero initial state). ``x`` is a tensor,
    or numpy that goes to ``device`` ("cuda" unless given)."""
    plan = make_online_pyin_plan(sample_rate, fmin, fmax, frame_length, hop, lag, **kwargs)
    fr = frame(as_tensor(x, device), frame_length, hop)
    state = online_pyin_init(plan, fr.shape[:-2], fr.dtype, fr.device)
    return online_pyin_step(plan, state, fr, skip_first=0)[1]


def piptrack(
    spec_mag,
    sample_rate: float,
    n_fft: int,
    fmin: float = 150.0,
    fmax: float = 4000.0,
    threshold: float = 0.1,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Spectral-peak pitch candidates (the parabolic-interpolation
    'piptrack' convention) from a magnitude spectrogram ``[..., T, bins]``.

    A bin is a candidate iff it is a local max across frequency, within
    [fmin, fmax] (a mask designed in float64 on the host), and at least
    ``threshold * frame_max``. Returns ``(pitches, mags)`` the shape of the
    input: zero except at candidate bins, where ``pitches`` holds the
    parabolic-refined frequency in Hz and ``mags`` the interpolated
    magnitude. ``spec_mag`` is a tensor, or numpy that goes to ``device``.
    """
    s = as_tensor(spec_mag, device)
    bins = s.shape[-1]
    freqs = np.arange(bins) * sample_rate / n_fft
    prev = torch.cat([s[..., :1], s[..., :-1]], dim=-1)
    nxt = torch.cat([s[..., 1:], s[..., -1:]], dim=-1)
    shift = _parabolic_refine(prev, s, nxt)
    in_band = torch.from_numpy((freqs >= fmin) & (freqs <= fmax)).to(s.device)
    frame_max = s.amax(dim=-1, keepdim=True)
    peak = (s > prev) & (s >= nxt) & in_band & (s >= threshold * frame_max)
    bin_idx = torch.arange(bins, dtype=s.dtype, device=s.device)
    pitches = torch.where(peak, (bin_idx + shift) * (sample_rate / n_fft), 0.0)
    mags = torch.where(peak, s - 0.25 * (prev - nxt) * shift, 0.0)
    return pitches, mags
