"""Constant-Q transform (CQT) and its inverses.

Mirrors ``audioflow_tpu/ops/cqt.py``. Every CQT bin is a windowed complex
sinusoid kernel designed on the host in float64 and shipped as fp32 cos|sin
banks; the designs (:func:`_design`, :func:`_dual_design`,
:func:`_hybrid_design`, :func:`_multirate_design`) are the JAX package's,
bit for bit, and are uploaded once per device.

The forward product never materialises the frames. Every frame length is a
multiple of the hop, so frame t of ``x`` is the hop blocks t .. t + tb - 1
and ``frames @ bank`` is a ``tb``-tap correlation over the signal's hop
blocks: one ``conv1d`` with ``hop`` input channels (:func:`_framed_dot`).
A matmul on the framed ``unfold`` view would copy every frame (the frames of
32 x 10 s at 44.1 kHz hold 4.8 GB at the default config). The inverses are
the JAX package's: the painless dual is one matmul and an overlap-add; the
hybrid's dual branch and the multirate synthesis are hop-block feature
convolutions (``conv1d`` of the coefficient sequence), and the hybrid's
sinusoidal branch is elementwise, with its burst sum accumulated one
component at a time.

Geometry and normalization are the JAX package's: frame t's kernels are
centered at sample ``t * hop`` when ``center=True`` and at
``t * hop + F0 // 2`` otherwise, ``F0`` the lowest octave's frame length;
each kernel is scaled by ``2 / sum(window)``, so a unit sinusoid at a bin's
center frequency reads about 1.0 there. ``precision`` takes the JAX
package's names; the port computes in fp32 (``ops/_mm.py``).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import AudioError, ErrorCode
from ..utils.cache import BoundedCache, on_device
from ._mm import check_precision, mm
from .framing import overlap_add
from .windows import get_window

#: C1 in the A440 12-TET tuning — the conventional CQT floor.
FMIN_C1 = 32.70319566257483

# per-config analysis banks, ~F0*2*n_bins*4 B each (~6 MB at 84 bins/16 kHz)
_KERNEL_CACHE = BoundedCache(maxsize=16)
# arrays derived from a design array (conv weights, padded banks), keyed by
# the source array's identity, which each entry pins while it lives
_DERIVED = BoundedCache(maxsize=64)


def _derived(src: np.ndarray, tag, build) -> np.ndarray:
    """``build()``, computed once per design array ``src`` and ``tag``."""
    key = (id(src), tag)
    hit = _DERIVED.get(key)
    if hit is None or hit[0] is not src:
        hit = (src, build())
        _DERIVED[key] = hit
    return hit[1]


def _block_weight(bank: np.ndarray, hop: int) -> np.ndarray:
    """``bank [flen, C]`` as the conv1d weight ``[C, hop, flen // hop]`` of
    the hop-block correlation: ``w[c, r, q] = bank[q * hop + r, c]``."""
    tb = bank.shape[0] // hop
    return np.ascontiguousarray(bank.reshape(tb, hop, bank.shape[1]).transpose(2, 1, 0))


def _framed_dot(
    x: torch.Tensor, bank: np.ndarray, hop: int, n_frames: int, form: str = "conv"
) -> torch.Tensor:
    """``frame(x, flen, hop)[..., :n_frames, :] @ bank`` for a design bank
    ``[flen, C]`` whose ``flen`` is a multiple of ``hop``: ``[..., n_frames, C]``.

    ``form="conv"`` computes it as a correlation over the hop blocks of
    ``x`` (``conv1d`` with ``hop`` input channels and ``flen // hop`` taps):
    no frame tensor exists. ``form="unfold"`` is the matmul on the framed
    view, which copies the frames; it is kept to be measured beside it.
    """
    flen, c = bank.shape
    lead = x.shape[:-1]
    if form == "unfold":
        fr = x[..., : (n_frames - 1) * hop + flen].unfold(-1, flen, hop)
        return torch.matmul(fr, on_device(bank, x.device))
    if form != "conv":
        raise ValueError(f"unknown product form {form!r}; known: conv, unfold")
    n_blocks = n_frames + flen // hop - 1
    xb = x[..., : n_blocks * hop].reshape(-1, n_blocks, hop).transpose(1, 2)  # [B, hop, blocks]
    w = on_device(_derived(bank, ("block", hop), lambda: _block_weight(bank, hop)), x.device)
    y = F.conv1d(xb, w)  # [B, C, n_frames]
    return y.transpose(1, 2).reshape(*lead, n_frames, c)


def _feature_conv(ri: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    """Overlap-add synthesis of ``ri [..., T, F]`` through the JAX package's
    hop-block kernel ``kern [hop, F, Tb]`` (already reversed): a
    cross-correlation with ``Tb - 1`` zeros each side, returned in OLA
    coordinates ``[..., (T + Tb - 1) * hop]``."""
    lead, t, f = ri.shape[:-2], ri.shape[-2], ri.shape[-1]
    tb = kern.shape[2]
    lhs = ri.reshape(-1, t, f).transpose(1, 2)  # [B, F, T]
    y_blk = F.conv1d(lhs, on_device(kern, ri.device), padding=tb - 1)  # [B, hop, T + Tb - 1]
    return y_blk.transpose(1, 2).reshape(*lead, -1)


def _re_im(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if c.is_complex():
        return c.real, c.imag
    return c, torch.zeros_like(c)


def _finish(re: torch.Tensor, im: torch.Tensor, output: str) -> torch.Tensor:
    if output == "complex":
        return torch.complex(re, im)
    p = re * re + im * im
    return torch.sqrt(p) if output == "magnitude" else p


def cqt_frequencies(
    n_bins: int = 84, fmin: float = FMIN_C1, bins_per_octave: int = 12
) -> np.ndarray:
    """Bin center frequencies [n_bins], geometrically spaced (host, f64)."""
    return fmin * 2.0 ** (np.arange(n_bins, dtype=np.float64) / bins_per_octave)


def cqt_lengths(
    sample_rate: float,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
) -> np.ndarray:
    """Kernel length in samples per bin (odd-forced; host, int).

    ``N_k = ceil(Q * sr / f_k)`` with ``Q = filter_scale / (2^(1/B) - 1)``.
    """
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    n = np.ceil(q * sample_rate / freqs).astype(np.int64)
    return n + (1 - n % 2)


def _design(
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
):
    """Host-side kernel design. Returns (f0, groups, onedot_bank); each group
    is (frame_len, cos_bank [frame_len, nb], sin_bank) for one octave, frame
    lengths hop multiples, kernel k centered at row ``frame_len // 2``; the
    onedot bank ``[F0, 2*n_bins]`` holds every octave zero-padded to F0."""
    key = (sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale)
    if key in _KERNEL_CACHE:
        return _KERNEL_CACHE[key]
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    if freqs[-1] > sample_rate / 2:
        raise ValueError(
            f"top CQT bin {freqs[-1]:.1f} Hz exceeds Nyquist "
            f"{sample_rate / 2:.1f} Hz; reduce n_bins or raise fmin"
        )
    lengths = cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)
    groups = []
    for lo in range(0, n_bins, bins_per_octave):
        hi = min(lo + bins_per_octave, n_bins)
        n_max = int(lengths[lo:hi].max())
        flen = hop * -(-(n_max + 1) // hop)  # kernel fits centered at flen//2
        cos_b = np.zeros((flen, hi - lo), np.float64)
        sin_b = np.zeros((flen, hi - lo), np.float64)
        for j, k in enumerate(range(lo, hi)):
            nk = int(lengths[k])
            w = get_window(window, nk, periodic=False).astype(np.float64)
            t = (np.arange(nk, dtype=np.float64) - (nk - 1) / 2.0) / sample_rate
            ang = 2.0 * np.pi * freqs[k] * t
            g = 2.0 / w.sum()
            start = flen // 2 - (nk - 1) // 2
            cos_b[start : start + nk, j] = g * w * np.cos(ang)
            sin_b[start : start + nk, j] = -g * w * np.sin(ang)
        groups.append((flen, cos_b.astype(np.float32), sin_b.astype(np.float32)))
    f0 = groups[0][0]
    cos_full, sin_full = [], []
    for flen, cb, sb in groups:
        pr = f0 // 2 - flen // 2
        cos_full.append(np.pad(cb, ((pr, f0 - flen - pr), (0, 0))))
        sin_full.append(np.pad(sb, ((pr, f0 - flen - pr), (0, 0))))
    onedot_bank = np.concatenate(cos_full + sin_full, axis=1)
    _KERNEL_CACHE[key] = (f0, groups, onedot_bank)
    return _KERNEL_CACHE[key]


def cqt_window_length(
    sample_rate: float,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
) -> int:
    """The analysis frame span F0 (lowest octave's frame length, a hop
    multiple) — the streaming carry is ``F0 - hop``."""
    n_max = int(
        cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)[0]
    )
    return hop * -(-(n_max + 1) // hop)


def cqt(
    x: torch.Tensor,
    sample_rate: float,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    window: str = "hann",
    filter_scale: float = 1.0,
    center: bool = True,
    output: str = "magnitude",
    impl: str = "onedot",
    precision: str | None = None,
    multirate: bool = False,
):
    """Constant-Q spectrogram ``[..., n_frames, n_bins]`` of ``x [..., T]``.

    ``output``: "magnitude" | "power" | "complex" (complex64).
    ``impl``: "onedot" (one concatenated bank), "split" (per-octave frame
    lengths) or "direct" (per-octave banks at the full frame length) — the
    same result up to fp32 summation order; each is one hop-block
    correlation per bank (:func:`_framed_dot`).
    ``multirate=True`` returns the invertible per-octave-hop variant, a
    :class:`MultirateCqt` (:func:`cqt_multirate`; center=True only), with
    magnitude output unless ``output`` says otherwise, as in the JAX package.
    """
    if multirate:
        if not center:
            raise ValueError("cqt(multirate=True) supports center=True only")
        if impl != "onedot":
            raise ValueError(
                "cqt(multirate=True) has its own per-octave implementation; "
                f"impl={impl!r} does not apply"
            )
        return cqt_multirate(
            x, sample_rate, hop, n_bins, fmin, bins_per_octave, window,
            filter_scale, output, precision,
        )
    if output not in ("magnitude", "power", "complex"):
        raise ValueError(
            f"unknown cqt output {output!r}; known: magnitude, power, complex"
        )
    if impl not in ("onedot", "split", "direct"):
        raise ValueError(f"unknown cqt impl {impl!r}; known: onedot, split, direct")
    check_precision(precision)
    f0, groups, onedot_bank = _design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    if center:
        half = f0 // 2
        x = F.pad(x, (half, f0 - half))
    n_frames = (x.shape[-1] - f0) // hop + 1
    if n_frames < 1:
        raise ValueError(
            f"signal too short for CQT: {x.shape[-1]} samples < frame span {f0}"
        )
    if impl == "onedot":
        y = _framed_dot(x, onedot_bank, hop, n_frames)
        re, im = y[..., :n_bins], y[..., n_bins:]
    else:
        res, ims = [], []
        for flen, cos_b, sin_b in groups:
            if impl == "direct":
                pad_rows = f0 // 2 - flen // 2

                def build(cos_b=cos_b, sin_b=sin_b, pad_rows=pad_rows, flen=flen):
                    rows = ((pad_rows, f0 - flen - pad_rows), (0, 0))
                    return np.concatenate([np.pad(cos_b, rows), np.pad(sin_b, rows)], axis=1)

                bank, off = _derived(cos_b, "direct", build), 0
            else:
                bank = _derived(cos_b, "split", lambda cos_b=cos_b, sin_b=sin_b: np.concatenate([cos_b, sin_b], 1))
                off = f0 // 2 - flen // 2  # same center sample t*hop + f0//2
            y = _framed_dot(x[..., off:], bank, hop, n_frames)
            nb = cos_b.shape[1]
            res.append(y[..., :nb])
            ims.append(y[..., nb:])
        re = torch.cat(res, dim=-1)
        im = torch.cat(ims, dim=-1)
    return _finish(re, im, output)


# per-config synthesis banks, ~2*n_bins*nd*4 B each (~11 MB at 84 bins/16 kHz)
_DUAL_CACHE = BoundedCache(maxsize=8)


def icqt_max_hop(
    sample_rate: float,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
) -> int:
    """Largest analysis hop at which the painless :func:`icqt` holds: about
    a third of the shortest kernel."""
    n_min = int(
        cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)[-1]
    )
    return max(1, n_min // 3)


def _dual_design(
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
    nd_mult: int = 2,
    eps: float = 1e-2,
    mask_db: float = 40.0,
):
    """Host-side painless dual bank, float64 -> f32: the canonical diagonal
    dual ``psi_hat_k / W`` with each dual band-masked ``mask_db`` below its
    peak and ``W`` floored at ``eps * max(W)``, on an ``nd = nd_mult * F0``
    grid. Returns ``(nd, bank [2*n_bins, nd])``; a synthesis frame is
    ``[Re X | Im X] @ bank``."""
    key = (
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale,
        nd_mult, eps, mask_db,
    )
    if key in _DUAL_CACHE:
        return _DUAL_CACHE[key]
    f0, _groups, onedot = _design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    psi = (
        onedot[:, :n_bins].T.astype(np.float64)
        - 1j * onedot[:, n_bins:].T.astype(np.float64)
    )
    nd = f0 * nd_mult
    psi_p = np.zeros((n_bins, nd), complex)
    off = nd // 2 - f0 // 2
    psi_p[:, off : off + f0] = psi
    ph = np.fft.fft(psi_p, axis=1)
    w_pos = (np.abs(ph) ** 2).sum(0)
    w_neg = np.empty_like(w_pos)
    w_neg[0] = w_pos[0]
    w_neg[1:] = w_pos[1:][::-1]
    w_tot = (w_pos + w_neg) / hop
    amp = np.abs(ph)
    mask = amp >= amp.max(axis=1, keepdims=True) * 10.0 ** (-mask_db / 20.0)
    d_hat = ph * mask / np.maximum(w_tot, eps * w_tot.max())[None, :]
    d = np.fft.ifft(d_hat, axis=1)
    bank = np.concatenate(
        [2.0 * d.real, -2.0 * d.imag], axis=0
    ).astype(np.float32)  # [2*n_bins, nd]
    _DUAL_CACHE[key] = (nd, bank)
    return _DUAL_CACHE[key]


def icqt(
    c,
    sample_rate: float | None = None,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    window: str = "hann",
    filter_scale: float = 1.0,
    center: bool = True,
    length: int | None = None,
    precision: str | None = None,
    method: str = "auto",
) -> torch.Tensor:
    """Inverse CQT: complex coefficients (``cqt(..., output="complex")`` at
    the SAME parameters, or a :class:`MultirateCqt`) back to ``[..., T]``.

    A :class:`MultirateCqt` dispatches to :func:`icqt_multirate`, the
    broadband inverse. Fixed-hop ``[..., n_frames, n_bins]`` coefficients
    take ``"painless"`` (``hop <= icqt_max_hop``: the diagonal dual bank and
    an overlap-add) or ``"hybrid"`` (coarser hops: least-squares duals for
    the covered low bins plus a sinusoidal model above the painless cliff,
    which reconstructs peaky, tonal content only — the JAX package's
    ``icqt`` docstring has its measured envelope); ``"auto"`` picks by hop.
    ``length`` defaults to ``(n_frames - 1) * hop``.
    """
    if isinstance(c, MultirateCqt):
        if sample_rate is not None and sample_rate != c.meta.sample_rate:
            raise ValueError(
                f"icqt sample_rate {sample_rate} != the MultirateCqt's "
                f"{c.meta.sample_rate} (the coefficients carry their own "
                "analysis parameters; pass none)"
            )
        # only non-default conflicts are catchable; filter_scale is not
        # checked, as in the JAX package
        mism = [
            (name, got, want)
            for name, got, want, dflt in (
                ("hop", hop, c.meta.hop, 256),
                ("n_bins", n_bins, c.meta.n_bins, 84),
                ("fmin", fmin, c.meta.fmin, FMIN_C1),
                ("bins_per_octave", bins_per_octave, c.meta.bins_per_octave, 12),
                ("window", window, c.meta.window, "hann"),
            )
            if got != want and got != dflt
        ]
        if mism:
            raise ValueError(
                "icqt arguments conflict with the MultirateCqt's analysis "
                f"parameters: {mism} (pass none — the pytree carries them)"
            )
        if method not in ("auto",):
            raise ValueError(
                f"icqt method={method!r} does not apply to MultirateCqt input"
            )
        return icqt_multirate(c, length=length, precision=precision)
    if sample_rate is None:
        raise ValueError(
            "icqt needs sample_rate for fixed-hop coefficients (it is only "
            "optional for MultirateCqt input)"
        )
    if method not in ("auto", "painless", "hybrid"):
        raise ValueError(
            f"unknown icqt method {method!r}; known: auto, painless, hybrid"
        )
    max_hop = icqt_max_hop(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)
    if method == "auto":
        method = "painless" if hop <= max_hop else "hybrid"
    if method == "hybrid":
        return _icqt_hybrid(
            c, sample_rate, hop, n_bins, fmin, bins_per_octave, window,
            filter_scale, center, length, precision,
        )
    if hop > max_hop:
        warnings.warn(
            f"icqt method='painless' at hop={hop} exceeds icqt_max_hop="
            f"{max_hop}"
            " — top-octave content is not recoverable at this frame spacing "
            "(see icqt_max_hop); expect degraded reconstruction "
            "(method='hybrid' handles coarse hops)",
            stacklevel=2,
        )
    nd, bank = _dual_design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    f0 = cqt_window_length(
        sample_rate, hop, n_bins, fmin, bins_per_octave, filter_scale
    )
    if c.shape[-1] != n_bins:
        raise ValueError(f"expected [..., frames, {n_bins}] coefficients, got {tuple(c.shape)}")
    n_frames = c.shape[-2]
    if length is None:
        length = (n_frames - 1) * hop
    re, im = _re_im(c)
    ri = torch.cat([re, im], dim=-1)  # [..., T_f, 2K]
    frames = mm(ri, on_device(bank, ri.device), precision)  # [..., T_f, nd]
    y = overlap_add(frames, hop)
    # frame t's dual is centered at t*hop (center=True) or t*hop + f0//2
    start = nd // 2 - (0 if center else f0 // 2)
    if start < 0:
        y, start = F.pad(y, (-start, 0)), 0
    need = start + length
    if y.shape[-1] < need:
        y = F.pad(y, (0, need - y.shape[-1]))
    return y[..., start:need]


# hybrid designs are large (~12 MB dual bank at 84 bins / 16 kHz)
_HYBRID_CACHE = BoundedCache(maxsize=4)


def _window_cos_coeffs(window: str, n_terms: int = 6) -> np.ndarray:
    """Cosine-sum coefficients ``a_j`` of the analysis window, fit by least
    squares on a long instance: the hybrid inverse evaluates the window
    spectrum in closed form from them. Raises for windows that are not
    cosine sums (residual > 1e-5)."""
    n_w = 4096
    w = get_window(window, n_w, periodic=False).astype(np.float64)
    n = np.arange(n_w, dtype=np.float64) - (n_w - 1) / 2.0
    basis = np.cos(2.0 * np.pi * np.arange(n_terms)[:, None] * n / (n_w - 1))
    a, *_ = np.linalg.lstsq(basis.T, w, rcond=None)
    resid = np.abs(basis.T @ a - w).max()
    if resid > 1e-5:
        raise ValueError(
            f"icqt hybrid needs a cosine-sum analysis window; {window!r} "
            f"fit residual {resid:.2e} (use hann/hamming/blackman)"
        )
    return a


def _hybrid_design(
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
    nd_mult: int = 4,
    lam_rel: float = 1e-3,
):
    """Host-side design for the hybrid (coarse-hop) inverse CQT: per-coset
    Tikhonov least-squares duals for bins up to ``k_last + 5`` (``k_last``
    the last bin with ``N_k >= 3*hop``), tapered to zero over
    ``[freqs[k_last-1], freqs[k_last+2]]``, shipped as the hop-block conv
    kernel ``kern [hop, 2K, Tb]``; plus the sinusoidal branch's constants.
    Returns a dict of f32 arrays and static ints."""
    key = (
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale,
        nd_mult, lam_rel,
    )
    if key in _HYBRID_CACHE:
        return _HYBRID_CACHE[key]
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    lengths = cqt_lengths(
        sample_rate, n_bins, fmin, bins_per_octave, filter_scale
    ).astype(np.float64)
    painless = lengths >= 3 * hop
    if not painless[:3].all():
        raise ValueError(
            f"icqt hybrid needs the lowest 3 CQT bins painless at hop={hop} "
            f"(kernel lengths {lengths[:3].astype(int).tolist()} < 3*hop); "
            "reduce hop or raise fmin"
        )
    k_last = int(np.nonzero(painless)[0].max())
    k_dual = min(k_last + 5, n_bins)
    f_lo = freqs[max(k_last - 1, 0)]
    f_hi = freqs[min(k_last + 2, n_bins - 1)]
    f0, _groups, onedot = _design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    psi = (
        onedot[:, :k_dual].T.astype(np.float64)
        - 1j * onedot[:, n_bins : n_bins + k_dual].T.astype(np.float64)
    )
    nd = f0 * nd_mult
    t_cosets = nd // hop
    psi_p = np.zeros((k_dual, nd), complex)
    off = nd // 2 - f0 // 2
    psi_p[:, off : off + f0] = psi
    ph = np.fft.fft(psi_p, axis=1)
    d_hat = np.zeros((k_dual, nd), complex)
    e_hat = np.zeros((k_dual, nd), complex)
    scale = t_cosets / nd
    lam = lam_rel * (np.abs(ph).max() * scale) ** 2
    for mu in range(t_cosets):
        w_idx = (mu + t_cosets * np.arange(hop)) % nd
        a1 = np.conj(ph[:, w_idx])
        a2 = ph[:, (nd - w_idx) % nd]  # conj-coefficient rows
        a = scale * np.concatenate([a1, a2], axis=0)  # [2K, hop]
        g = a @ a.conj().T
        g.flat[:: g.shape[0] + 1] += lam
        b = np.linalg.solve(g, a).conj().T  # min-norm LS: A^H (AA^H+lam)^-1
        d_hat[:, w_idx] += b[:, :k_dual].T
        e_hat[:, w_idx] += b[:, k_dual:].T
    refl = np.conj(e_hat[:, (nd - np.arange(nd)) % nd])
    d_sym = 0.5 * (d_hat + refl)
    fgrid = np.abs(np.fft.fftfreq(nd, d=1.0 / sample_rate))
    t = np.clip(
        (np.log(np.maximum(fgrid, 1e-9)) - np.log(f_lo))
        / (np.log(f_hi) - np.log(f_lo)),
        0.0,
        1.0,
    )
    d_sym *= (0.5 * (1.0 + np.cos(np.pi * t)))[None, :]
    d = np.fft.ifft(d_sym, axis=1)
    bank = np.concatenate([2.0 * d.real, -2.0 * d.imag], axis=0)  # [2K, nd]
    # conv kernel: out hop-block s, in-feature f, spatial tap j (reversed):
    # rhs[r, f, j] = bank[f, (Tb-1-j)*hop + r]
    kern = bank.reshape(2 * k_dual, t_cosets, hop)[:, ::-1, :]
    kern = np.ascontiguousarray(np.transpose(kern, (2, 0, 1)))  # [hop, 2K, Tb]
    wcos = _window_cos_coeffs(window)
    n_cand = max(
        4, int(np.ceil(freqs[-1] * (2.0 ** (1.0 / (2 * bins_per_octave)) - 1.0)
                       / (sample_rate / hop))) + 1
    )
    out = dict(
        nd=nd,
        f0=f0,
        k_dual=k_dual,
        k_min=max(k_last - 2, 0),
        n_cand=n_cand,
        f_lo=float(f_lo),
        f_hi=float(f_hi),
        kern=kern.astype(np.float32),
        freqs=freqs.astype(np.float32),
        lengths=lengths.astype(np.float32),
        wcos=wcos.astype(np.float32),
    )
    _HYBRID_CACHE[key] = out
    return out


def _sin_estimates(
    re: torch.Tensor,
    im: torch.Tensor,
    dz: dict,
    sample_rate: float,
    hop: int,
    score_gate: float = 0.5,
    mag_floor: float = 1e-3,
) -> dict:
    """The hybrid inverse's sinusoid estimates per frame and bin: local
    magnitude peaks, the frequency from the one-hop phase advance with its
    harmonic number picked by candidate scoring against the window
    spectrum, the calibrated amplitude, and the crossfade weight ``wgt``
    (0 where a bin is not synthesized). Returns every intermediate that a
    discrete decision reads (``mag``, ``gmax``, ``score``, ``s_best``,
    ``is_peak``) beside ``wgt``, ``f_hat`` and ``phase0``."""
    n_frames, n_bins = re.shape[-2], re.shape[-1]
    dev = re.device
    mag = torch.sqrt(re * re + im * im)
    gmax = mag.amax(dim=(-2, -1), keepdim=True)
    neg = mag.new_full((*mag.shape[:-1], 1), -1.0)
    padm = torch.cat([neg, mag, neg], dim=-1)
    is_peak = (
        (mag > padm[..., :-2])
        & (mag >= padm[..., 2:])
        & (mag > mag_floor * gmax)
        & (torch.arange(n_bins, device=dev) >= dz["k_min"])
    )
    lm = torch.log(torch.clamp_min(mag, 1e-12))
    # one-hop phase advance in cycles/frame (real arithmetic; c_t conj(c_t-1))
    if n_frames > 1:
        pr = re[..., 1:, :] * re[..., :-1, :] + im[..., 1:, :] * im[..., :-1, :]
        pi = im[..., 1:, :] * re[..., :-1, :] - re[..., 1:, :] * im[..., :-1, :]
        dphi = torch.atan2(pi, pr) / (2.0 * np.pi)
        dphi = torch.cat([dphi, dphi[..., -1:, :]], dim=-2)
    else:
        dphi = torch.zeros_like(mag)
    freqs = on_device(dz["freqs"], dev)
    lens = on_device(dz["lengths"], dev)
    wcos = dz["wcos"]

    def h_of(u):
        acc = 0.0
        for j, aj in enumerate(wcos):
            acc = acc + (float(aj) / (2.0 * float(wcos[0]))) * (torch.sinc(u - j) + torch.sinc(u + j))
        return torch.clamp_min(torch.abs(acc), 1e-7)

    fr_rate = sample_rate / hop
    m0 = torch.round(freqs / fr_rate - dphi)
    offs = torch.arange(-dz["n_cand"], dz["n_cand"] + 1, dtype=torch.float32, device=dev)
    f_cand = (m0[..., None] + offs + dphi[..., None]) * fr_rate  # [.., T, K, C]

    def neighbours():
        ks = np.arange(n_bins)
        return (ks, np.maximum(ks - 1, 0), np.minimum(ks + 1, n_bins - 1),
                (ks > 0)[:, None].astype(np.float32), (ks < n_bins - 1)[:, None].astype(np.float32))

    # index tables uploaded once per device (an upload from pageable memory
    # would make the host wait for the card on every call)
    ks, k_lo, k_up, has_lo, has_up = (
        on_device(a, dev, torch.int64 if a.dtype == np.int64 else torch.float32)
        for a in _derived(dz["freqs"], "neighbours", neighbours)
    )

    def l_h(idx):
        u = (f_cand - freqs[idx][:, None]) * lens[idx][:, None] / sample_rate
        return torch.log(h_of(u))

    l_self = l_h(ks)
    r_pred_lo = l_self - l_h(k_lo)
    r_pred_up = l_self - l_h(k_up)
    r_obs_lo = (lm - lm[..., k_lo])[..., None]
    r_obs_up = (lm - lm[..., k_up])[..., None]
    score = has_lo * (r_pred_lo - r_obs_lo) ** 2 + has_up * (r_pred_up - r_obs_up) ** 2
    s_best, best = score.min(dim=-1)  # the first minimum, as the JAX one-hot
    f_hat = torch.gather(f_cand, -1, best[..., None])[..., 0]
    f_hat = torch.clamp(f_hat, 1.0, sample_rate / 2 - 1.0)
    u_best = (f_hat - freqs) * lens / sample_rate
    amp = mag / torch.clamp_min(h_of(u_best), 0.1)
    lf_lo, lf_hi = np.log(dz["f_lo"]), np.log(dz["f_hi"])
    tt = torch.clamp((torch.log(f_hat) - lf_lo) / (lf_hi - lf_lo), 0.0, 1.0)
    rho = 0.5 * (1.0 + torch.cos(np.pi * tt))
    wgt = (1.0 - rho) * (s_best < score_gate) * is_peak * amp
    return dict(
        mag=mag, gmax=gmax, is_peak=is_peak, score=score, s_best=s_best,
        f_hat=f_hat, wgt=wgt, phase0=torch.atan2(im, re),
    )


def _icqt_hybrid(
    c: torch.Tensor,
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
    center: bool,
    length: int | None,
    precision: str | None,
    score_gate: float = 0.5,
    mag_floor: float = 1e-3,
    max_components: int = 16,
) -> torch.Tensor:
    """Hybrid inverse CQT for coarse hops (see :func:`_hybrid_design`): the
    dual branch is a ``Tb = nd/hop``-tap feature conv over the coefficient
    sequence; the sinusoidal branch synthesizes the ``max_components``
    largest estimates of each frame (:func:`_sin_estimates`) as hann bursts
    of ``2*hop`` overlap-added at 50%, one component at a time."""
    if c.shape[-1] != n_bins:
        raise ValueError(
            f"expected [..., frames, {n_bins}] coefficients, got {tuple(c.shape)}"
        )
    check_precision(precision)
    dz = _hybrid_design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    nd, f0, k_dual = dz["nd"], dz["f0"], dz["k_dual"]
    n_frames = c.shape[-2]
    if length is None:
        length = (n_frames - 1) * hop
    re, im = (t.to(torch.float32) for t in _re_im(c))
    lead = re.shape[:-2]
    # ---- dual branch: Tb-tap conv over the coefficient sequence
    ri = torch.cat([re[..., :k_dual], im[..., :k_dual]], dim=-1)
    y = _feature_conv(ri, dz["kern"])  # OLA coords, len (T-1)h + nd
    # ---- sin branch: the top-P weights of each frame (exact whenever at
    # most P components have wgt > 0, every tonal case)
    est = _sin_estimates(re, im, dz, sample_rate, hop, score_gate, mag_floor)
    p_sel = min(int(max_components), n_bins)
    wgt_p, idx = torch.topk(est["wgt"], p_sel, dim=-1)  # descending, as the JAX first-max passes
    f_p = torch.gather(est["f_hat"], -1, idx)
    ph0_p = torch.gather(est["phase0"], -1, idx)
    n_rel = torch.arange(2 * hop, dtype=torch.float32, device=re.device) - hop
    win = 0.5 - 0.5 * torch.cos(2.0 * np.pi * torch.arange(2 * hop, device=re.device) / (2 * hop))
    burst = None
    for p in range(p_sel):  # the [.., T, P, 2h] phase tensor is never built
        phase = (2.0 * np.pi / sample_rate) * f_p[..., p, None] * n_rel + ph0_p[..., p, None]
        term = wgt_p[..., p, None] * torch.cos(phase)
        burst = term if burst is None else burst + term
    burst = burst * win  # [.., T, 2h]
    # 50% OLA: true-coords block s = burst[s][h:] + burst[s+1][:h]
    half1, half2 = burst[..., :hop], burst[..., hop:]
    half1_next = torch.cat([half1[..., 1:, :], torch.zeros_like(half1[..., :1, :])], dim=-2)
    y_sin = (half2 + half1_next).reshape(*lead, n_frames * hop)
    # sin true coords start at 0 == OLA coord nd//2 (a hop multiple)
    y = torch.cat(
        [y[..., : nd // 2], y[..., nd // 2 : nd // 2 + n_frames * hop] + y_sin, y[..., nd // 2 + n_frames * hop :]],
        dim=-1,
    )
    start = nd // 2 - (0 if center else f0 // 2)
    need = start + length
    if y.shape[-1] < need:
        y = F.pad(y, (0, need - y.shape[-1]))
    return y[..., start:need]


# multirate designs: per-octave analysis + truncated dual banks (~8 MB at
# 84 bins / 16 kHz)
_MULTIRATE_CACHE = BoundedCache(maxsize=4)


def multirate_hops(
    sample_rate: float,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
    top_divisor: int = 6,
) -> tuple[int, ...]:
    """Per-octave analysis hops of the multirate CQT: each octave's hop is
    the largest power-of-two division of ``hop`` inside that octave's
    painless bound ``N_min_o // 3``, the top octave's ``N_min // 6``. At the
    framework default (hop 256 / 84 bins / 16 kHz) the hops are
    ``(256, 256, 256, 128, 64, 32, 8)``."""
    lengths = cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)
    n_oct = -(-n_bins // bins_per_octave)
    hops = []
    for o, lo in enumerate(range(0, n_bins, bins_per_octave)):
        hi = min(lo + bins_per_octave, n_bins)
        div = top_divisor if o == n_oct - 1 else 3
        bound = max(1, int(lengths[lo:hi].min()) // div)
        h = hop
        while h > bound:
            if h % 2:
                raise AudioError(
                    f"multirate CQT needs hop={hop} halvable down to the "
                    f"octave painless bound {bound} (odd factor hit at {h}); "
                    "use a power-of-two hop",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            h //= 2
        hops.append(h)
    return tuple(hops)


def _multirate_design(
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
    eps: float = 1e-2,
    mask_db: float = 40.0,
):
    """Host-side design of the multirate CQT and its inverse (float64->f32):
    per octave o a forward bank ``[flen_o, 2*nb_o]`` framed at the octave's
    own hop, and one joint painless diagonal dual with per-bin hop weighting
    (the floor referenced to the N/3 hops), each octave's dual truncated to
    a centered span ``min(nd, max(4*flen_o, 32*h_o))`` with a raised-cosine
    edge taper and shipped as a hop-block conv kernel ``[h, 2nb, Tb]``.

    Returns a dict: ``octs`` = [(h, flen, fwd_bank [flen, 2nb])], ``nd``,
    ``duals`` = [(lo0, bank [2nb, span], kern)], ``hops``.
    """
    key = (
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale,
        eps, mask_db,
    )
    if key in _MULTIRATE_CACHE:
        return _MULTIRATE_CACHE[key]
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    if freqs[-1] > sample_rate / 2:
        raise ValueError(
            f"top CQT bin {freqs[-1]:.1f} Hz exceeds Nyquist "
            f"{sample_rate / 2:.1f} Hz; reduce n_bins or raise fmin"
        )
    lengths = cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)
    hops = multirate_hops(
        sample_rate, hop, n_bins, fmin, bins_per_octave, filter_scale
    )
    octs = []  # (h, flen, cos [flen, nb], sin [flen, nb]) in float64
    for o, lo in enumerate(range(0, n_bins, bins_per_octave)):
        hi = min(lo + bins_per_octave, n_bins)
        h = hops[o]
        n_max = int(lengths[lo:hi].max())
        flen = h * -(-(n_max + 1) // h)
        cos_b = np.zeros((flen, hi - lo))
        sin_b = np.zeros((flen, hi - lo))
        for j, k in enumerate(range(lo, hi)):
            nk = int(lengths[k])
            w = get_window(window, nk, periodic=False).astype(np.float64)
            t = (np.arange(nk, dtype=np.float64) - (nk - 1) / 2.0) / sample_rate
            ang = 2.0 * np.pi * freqs[k] * t
            g = 2.0 / w.sum()
            start = flen // 2 - (nk - 1) // 2
            cos_b[start : start + nk, j] = g * w * np.cos(ang)
            sin_b[start : start + nk, j] = -g * w * np.sin(ang)
        octs.append((h, flen, cos_b, sin_b))
    nd = octs[0][1] * 2
    ref_hops = multirate_hops(
        sample_rate, hop, n_bins, fmin, bins_per_octave, filter_scale,
        top_divisor=3,
    )
    w_pos = np.zeros(nd)
    w_ref = np.zeros(nd)
    phs = []
    for (h, flen, cos_b, sin_b), h_ref in zip(octs, ref_hops):
        psi = cos_b.T - 1j * sin_b.T  # [nb, flen]; psi = g w exp(i ang)
        psi_p = np.zeros((psi.shape[0], nd), complex)
        off = nd // 2 - flen // 2
        psi_p[:, off : off + flen] = psi
        ph = np.fft.fft(psi_p, axis=1)
        phs.append(ph)
        e2 = (np.abs(ph) ** 2).sum(0)
        w_pos += e2 / h
        w_ref += e2 / h_ref
    w_neg = np.empty_like(w_pos)
    w_neg[0] = w_pos[0]
    w_neg[1:] = w_pos[1:][::-1]
    w_tot = w_pos + w_neg
    w_ref_tot = w_ref.copy()
    w_ref_tot[1:] += w_ref[1:][::-1]
    w_ref_tot[0] += w_ref[0]
    floor = eps * w_ref_tot.max()
    duals = []
    for (h, flen, _cb, _sb), ph in zip(octs, phs):
        amp = np.abs(ph)
        mask = amp >= amp.max(axis=1, keepdims=True) * 10.0 ** (-mask_db / 20.0)
        d_hat = ph * mask / np.maximum(w_tot, floor)[None, :]
        d = np.fft.ifft(d_hat, axis=1)
        bank = np.concatenate([2.0 * d.real, -2.0 * d.imag], axis=0)  # [2nb, nd]
        span = min(nd, max(4 * flen, 32 * h))
        span = h * -(-span // h)
        lo0 = nd // 2 - span // 2
        sub = bank[:, lo0 : lo0 + span]
        if span < nd:  # raised-cosine edge taper over the outer half
            t = np.abs(np.arange(span) - (span - 1) / 2.0)
            u = np.clip((t - span / 4.0) / (span / 4.0), 0.0, 1.0)
            sub = sub * (0.5 * (1.0 + np.cos(np.pi * u)))[None, :]
        tb = span // h
        nb2 = sub.shape[0]
        kern = sub.reshape(nb2, tb, h)[:, ::-1, :]
        kern = np.ascontiguousarray(np.transpose(kern, (2, 0, 1)))  # [h, 2nb, Tb]
        duals.append((lo0, sub.astype(np.float32), kern.astype(np.float32)))
    fwd = [
        (h, flen, np.concatenate([cb, sb], axis=1).astype(np.float32))
        for h, flen, cb, sb in octs
    ]
    out = dict(octs=fwd, nd=nd, duals=duals, hops=hops)
    _MULTIRATE_CACHE[key] = out
    return out


class _MrMeta:
    """Hashable static metadata of a :class:`MultirateCqt`."""

    __slots__ = ("sample_rate", "hop", "n_bins", "fmin", "bins_per_octave",
                 "window", "filter_scale", "hops", "length")

    def __init__(self, sample_rate, hop, n_bins, fmin, bins_per_octave,
                 window, filter_scale, hops, length):
        self.sample_rate = sample_rate
        self.hop = hop
        self.n_bins = n_bins
        self.fmin = fmin
        self.bins_per_octave = bins_per_octave
        self.window = window
        self.filter_scale = filter_scale
        self.hops = tuple(hops)
        self.length = length  # the forward's input sample count

    def _key(self):
        return (self.sample_rate, self.hop, self.n_bins, self.fmin,
                self.bins_per_octave, self.window, self.filter_scale,
                self.hops, self.length)

    def __eq__(self, other):
        return isinstance(other, _MrMeta) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"_MrMeta{self._key()!r}"


class MultirateCqt:
    """Multirate CQT coefficients: one tensor per octave, each at its own
    analysis hop (``meta.hops``) — octave o is ``[..., T_o, nb_o]`` with
    ``T_o = T // hops[o] + 1`` frames centered at ``t * hops[o]``.
    ``type(c)(octaves, meta)`` rebuilds one; ``to_grid()`` resamples onto
    the common-hop frame grid; :func:`icqt` / :func:`icqt_multirate` invert
    it."""

    __slots__ = ("octaves", "meta")

    def __init__(self, octaves, meta: _MrMeta):
        self.octaves = tuple(octaves)
        self.meta = meta

    @property
    def hops(self) -> tuple[int, ...]:
        return self.meta.hops

    def to_grid(self) -> torch.Tensor:
        """Fold onto the common ``meta.hop`` grid: every ``hop // hops[o]``-th
        frame of each octave (the grids nest), bins concatenated ->
        ``[..., n_frames, n_bins]``, frame t centered at ``t * hop`` like
        :func:`cqt`. Exact for analysis at the common frame rate."""
        hop = self.meta.hop
        strides = [hop // h for h in self.meta.hops]
        n = min((c.shape[-2] - 1) // s + 1 for c, s in zip(self.octaves, strides))
        parts = [c[..., ::s, :][..., :n, :] for c, s in zip(self.octaves, strides)]
        return torch.cat(parts, dim=-1)


def cqt_multirate(
    x: torch.Tensor,
    sample_rate: float,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    window: str = "hann",
    filter_scale: float = 1.0,
    output: str = "complex",
    precision: str | None = None,
) -> MultirateCqt:
    """Invertible multirate CQT: every octave analyzed at its own hop inside
    its painless bound (:func:`multirate_hops`), with the kernels,
    normalization and center geometry of :func:`cqt` (center=True).
    ``output`` "complex" (default, required for inversion) | "magnitude" |
    "power" applies per octave."""
    if output not in ("magnitude", "power", "complex"):
        raise ValueError(
            f"unknown cqt output {output!r}; known: magnitude, power, complex"
        )
    check_precision(precision)
    dz = _multirate_design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    t = x.shape[-1]
    outs = []
    for h, flen, bank in dz["octs"]:
        half = flen // 2
        xp = F.pad(x, (half, flen - half))
        y = _framed_dot(xp, bank, h, t // h + 1)
        nb = bank.shape[1] // 2
        outs.append(_finish(y[..., :nb], y[..., nb:], output))
    meta = _MrMeta(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale,
        dz["hops"], t,
    )
    return MultirateCqt(outs, meta)


def icqt_multirate(
    c: MultirateCqt,
    length: int | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """Inverse of :func:`cqt_multirate` (complex output): per octave, the
    hop-block feature conv against its truncated joint dual, summed.
    ``length`` defaults to the forward's input sample count."""
    if not isinstance(c, MultirateCqt):
        raise TypeError(
            f"icqt_multirate takes a MultirateCqt (cqt_multirate output), "
            f"got {type(c).__name__}"
        )
    if not c.octaves[0].is_complex():
        raise ValueError(
            "icqt_multirate needs complex coefficients "
            "(cqt_multirate(..., output='complex'))"
        )
    check_precision(precision)
    m = c.meta
    dz = _multirate_design(
        m.sample_rate, m.hop, m.n_bins, m.fmin, m.bins_per_octave, m.window,
        m.filter_scale,
    )
    if length is None:
        length = m.length
    y = None
    for (_lo0, dual, kern), co in zip(dz["duals"], c.octaves):
        span = dual.shape[1]
        ri = torch.cat([co.real, co.imag], dim=-1)
        # OLA coord i <-> output sample i - span//2 (frame t's dual is
        # centered at t*h)
        seg = _feature_conv(ri, kern)[..., span // 2 :]
        if seg.shape[-1] < length:
            seg = F.pad(seg, (0, length - seg.shape[-1]))
        seg = seg[..., :length]
        y = seg if y is None else y + seg
    return y


def chroma_cqt(
    x: torch.Tensor,
    sample_rate: float,
    hop: int = 256,
    n_octaves: int = 7,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    norm: bool = True,
    **kwargs,
) -> torch.Tensor:
    """Pitch-class chromagram folded from the constant-Q transform
    ``[..., n_frames, 12]``: every octave of a pitch class adds to one bin.
    ``bins_per_octave`` must be a multiple of 12; ``norm=True``
    L-inf-normalizes each frame; extra kwargs pass through to :func:`cqt`."""
    if bins_per_octave % 12:
        raise ValueError(f"bins_per_octave must be a multiple of 12, got {bins_per_octave}")
    n_bins = n_octaves * bins_per_octave
    c = cqt(x, sample_rate, hop, n_bins, fmin, bins_per_octave, **kwargs)
    folded = c.reshape(*c.shape[:-1], n_octaves, bins_per_octave).sum(dim=-2)
    if bins_per_octave > 12:
        sub = bins_per_octave // 12
        folded = folded.reshape(*folded.shape[:-1], 12, sub).sum(dim=-1)
    if norm:
        folded = folded / torch.clamp_min(folded.amax(dim=-1, keepdim=True), 1e-10)
    return folded
