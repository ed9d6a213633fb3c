"""Fused time stretch: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/timestretch.cu``) replaces the Pallas kernel
``audioflow_tpu/ops/pallas/timestretch.py::time_stretch_pallas`` and computes
the same function of each row of ``x [..., T]`` at a rational rate p/q:

1. reflect-pad by n_fft//2 (center=True), zero-extended past the end;
2. windowed real DFT ``s[f]`` of input frames f;
3. unit increment phasors ``u[f] = s[f+1]·conj(s[f]) / (|s[f+1]||s[f]|)``
   (1 where that product is 0);
4. for output frame v: ``lo = (v·p)//q``, ``frac = ((v·p) mod q)/q``,
   ``mag = (1-frac)|s[lo]| + frac|s[lo+1]|``, where ``lo+1`` may be a frame
   of the zero extension (the kernel's tail convention, unlike the matmul
   path, which clamps to the last frame);
5. phase ``z_v = unit(s[0]) · ∏_{w<v} u[lo(w)]``, renormalised every step;
6. ``S_v = mag·z_v``, inverse real DFT with the synthesis window folded into
   the banks, overlap-add;
7. divide by the window-square overlap-add of the offline frame count
   (``t_out_off``) and trim to ``[n_fft//2, n_fft//2 + round(T·q/p))``.

Only output frames below ``cdiv(n_fft//2 + out_len, hop)`` reach the trimmed
output, so only those are computed. The kernel has two paths behind one
launch, chosen by shape (:func:`kernel_path`): for a power-of-two n_fft from
16 to 2048, the analysis and synthesis passes run on the shared-memory FFT
(``csrc/fft.cuh``; the window and the twiddles of ``fft.twiddles``), the
analysis in float64 so that the phase walk of step 5 does not carry a
float32 transform's rounding at weak bins; for every
other configuration that :func:`supported` takes, on dense DFT products
against the banks. Both run step 5 in segments of the output frames
(:data:`PHASE_SEGMENTS`), carried across the segments as the Pallas kernel
carries its tiles; :func:`time_stretch_model` is that form in plain torch.

:func:`time_stretch_fused` takes a tensor on the CPU to the plain version,
launches the kernel for a CUDA tensor, and raises for anything the kernel
does not take. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ...utils import cdiv
from ...utils.cache import BoundedCache, on_device
from .._mm import PRECISIONS, mm
from ..framing import frame, overlap_add
from ..stft import Banks, kernel_banks, pad_center, padded_window
from . import fft
from ._build import _MAX_SMEM, LaunchCount, check_mirror, launch, load

# mirrors of csrc/timestretch.cu's constants (dft.cuh's kFrames and kRows,
# the FFT path's warps per block and synthesis tile), so that supported()
# and kernel_path() need no build; the wrapper checks the mirrors against
# the library
_FRAMES = 16
_ROWS = 16
_WARPS = 8
_FFT_TILE = 16
# time segments of the phase pass (csrc/timestretch.cu's kSegments, one warp
# each in a block), for the plain-torch model of the pass
PHASE_SEGMENTS = 8

COUNT = LaunchCount()

# WOLA normalisers, one float32 vector of out_len per (plan, window)
_NORM_CACHE = BoundedCache(maxsize=16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("timestretch")
    lib.timestretch_launch.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.timestretch_launch.restype = ctypes.c_int
    lib.timestretch_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.timestretch_smem_bytes.restype = ctypes.c_longlong
    lib.timestretch_path.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.timestretch_path.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _lib()


def _rationalize(rate: float, max_den: int = 12) -> tuple[int, int] | None:
    fr = Fraction(rate).limit_denominator(max_den)
    if fr.numerator <= 0 or abs(float(fr) - rate) > 1e-9:
        return None
    return fr.numerator, fr.denominator


def _dense_smem_bytes(n_fft: int, hop: int) -> int:
    """Dynamic shared memory of the dense path's larger block: the analysis
    block's staged frames or the synthesis block's staged spectra."""
    ld = (n_fft + 3) & ~3
    kpad = (n_fft // 2 + 1 + 3) & ~3
    return 4 * max(_FRAMES * ld, 2 * (_ROWS + n_fft // hop - 1) * kpad)


def _fft_smem_bytes(n_fft: int, hop: int) -> int:
    """Dynamic shared memory of the FFT path's larger block: the twiddles,
    the window and a frame slot per warp, fp64 in the analysis block, fp32
    in the synthesis block with its tile of hop-rows."""
    m = n_fft // 2
    slot = 2 * (m + (m >> 5))
    analysis = 16 * m + 8 * _WARPS * slot + 4 * n_fft
    return max(analysis, 8 * m + 4 * (n_fft + _WARPS * slot + _FFT_TILE * hop))


def fft_tile(n_fft: int, hop: int) -> int:
    """Output hop-rows per synthesis block of the FFT path, or 0 where the
    configuration takes the dense path: an n_fft that is not a power of two
    from 16 to 2048, or a hop that does not divide it. Every FFT-path block
    fits in shared memory (215,040 bytes at n_fft 2048, hop 2048)."""
    return _FFT_TILE if fft.is_fft_size(n_fft) and hop >= 1 and n_fft % hop == 0 else 0


def kernel_path(n_fft: int, hop: int) -> str:
    """The path the kernel takes for a supported configuration, chosen by
    shape: ``"fft"`` (analysis and synthesis on the shared-memory FFT) or
    ``"dense"`` (dense DFT products against the banks)."""
    return "fft" if fft_tile(n_fft, hop) else "dense"


def smem_bytes(n_fft: int, hop: int) -> int:
    """Dynamic shared memory of the largest block of the path the kernel
    takes (:func:`kernel_path`)."""
    return _fft_smem_bytes(n_fft, hop) if fft_tile(n_fft, hop) else _dense_smem_bytes(n_fft, hop)


def supported(rate: float, n_fft: int = 1024, hop: int = 256) -> bool:
    """True when the fused kernel takes this (rate, n_fft, hop).

    A rate qualifies when it is a rational p/q with q <= 12, hop divides
    n_fft, and the blocks of the path taken fit in shared memory: every
    power-of-two n_fft from 16 to 2048 (the FFT path), and any other n_fft
    whose dense blocks fit (:func:`smem_bytes`; up to about 2048 at hop
    n_fft/4). The JAX predicate also asks the TPU kernel's VMEM model
    (``_make_plan``), which rejects n_fft 2048 at every rate and rates such
    as 9/5, 4/7 or 8/9 at 1024/256. That model does not describe this card,
    so this predicate accepts every configuration the JAX one accepts, and
    more.
    """
    if _rationalize(rate) is None or hop < 1 or n_fft < 2 or n_fft % hop:
        return False
    return smem_bytes(n_fft, hop) <= _MAX_SMEM


@dataclass(frozen=True)
class Plan:
    """The static shapes of one call."""

    p: int
    q: int
    n_fft: int
    hop: int
    t: int  # input samples
    out_len: int  # round(t * q / p)
    n_out: int  # output frames that reach the trimmed output
    n_in: int  # input frames read: the last output frame's lo + 1
    t_out_off: int  # output frames of the offline path: its WOLA normaliser

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


def make_plan(t: int, rate: float, n_fft: int, hop: int) -> Plan:
    if not supported(rate, n_fft, hop):
        raise ValueError(f"unsupported (rate={rate}, n_fft={n_fft}, hop={hop}) for the fused kernel")
    if t <= n_fft // 2:
        raise ValueError(f"signal length {t} must exceed n_fft//2 = {n_fft // 2} (reflect padding)")
    p, q = _rationalize(rate)
    out_len = int(round(t * q / p))
    if out_len < 1:
        raise ValueError(f"rate {rate} leaves no output sample of {t}")
    n_out = cdiv(n_fft // 2 + out_len, hop)
    return Plan(
        p, q, n_fft, hop, t, out_len, n_out,
        n_in=(n_out - 1) * p // q + 2,
        t_out_off=cdiv((t // hop + 1) * q, p),
    )


def _designs(n_fft: int, window: str, device, fft_path: bool) -> tuple[torch.Tensor | None, ...]:
    """The host designs that one path reads, uploaded once per device, in
    the C entry's order (the window, the twiddles in float32 and float64,
    the four banks), None for the rest: for the FFT
    path the float32 window ``[n_fft]`` (analysis and synthesis alike) and
    the twiddles ``[n_fft/2, 2]`` in float32 (synthesis) and float64
    (analysis); for the dense path the float32 banks."""
    if fft_path:
        return (on_device(padded_window(n_fft, window), device), on_device(fft.twiddles(n_fft), device),
                on_device(fft.twiddles(n_fft, np.float64), device, torch.float64), None, None, None, None)
    return (None, None, None, *kernel_banks(n_fft, window, device))


def wola_norm(plan: Plan, window: str) -> np.ndarray:
    """``max(wsum, 1e-11)`` over the trimmed output, float32 ``[out_len]``:
    ``wsum`` is the overlap-add of ``w²`` over ``t_out_off`` frames, zero
    past its end (``timestretch.py:496-501``)."""
    key = (plan, window)
    if key not in _NORM_CACHE:
        w = padded_window(plan.n_fft, window)
        wsq = torch.from_numpy((w * w).astype(np.float32)).expand(plan.t_out_off, plan.n_fft)
        wsum = overlap_add(wsq, plan.hop).numpy()
        half = plan.n_fft // 2
        norm = np.zeros(plan.out_len, np.float32)
        m = min(max(wsum.size - half, 0), plan.out_len)
        norm[:m] = wsum[half : half + m]
        _NORM_CACHE[key] = np.maximum(norm, np.float32(1e-11))
    return _NORM_CACHE[key]


def _unit(zr, zi, m):
    """``(zr, zi) / m``, or the unit phasor 1 where ``m`` is 0."""
    ok = m > 0
    safe = torch.where(ok, m, 1.0)
    return torch.where(ok, zr / safe, 1.0), torch.where(ok, zi / safe, 0.0)


def _walk(zr, zi, u_r, u_i):
    """The phase of each step along axis -2 of ``u [..., L, bins]`` from the
    phase ``z [..., bins]``, renormalised every step: ``(z_re, z_im)``, and
    the phase after the last step."""
    z_re, z_im = torch.empty_like(u_r), torch.empty_like(u_i)
    for step in range(u_r.shape[-2]):
        z_re[..., step, :], z_im[..., step, :] = zr, zi
        nr = zr * u_r[..., step, :] - zi * u_i[..., step, :]
        ni = zr * u_i[..., step, :] + zi * u_r[..., step, :]
        zr, zi = _unit(nr, ni, torch.sqrt(nr * nr + ni * ni))
    return z_re, z_im, zr, zi


def _phases(zr, zi, u_r, u_i, segments: int):
    """Step 5 for ``u [batch, n_out, bins]`` from ``z_0``. One segment is the
    sequential walk. With more, as the kernel's phase pass: the output frames
    split into ``segments`` runs of ``cdiv(n_out, segments)``, each walked
    from 1 for its product, the phase carried across the runs, renormalised
    at each boundary, and each run walked again from its carry."""
    if segments == 1:
        return _walk(zr, zi, u_r, u_i)[:2]
    batch, n_out, n_bins = u_r.shape
    seg_len = cdiv(n_out, segments)
    pad = segments * seg_len - n_out  # steps past n_out: no carry uses them
    u_r = torch.nn.functional.pad(u_r, (0, 0, 0, pad), value=1.0).reshape(batch, segments, seg_len, n_bins)
    u_i = torch.nn.functional.pad(u_i, (0, 0, 0, pad)).reshape(batch, segments, seg_len, n_bins)
    ones = torch.ones((batch, segments, n_bins), dtype=u_r.dtype, device=u_r.device)
    _, _, pr, pi = _walk(ones, torch.zeros_like(ones), u_r, u_i)
    cr, ci = [zr], [zi]
    for j in range(segments - 1):
        nr = cr[-1] * pr[:, j] - ci[-1] * pi[:, j]
        ni = cr[-1] * pi[:, j] + ci[-1] * pr[:, j]
        nr, ni = _unit(nr, ni, torch.sqrt(nr * nr + ni * ni))
        cr.append(nr)
        ci.append(ni)
    z_re, z_im, _, _ = _walk(torch.stack(cr, 1), torch.stack(ci, 1), u_r, u_i)
    return tuple(z.reshape(batch, segments * seg_len, n_bins)[:, :n_out] for z in (z_re, z_im))


def _reference(x: torch.Tensor, plan: Plan, bk: Banks, norm: torch.Tensor, segments: int = 1) -> torch.Tensor:
    """Plain torch, ``x [batch, T]`` -> ``[batch, out_len]``: DFT matmuls,
    the phasor recurrence vectorised over rows and bins (:func:`_phases`),
    iDFT matmuls and ``overlap_add``."""
    n_fft, hop, n_in, n_out = plan.n_fft, plan.hop, plan.n_in, plan.n_out
    xp = pad_center(x.to(torch.float32), n_fft)
    need = (n_in - 1) * hop + n_fft
    if xp.shape[-1] < need:
        xp = torch.nn.functional.pad(xp, (0, need - xp.shape[-1]))
    frames = frame(xp, n_fft, hop)[:, :n_in]
    re, im = mm(frames, bk.cos), mm(frames, bk.sin)
    mag = torch.sqrt(re * re + im * im)

    # unit increment phasors between consecutive input frames
    uvr = re[:, 1:] * re[:, :-1] + im[:, 1:] * im[:, :-1]
    uvi = im[:, 1:] * re[:, :-1] - re[:, 1:] * im[:, :-1]
    denom = mag[:, 1:] * mag[:, :-1]
    ok = denom > 0
    safe = torch.where(ok, denom, 1.0)
    ur = torch.where(ok, uvr / safe, 1.0)
    ui = torch.where(ok, uvi / safe, 0.0)

    v = np.arange(n_out, dtype=np.int64) * plan.p
    lo = torch.from_numpy(v // plan.q).to(x.device)
    frac = torch.from_numpy(((v % plan.q).astype(np.float32) * np.float32(1.0 / plan.q))[:, None])
    frac = frac.to(x.device)
    mag_o = (1.0 - frac) * mag[:, lo] + frac * mag[:, lo + 1]
    zr, zi = _unit(re[:, 0], im[:, 0], mag[:, 0])
    z_re, z_im = _phases(zr, zi, ur[:, lo], ui[:, lo], segments)

    out = mm(mag_o * z_re, bk.icos) + mm(mag_o * z_im, bk.isin)
    half = n_fft // 2
    return overlap_add(out, hop)[:, half : half + plan.out_len] / norm


def time_stretch_reference(
    x: torch.Tensor, rate: float, n_fft: int = 1024, hop: int = 256, window: str = "hann"
) -> torch.Tensor:
    """The plain torch version of the kernel, on any device: ``[..., T]`` ->
    ``[..., round(T / rate)]``."""
    if x.ndim == 0:
        raise ValueError("expected [..., T], got a scalar")
    plan = make_plan(x.shape[-1], rate, n_fft, hop)
    bk = kernel_banks(n_fft, window, x.device)
    norm = on_device(wola_norm(plan, window), x.device)
    return _reference(x.reshape(-1, plan.t), plan, bk, norm).reshape(*x.shape[:-1], plan.out_len)


def time_stretch_model(
    x: torch.Tensor, rate: float, n_fft: int = 1024, hop: int = 256, window: str = "hann",
    segments: int = PHASE_SEGMENTS,
) -> torch.Tensor:
    """:func:`time_stretch_reference` with step 5 in the kernel's segmented
    form (:func:`_phases`), on any device: the plain-torch model of the
    kernel's phase pass."""
    if x.ndim == 0:
        raise ValueError("expected [..., T], got a scalar")
    plan = make_plan(x.shape[-1], rate, n_fft, hop)
    bk = kernel_banks(n_fft, window, x.device)
    norm = on_device(wola_norm(plan, window), x.device)
    return _reference(x.reshape(-1, plan.t), plan, bk, norm, segments).reshape(*x.shape[:-1], plan.out_len)


def time_stretch_fused(
    x: torch.Tensor,
    rate: float,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    precision: str | None = None,
    inv_precision: str | None = None,
) -> torch.Tensor:
    """Fused time stretch of ``x [..., T]`` by ``1/rate``: one launch for
    all leading axes, flattened into rows.

    ``precision`` and ``inv_precision`` take the JAX package's names for
    parity; the kernel computes in fp32 whatever they say.
    """
    for p in (precision, inv_precision):
        if p is not None and p not in PRECISIONS:
            raise ValueError(f"unknown precision {p!r}; known: {sorted(PRECISIONS)}")
    if x.device.type in ("cpu", "meta"):
        return time_stretch_reference(x, rate, n_fft, hop, window)
    if x.device.type != "cuda":
        raise ValueError(f"time_stretch_fused runs on cpu or cuda tensors, not {x.device.type}")
    if x.ndim == 0:
        raise ValueError("expected [..., T], got a scalar")
    if x.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous signal")
    plan = make_plan(x.shape[-1], rate, n_fft, hop)
    return _launch(x.reshape(-1, plan.t), plan, window).reshape(*x.shape[:-1], plan.out_len)


def _launch(x: torch.Tensor, plan: Plan, window: str) -> torch.Tensor:
    """The kernel on a contiguous float32 CUDA ``x [batch, T]``: one launch,
    counted."""
    batch, (n_fft, hop) = x.shape[0], (plan.n_fft, plan.hop)
    if batch * max(plan.n_in, plan.n_out) * plan.n_bins >= 2**31 or plan.t >= 2**31:
        raise ValueError(f"batch {batch} x {plan.n_out} frames is too large for one call")
    lib, tile = _lib(), fft_tile(n_fft, hop)
    check_mirror("timestretch", (n_fft, hop), (tile, smem_bytes(n_fft, hop)),
                 lambda: (lib.timestretch_path(n_fft, hop), lib.timestretch_smem_bytes(n_fft, hop)))
    designs = _designs(n_fft, window, x.device, tile > 0)
    norm = on_device(wola_norm(plan, window), x.device)
    spec = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    re, im = spec((batch, plan.n_in, plan.n_bins)), spec((batch, plan.n_in, plan.n_bins))
    s_re, s_im = spec((batch, plan.n_out, plan.n_bins)), spec((batch, plan.n_out, plan.n_bins))
    out = spec((batch, plan.out_len))
    launch(
        "timestretch", COUNT, lib.timestretch_launch, x.device,
        x.data_ptr(), *(None if t is None else t.data_ptr() for t in designs),
        norm.data_ptr(), re.data_ptr(), im.data_ptr(), s_re.data_ptr(), s_im.data_ptr(), out.data_ptr(),
        batch, plan.t, n_fft, hop, plan.p, plan.q, plan.n_in, plan.n_out, plan.out_len,
    )
    return out
