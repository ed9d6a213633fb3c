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
output, so only those are computed. :func:`time_stretch_fused` takes a
tensor on the CPU to the plain version, launches the kernel for a CUDA
tensor, and raises for anything the kernel does not take. It never falls
back.
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
from ._build import load
from .melspec import LaunchCount

# shared memory one block may use on Hopper (227 KB of the SM's 256 KB)
_MAX_SMEM = 232_448
# mirrors of csrc/timestretch.cu's kFrames and kRows, so that supported()
# needs no build; the wrapper checks the mirror against the library
_FRAMES = 16
_ROWS = 16

COUNT = LaunchCount()

# WOLA normalisers, one float32 vector of out_len per (plan, window)
_NORM_CACHE = BoundedCache(maxsize=16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("timestretch")
    lib.timestretch_launch.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.timestretch_launch.restype = ctypes.c_int
    lib.timestretch_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.timestretch_smem_bytes.restype = ctypes.c_longlong
    return lib


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _lib()


def _rationalize(rate: float, max_den: int = 12) -> tuple[int, int] | None:
    fr = Fraction(rate).limit_denominator(max_den)
    if fr.numerator <= 0 or abs(float(fr) - rate) > 1e-9:
        return None
    return fr.numerator, fr.denominator


def smem_bytes(n_fft: int, hop: int) -> int:
    """Dynamic shared memory of the kernel's largest block: the analysis
    block's staged frames or the synthesis block's staged spectra."""
    ld = (n_fft + 3) & ~3
    kpad = (n_fft // 2 + 1 + 3) & ~3
    return 4 * max(_FRAMES * ld, 2 * (_ROWS + n_fft // hop - 1) * kpad)


def supported(rate: float, n_fft: int = 1024, hop: int = 256) -> bool:
    """True when the fused kernel takes this (rate, n_fft, hop).

    A rate qualifies when it is a rational p/q with q <= 12, hop divides
    n_fft, and the kernel's blocks fit in shared memory (:func:`smem_bytes`;
    n_fft up to 2048 at hop n_fft/4). The JAX predicate also asks the TPU
    kernel's VMEM model (``_make_plan``), which rejects n_fft 2048 at every
    rate and rates such as 9/5, 4/7 or 8/9 at 1024/256. That model does not
    describe this card, so this predicate accepts every configuration the
    JAX one accepts, and more.
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


def _reference(x: torch.Tensor, plan: Plan, bk: Banks, norm: torch.Tensor) -> torch.Tensor:
    """Plain torch, ``x [batch, T]`` -> ``[batch, out_len]``: DFT matmuls,
    the sequential phasor loop vectorised over rows and bins, iDFT matmuls
    and ``overlap_add``."""
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
    u_r, u_i = ur[:, lo], ui[:, lo]

    def unit(zr, zi, m):
        ok = m > 0
        safe = torch.where(ok, m, 1.0)
        return torch.where(ok, zr / safe, 1.0), torch.where(ok, zi / safe, 0.0)

    zr, zi = unit(re[:, 0], im[:, 0], mag[:, 0])
    z_re = torch.empty_like(mag_o)
    z_im = torch.empty_like(mag_o)
    for step in range(n_out):  # the phase carry, renormalised every step
        z_re[:, step], z_im[:, step] = zr, zi
        nr = zr * u_r[:, step] - zi * u_i[:, step]
        ni = zr * u_i[:, step] + zi * u_r[:, step]
        zr, zi = unit(nr, ni, torch.sqrt(nr * nr + ni * ni))

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
    lead = x.shape[:-1]
    x = x.reshape(-1, plan.t)
    batch = x.shape[0]
    if batch * max(plan.n_in, plan.n_out) * plan.n_bins >= 2**31 or plan.t >= 2**31:
        raise ValueError(f"batch {batch} x {plan.n_out} frames is too large for one call")
    lib = _lib()
    smem = lib.timestretch_smem_bytes(n_fft, hop)
    if smem != smem_bytes(n_fft, hop):
        raise RuntimeError(f"smem_bytes() is out of date with timestretch.cu: {smem_bytes(n_fft, hop)} vs {smem}")
    bk = kernel_banks(n_fft, window, x.device)
    norm = on_device(wola_norm(plan, window), x.device)
    spec = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    re, im = spec((batch, plan.n_in, plan.n_bins)), spec((batch, plan.n_in, plan.n_bins))
    s_re, s_im = spec((batch, plan.n_out, plan.n_bins)), spec((batch, plan.n_out, plan.n_bins))
    out = spec((batch, plan.out_len))
    with torch.cuda.device(x.device):
        err = lib.timestretch_launch(
            x.data_ptr(), *(t.data_ptr() for t in bk), norm.data_ptr(),
            re.data_ptr(), im.data_ptr(), s_re.data_ptr(), s_im.data_ptr(), out.data_ptr(),
            batch, plan.t, n_fft, hop, plan.p, plan.q, plan.n_in, plan.n_out, plan.out_len,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"timestretch kernel launch failed: cudaError {err}")
    COUNT.launches += 1
    return out.reshape(*lead, plan.out_len)
