"""Fused Griffin-Lim iteration: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/griffinlim.cu``) replaces the Pallas kernel
``audioflow_tpu/ops/pallas/griffinlim.py::griffin_lim_pallas``. One launch
is one fast Griffin-Lim iteration on state planes ``[batch, F, n_bins]``:

1. momentum extrapolation and magnitude replacement of the rebuilt spectra
   ``r`` (this iteration's) and ``r2`` (the previous one's):
   ``a = (1+m)·r − m·r2``, ``s = mag·a / max(|a|, 1e-16)``;
2. windowed inverse real DFT of ``s``, overlap-add into ``F + k − 1``
   hop-rows (``k = n_fft/hop``), times the WOLA row inverse ``inv``;
3. windowed real DFT of every frame of that raw row stream: frame f reads
   rows ``[f, f + k)``, with no padding. This is the Pallas kernel's edge
   convention: the matmul path re-analyses the centre-trimmed signal with
   reflect padding, so its first two frames and its last differ by design.

The kernel has two paths behind one launch, chosen by shape
(:func:`kernel_path`): for a power-of-two n_fft from 16 to 2048 with
``k <= 16``, one fused pass on a shared-memory FFT (``csrc/fft.cuh``; the
window and twiddles of :func:`designs`); for every other configuration that
:func:`supported` takes, two passes of dense DFT products against the banks.

:func:`griffin_lim_fused` runs ``n_iter`` iterations around it as the JAX
wrapper does (``pallas/griffinlim.py:354-393``): state seeded with
``mag·e^{iφ}``, the previous-rebuilt slot zeroed after the first call, and
one last momentum + magnitude replacement before the port's ``istft``.
:func:`griffin_lim_iteration` takes a tensor on the CPU to the plain version,
launches the kernel for a CUDA tensor, and raises for anything the kernel
does not take. It never falls back.

The JAX package keeps banks and state planes in bf16 under its default
precision; the port computes and stores everything in fp32 for every
precision name.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ...utils import as_tensor
from ...utils.cache import BoundedCache, on_device
from .._mm import mm
from ..framing import frame, overlap_add
from ..stft import Banks, istft, kernel_banks, padded_window
from . import fft
from ._build import _MAX_SMEM, LaunchCount, check_mirror, launch, load

# mirrors of dft.cuh's kFrames and kRows and of griffinlim.cu's FFT-path
# constants, so that supported() and kernel_path() need no build; the
# wrapper checks the mirrors against the library
_FRAMES = 16
_ROWS = 16
_MAX_FFT_K = 16
_WARPS = 8  # frames an FFT-path block transforms at once, one per warp
_FFT_TILE = 16

COUNT = LaunchCount()

# WOLA row inverses, one float32 [F + k - 1, hop] per (n_fft, hop, window, F)
_INV_CACHE = BoundedCache(maxsize=16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("griffinlim")
    lib.griffinlim_iter_launch.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    )
    lib.griffinlim_iter_launch.restype = ctypes.c_int
    lib.griffinlim_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.griffinlim_smem_bytes.restype = ctypes.c_longlong
    lib.griffinlim_path.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.griffinlim_path.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _lib()


def _segment_group(n_fft: int, hop: int) -> int:
    """Hop segments a synthesis block takes at once: all ``n_fft/hop`` when
    the staged spectra of their ``_ROWS + group - 1`` frames fit in shared
    memory, else as many as fit (below 1: the transform does not fit)."""
    kpad = (n_fft // 2 + 1 + 3) & ~3
    return min(n_fft // hop, _MAX_SMEM // (8 * kpad) - _ROWS + 1)


def _dense_smem_bytes(n_fft: int, hop: int) -> int:
    """Dynamic shared memory of the dense path's larger block: the analysis
    block's staged frames, or the synthesis block's staged spectra."""
    kpad = (n_fft // 2 + 1 + 3) & ~3
    return 4 * max(_FRAMES * ((n_fft + 3) & ~3), 2 * (_ROWS + _segment_group(n_fft, hop) - 1) * kpad)


def _fft_smem_bytes(n_fft: int, hop: int, tile: int) -> int:
    """Dynamic shared memory of an FFT-path block of ``tile`` output frames:
    the twiddles, a frame slot per warp and the block's hop-rows."""
    m = n_fft // 2
    slot = 2 * (m + (m >> 5))
    return 8 * m + 4 * (_WARPS * slot + (tile + n_fft // hop - 1) * hop)


def fft_tile(n_fft: int, hop: int) -> int:
    """Output frames per block of the FFT path, or 0 where the configuration
    takes the dense path: an n_fft that is not a power of two from 16 to
    2048, or ``n_fft/hop`` above 16."""
    if not fft.is_fft_size(n_fft) or n_fft // hop > _MAX_FFT_K:
        return 0
    return _FFT_TILE if _fft_smem_bytes(n_fft, hop, _FFT_TILE) <= _MAX_SMEM else 0


def kernel_path(n_fft: int, hop: int) -> str:
    """The path the kernel takes for a supported configuration, chosen by
    shape: ``"fft"`` (one fused pass on the shared-memory FFT) or
    ``"dense"`` (two passes of dense DFT products)."""
    return "fft" if fft_tile(n_fft, hop) else "dense"


def smem_bytes(n_fft: int, hop: int) -> int:
    """Dynamic shared memory of the largest block of the path the kernel
    takes (:func:`kernel_path`)."""
    tile = fft_tile(n_fft, hop)
    return _fft_smem_bytes(n_fft, hop, tile) if tile else _dense_smem_bytes(n_fft, hop)


def supported(
    n_fft: int = 1024, hop: int = 256, win_length: int | None = None, precision: str = "default"
) -> bool:
    """True when the fused kernel takes this configuration.

    It asks for the full-length window, hop | n_fft with ``n_fft/hop >= 2``,
    and dense-path blocks that fit in shared memory (n_fft up to about
    3,600 at any such hop); :func:`kernel_path` then says which path runs.
    ``precision`` is accepted for parity: the kernel computes in fp32
    whatever it says. The JAX predicate asks the TPU kernel's VMEM model
    (``_pick_tile``, ``_vmem_estimate``), which rejects n_fft 2048 at hop 64
    or 1024 at hop 8, and n_fft above about 2,400 at every hop. That model does not describe this card: this
    predicate accepts every configuration the JAX one accepts, and more.
    """
    if win_length not in (None, n_fft) or hop < 1 or n_fft < 2 or n_fft % hop or n_fft // hop < 2:
        return False
    return _segment_group(n_fft, hop) >= 1 and _dense_smem_bytes(n_fft, hop) <= _MAX_SMEM


def wola_inverse(n_fft: int, hop: int, window: str, n_frames: int) -> np.ndarray:
    """``where(wsum > 0, 1/max(wsum, 1e-11), 1)`` as float32 ``[F + k - 1,
    hop]``: ``wsum`` is the float64 overlap-add of the squared window over
    the true frame count, summed segment by segment as the JAX wrapper does
    (``pallas/griffinlim.py:280-290``). Cached: callers must not write to it."""
    key = (n_fft, hop, window, n_frames)
    if key not in _INV_CACHE:
        k = n_fft // hop
        w = padded_window(n_fft, window)
        wsq = (w * w).reshape(k, hop)
        wsum = np.zeros((n_frames + k - 1, hop), np.float64)
        for j in range(k):
            wsum[j : j + n_frames] += wsq[j]
        _INV_CACHE[key] = np.where(wsum > 0, 1.0 / np.maximum(wsum, 1e-11), 1.0).astype(np.float32)
    return _INV_CACHE[key]


class Designs(NamedTuple):
    """The host designs of a call, float32 on one device: the analysis and
    synthesis banks (the dense path and the plain version), the WOLA row
    inverse ``[F + k - 1, hop]``, and for the FFT path the window ``[n_fft]``
    (analysis and synthesis alike) and the twiddles ``[n_fft/2, 2]``."""

    banks: Banks
    inv: torch.Tensor
    window: torch.Tensor
    twiddles: torch.Tensor


def designs(n_fft: int, hop: int, window: str, n_frames: int, device) -> Designs:
    """The :class:`Designs` of a call on ``device`` (uploaded once per device)."""
    return Designs(
        kernel_banks(n_fft, window, device), on_device(wola_inverse(n_fft, hop, window, n_frames), device),
        on_device(padded_window(n_fft, window), device), on_device(fft.twiddles(n_fft), device),
    )


def _coefficients(momentum: float) -> tuple[float, float]:
    """``(1 + m, m)`` rounded to float32, as the Pallas kernel forms them."""
    m = np.float32(momentum)
    return float(np.float32(1.0) + m), float(m)


def replace_magnitude(r_re, r_im, r2_re, r2_im, mag, momentum: float):
    """Momentum extrapolation and magnitude replacement, in fp32:
    ``a = (1+m)·r − m·r2``, ``s = mag·a / max(|a|, 1e-16)``. A zero ``a``
    gives ``s = 0``."""
    c1, m = _coefficients(momentum)
    a_re = c1 * r_re - m * r2_re
    a_im = c1 * r_im - m * r2_im
    guard = torch.clamp_min(torch.sqrt(a_re * a_re + a_im * a_im), 1e-16)
    return mag * (a_re / guard), mag * (a_im / guard)


def griffin_lim_iteration_reference(r_re, r_im, r2_re, r2_im, mag, momentum: float, d: Designs):
    """Plain torch, one iteration on ``[batch, F, n_bins]`` planes with the
    :func:`designs` ``d``: the prologue, the inverse DFT with the synthesis
    banks, ``overlap_add``, the row inverse, ``frame`` and the analysis
    banks. Returns ``(o_re, o_im)``."""
    bk, inv = d.banks, d.inv
    s_re, s_im = replace_magnitude(r_re, r_im, r2_re, r2_im, mag, momentum)
    frames = mm(s_re, bk.icos) + mm(s_im, bk.isin)
    n_fft, hop = bk.icos.shape[1], inv.shape[1]
    sig = overlap_add(frames, hop) * inv.reshape(-1)
    fr = frame(sig, n_fft, hop)
    return mm(fr, bk.cos), mm(fr, bk.sin)


def _launch(r_re, r_im, r2_re, r2_im, mag, momentum: float, d: Designs):
    """The kernel on CUDA planes: one launch, counted."""
    planes = (r_re, r_im, r2_re, r2_im, mag)
    if any(p.dtype != torch.float32 for p in planes):
        raise ValueError(f"the kernel takes float32, got {[p.dtype for p in planes]}")
    if not all(p.is_contiguous() for p in planes):
        raise ValueError("the kernel takes contiguous state planes")
    batch, n_frames, n_bins = mag.shape
    n_fft, (n_rows, hop) = d.banks.icos.shape[1], d.inv.shape
    if batch * max(n_frames * n_bins, n_rows * hop) >= 2**31:
        raise ValueError(f"batch {batch} x {n_frames} frames is too large for one call")
    lib, tile = _lib(), fft_tile(n_fft, hop)
    check_mirror("griffinlim", (n_fft, hop), (tile, smem_bytes(n_fft, hop)),
                 lambda: (lib.griffinlim_path(n_fft, hop), lib.griffinlim_smem_bytes(n_fft, hop)))
    # the row stream is scratch of the dense path only
    sig = None if tile else torch.empty((batch, n_rows, hop), dtype=torch.float32, device=mag.device)
    o_re, o_im = torch.empty_like(mag), torch.empty_like(mag)
    c1, m = _coefficients(momentum)
    launch(
        "griffinlim", COUNT, lib.griffinlim_iter_launch, mag.device,
        *(p.data_ptr() for p in planes), d.window.data_ptr(), d.twiddles.data_ptr(),
        *(t.data_ptr() for t in d.banks), d.inv.data_ptr(),
        None if sig is None else sig.data_ptr(), o_re.data_ptr(), o_im.data_ptr(),
        batch, n_frames, n_fft, hop, c1, m,
    )
    return o_re, o_im


def _iterate(r_re, r_im, r2_re, r2_im, mag, momentum: float, d: Designs):
    """The plain version for planes on the CPU, the kernel on the card."""
    if mag.device.type in ("cpu", "meta"):
        return griffin_lim_iteration_reference(r_re, r_im, r2_re, r2_im, mag, momentum, d)
    if mag.device.type != "cuda":
        raise ValueError(f"griffin_lim_iteration runs on cpu or cuda tensors, not {mag.device.type}")
    return _launch(r_re, r_im, r2_re, r2_im, mag, momentum, d)


def griffin_lim_iteration(
    r_re: torch.Tensor,
    r_im: torch.Tensor,
    r2_re: torch.Tensor,
    r2_im: torch.Tensor,
    mag: torch.Tensor,
    momentum: float = 0.99,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused iteration: the rebuilt spectra ``(o_re, o_im)`` of
    ``s = mag·unit((1+m)·r − m·r2)``, all planes ``[batch, F, n_bins]``.
    One launch on a CUDA tensor; the plain version on the CPU."""
    planes = (r_re, r_im, r2_re, r2_im, mag)
    shape = mag.shape
    if len(shape) != 3:
        raise ValueError(f"state planes must be [batch, F, n_bins], got {tuple(shape)}")
    if shape[-1] != n_fft // 2 + 1:
        raise ValueError(f"mag has {shape[-1]} bins; expected {n_fft // 2 + 1}")
    if any(p.shape != shape or p.device != mag.device for p in planes):
        raise ValueError(f"state planes differ: {[(tuple(p.shape), str(p.device)) for p in planes]}")
    if not supported(n_fft, hop):
        raise ValueError(f"unsupported (n_fft={n_fft}, hop={hop}) for the fused kernel")
    return _iterate(*planes, momentum, designs(n_fft, hop, window, shape[1], mag.device))


def _loop(step, mag, n_fft, hop, window, n_iter, momentum, length, init_phase, precision):
    """``n_iter`` calls of ``step`` (:func:`_iterate` or the plain version),
    then the epilogue, as the JAX wrapper runs its kernel."""
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    if n_iter < 1:
        raise ValueError(f"fused griffin_lim needs n_iter >= 1, got {n_iter}")
    if n_fft % hop or n_fft // hop < 2:
        raise ValueError(f"fused griffin_lim needs hop | n_fft, got {n_fft}/{hop}")
    if not supported(n_fft, hop):
        raise ValueError(
            f"n_fft={n_fft}, hop={hop}: the fused kernel's blocks exceed shared memory; use impl='matmul'"
        )
    if precision not in ("default", "highest"):
        raise ValueError(f"fused griffin_lim supports precision 'default' or 'highest', got {precision!r}")
    if mag.ndim < 2:
        raise ValueError("mag must be [..., F, n_fft//2 + 1]")
    lead, (n_frames, n_bins) = mag.shape[:-2], mag.shape[-2:]
    if n_bins != n_fft // 2 + 1:
        raise ValueError(f"mag has {n_bins} bins; expected {n_fft // 2 + 1}")
    mag = mag.to(torch.float32).reshape(-1, n_frames, n_bins).contiguous()
    d = designs(n_fft, hop, window, n_frames, mag.device)

    # r_{-1} = r_{-2} = mag·e^{iφ}: the first prologue gives spec_0 exactly
    if init_phase is None:
        r_re, r_im = mag, torch.zeros_like(mag)
    else:
        ph = as_tensor(init_phase, mag.device).to(torch.float32).reshape(mag.shape)
        r_re, r_im = (mag * torch.cos(ph)).contiguous(), (mag * torch.sin(ph)).contiguous()
    r_re, r_im = step(r_re, r_im, r_re, r_im, mag, momentum, d)
    # librosa's momentum history starts at prev_0 = 0
    r2_re, r2_im = torch.zeros_like(mag), torch.zeros_like(mag)
    for _ in range(n_iter - 1):
        (r_re, r_im), r2_re, r2_im = step(r_re, r_im, r2_re, r2_im, mag, momentum, d), r_re, r_im

    s_re, s_im = replace_magnitude(r_re, r_im, r2_re, r2_im, mag, momentum)
    y = istft(torch.complex(s_re, s_im), n_fft, hop, window=window, center=True, length=length,
              impl="matmul", precision=precision)
    return y.reshape(*lead, y.shape[-1])


def griffin_lim_fused(
    mag: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    n_iter: int = 32,
    momentum: float = 0.99,
    length: int | None = None,
    init_phase=None,
    precision: str = "default",
) -> torch.Tensor:
    """Griffin-Lim through the fused iteration: ``mag [..., F, n_bins]`` ->
    ``[..., T]``, one launch per iteration for all leading axes, flattened
    into rows. Semantics of ``griffin_lim(impl="matmul", center=True)`` up to
    the edge-frame convention (module docstring)."""
    return _loop(_iterate, mag, n_fft, hop, window, n_iter, momentum, length, init_phase, precision)


def griffin_lim_reference(
    mag: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    n_iter: int = 32,
    momentum: float = 0.99,
    length: int | None = None,
    init_phase=None,
    precision: str = "default",
) -> torch.Tensor:
    """:func:`griffin_lim_fused` with every iteration in plain torch, on any
    device."""
    return _loop(griffin_lim_iteration_reference, mag, n_fft, hop, window, n_iter, momentum, length,
                 init_phase, precision)
