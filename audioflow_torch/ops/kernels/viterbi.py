"""pYIN two-track Viterbi forward pass: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/viterbi.cu``) replaces the Pallas kernel
``audioflow_tpu/ops/pallas/viterbi.py::pyin_viterbi_forward``. Per frame and
track it runs the banded max-plus step of ``2*half+1`` taps (shift, add,
strict-compare select, so that ties keep the lowest offset), then the
voiced/unvoiced merge of ``pitch.py:498-505`` with its strict compares (a tie
between the tracks keeps the voiced source). It records per state the
winning offset, centred (``off - half``, exact in int8 up to 255 taps), and
a flag for an unvoiced source. The Pallas kernel's grid over frames and its
lane rotations are artefacts of VMEM; the CUDA kernel runs each batch row
as a thread-block cluster whose blocks split the bins and trade their edge
messages through distributed shared memory every frame, looping over every
frame inside one launch (see the source's note). :func:`kernel_path` gives
the cluster size the kernel takes for a shape.

:func:`pyin_viterbi_forward` takes tensors on the CPU to the plain version
:func:`pyin_viterbi_forward_reference`, launches the kernel for CUDA
tensors, and raises for anything the kernel does not take. It never falls
back. Leading axes between the frame axis and the bins are flattened into
rows, so any rank is one launch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..sequence import max_plus_band_argmax
from ._build import load
from .melspec import LaunchCount

# shared memory one block may use on Hopper (227 KB of the SM's 256 KB)
_MAX_SMEM = 232_448
# the int8 range of centred offsets: half <= 127
_MAX_KERNEL_TAPS = 255
# mirrors of csrc/viterbi.cu's shape rule, so that supported() and
# kernel_path() need no build; the wrapper checks them against the library
_MAX_CLUSTER = 8  # the portable cluster size
_TARGET_SMS = 132  # the H100's SMs
_PAD = 2  # message slabs padded to a multiple of the bins a thread owns
_TAP_PAD = 4  # taps padded to a multiple of the bins a thread owns times the lanes that split them

COUNT = LaunchCount()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("viterbi")
    lib.viterbi_forward_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    )
    lib.viterbi_forward_launch.restype = ctypes.c_int
    lib.viterbi_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.viterbi_smem_bytes.restype = ctypes.c_longlong
    lib.viterbi_cluster.argtypes = [ctypes.c_int] * 3
    lib.viterbi_cluster.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _lib()


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def smem_bytes(n_bins: int, kernel_len: int, cluster: int = 1) -> int:
    """Dynamic shared memory of one block when a row's ``n_bins`` are split
    over ``cluster`` blocks: both tracks' messages of its bins, double
    buffered, with ``half`` margins each side, and the log-kernel, padded for
    the sliding windows."""
    nb = -(-n_bins // cluster)
    slab = _round_up(nb, _PAD) + _round_up(kernel_len, _TAP_PAD) + _PAD
    return 4 * (_round_up(kernel_len, _TAP_PAD) + 4 * slab)


def kernel_path(batch: int, n_bins: int, kernel_len: int) -> int:
    """The cluster size C the kernel takes: blocks per batch row, chosen by
    shape so that ``batch x C`` blocks fill the card's 132 SMs, at most 8,
    grown until a block's messages fit in shared memory, then cut to the
    blocks that own bins; 0 where none fits."""
    if batch < 1 or n_bins < 1 or kernel_len < 1:
        return 0
    for c in range(min(_MAX_CLUSTER, max(1, _TARGET_SMS // batch)), _MAX_CLUSTER + 1):
        if smem_bytes(n_bins, kernel_len, c) <= _MAX_SMEM:
            return -(-n_bins // -(-n_bins // c))
    return 0


def supported(n_bins: int, kernel_len: int) -> bool:
    """True when the kernel takes this band at any batch: an odd
    ``kernel_len`` up to 255 taps (centred offsets fit int8), ``n_bins >= 1``,
    and a block's messages in shared memory with the row split over 8
    blocks (up to about 110,000 bins). The JAX predicate asks for the first
    two; the bins it takes in practice (a few hundred to a few thousand) all
    fit."""
    return (
        kernel_len % 2 == 1
        and 1 <= kernel_len <= _MAX_KERNEL_TAPS
        and n_bins >= 1
        and smem_bytes(n_bins, kernel_len, _MAX_CLUSTER) <= _MAX_SMEM
    )


def _f32(v) -> torch.Tensor:
    """A float32 scalar tensor: the constants enter the sums as f32, as the
    JAX package's weakly typed Python floats do."""
    return torch.tensor(np.float32(v))


def merge_tracks(bv, av, bu, au, lv, lu, log_stay, log_switch):
    """The voiced/unvoiced merge of one frame (``pitch.py:498-505``),
    literally: from the banded maxima ``bv``/``bu`` and their offsets
    ``av``/``au`` of the voiced and unvoiced messages, and the frame's log
    observations, returns ``(new_v, new_u, off_v, pick_v, off_u, pick_u)``.
    ``pick`` means "source is the unvoiced track"; a tie keeps the voiced."""
    sv, su = bv + log_stay, bu + log_switch
    pick_v = su > sv
    new_v = lv + torch.where(pick_v, su, sv)
    off_v = torch.where(pick_v, au, av)
    sv2, su2 = bv + log_switch, bu + log_stay
    pick_u = su2 > sv2
    new_u = lu + torch.where(pick_u, su2, sv2)
    off_u = torch.where(pick_u, au, av)
    return new_v, new_u, off_v, pick_v, off_u, pick_u


def _rows(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor):
    """Both observation tensors as ``[F, B, N]`` plus the leading shape."""
    if log_obs_v.ndim < 2 or log_obs_v.shape != log_obs_u.shape:
        raise ValueError(
            f"log observations must share an [F, ..., n_bins] shape: "
            f"{tuple(log_obs_v.shape)}, {tuple(log_obs_u.shape)}"
        )
    if log_obs_v.device != log_obs_u.device:
        raise ValueError(f"log observations on {log_obs_v.device} and {log_obs_u.device}")
    if log_obs_v.dtype != torch.float32 or log_obs_u.dtype != torch.float32:
        raise ValueError(f"the forward pass takes float32, got {log_obs_v.dtype}, {log_obs_u.dtype}")
    f, n = log_obs_v.shape[0], log_obs_v.shape[-1]
    if f < 1 or n < 1:
        raise ValueError(f"need at least one frame and one bin, got {tuple(log_obs_v.shape)}")
    lead = log_obs_v.shape[1:-1]
    return log_obs_v.reshape(f, -1, n), log_obs_u.reshape(f, -1, n), lead


def _unflatten(dv, du, off, pick, lead):
    f, n = off.shape[0], off.shape[-1]
    return dv.reshape(*lead, n), du.reshape(*lead, n), off.reshape(f, 2, *lead, n), pick.reshape(f, 2, *lead, n)


def _kernel_taps(log_kernel) -> torch.Tensor:
    """The taps as a float32 tensor (rounded from float64), on the CPU or
    where the given tensor lies."""
    if isinstance(log_kernel, torch.Tensor):
        lk = log_kernel.detach().to(torch.float32)
    else:
        lk = torch.from_numpy(np.asarray(log_kernel, np.float64).astype(np.float32))
    if lk.ndim != 1 or lk.shape[0] % 2 != 1:
        raise ValueError(f"log_kernel must be one odd-length vector, got shape {tuple(lk.shape)}")
    return lk


def pyin_viterbi_forward_reference(log_obs_v, log_obs_u, log_kernel, log_init, log_stay, log_switch):
    """Plain torch, with the contract of :func:`pyin_viterbi_forward`: per
    frame, both tracks' messages ``[2B, N]`` go through the band
    (``max_plus_band_argmax``: pad with -1e30, unfold, add the taps, first
    maximum) and :func:`merge_tracks`."""
    ov, ou, lead = _rows(log_obs_v, log_obs_u)
    lk = _kernel_taps(log_kernel).to(ov.device)
    half = (lk.shape[0] - 1) // 2
    f, b, n = ov.shape
    li, ls, lw = (_f32(v).to(ov.device) for v in (log_init, log_stay, log_switch))
    off = torch.zeros((f, 2, b, n), dtype=torch.int8, device=ov.device)
    pick = torch.zeros_like(off)
    d = torch.cat([ov[0], ou[0]]) + li
    for t in range(1, f):
        best, arg = max_plus_band_argmax(d, lk)
        new_v, new_u, off_v, pick_v, off_u, pick_u = merge_tracks(
            best[:b], arg[:b], best[b:], arg[b:], ov[t], ou[t], ls, lw
        )
        d = torch.cat([new_v, new_u])
        off[t, 0], off[t, 1] = off_v - half, off_u - half
        pick[t, 0], pick[t, 1] = pick_v, pick_u
    return _unflatten(d[:b], d[b:], off, pick, lead)


def _launch(ov, ou, lk, log_init, log_stay, log_switch):
    """The kernel on CUDA ``[F, B, N]`` observations: one launch, counted."""
    f, b, n = ov.shape
    k = lk.shape[0]
    if not supported(n, k):
        raise ValueError(f"unsupported band for the kernel: n_bins={n}, kernel_len={k}")
    if f * 2 * b * n >= 2**31:
        raise ValueError(f"{f} frames x {b} rows x {n} bins is too large for one call")
    lib = _lib()
    c = kernel_path(b, n, k)
    got = (lib.viterbi_cluster(b, n, k), lib.viterbi_smem_bytes(b, n, k))
    if got != (c, smem_bytes(n, k, c)):
        raise RuntimeError(
            f"kernel_path()/smem_bytes() are out of date with viterbi.cu: {(c, smem_bytes(n, k, c))} vs {got}"
        )
    ov, ou = ov.contiguous(), ou.contiguous()
    lk = lk.to(ov.device)
    dv = torch.empty((b, n), dtype=torch.float32, device=ov.device)
    du = torch.empty_like(dv)
    off = torch.empty((f, 2, b, n), dtype=torch.int8, device=ov.device)
    pick = torch.empty_like(off)
    with torch.cuda.device(ov.device):
        err = lib.viterbi_forward_launch(
            ov.data_ptr(), ou.data_ptr(), lk.data_ptr(), dv.data_ptr(), du.data_ptr(), off.data_ptr(),
            pick.data_ptr(), f, b, n, k, float(np.float32(log_init)), float(np.float32(log_stay)),
            float(np.float32(log_switch)), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: cudaError {err}")
    COUNT.launches += 1
    return dv, du, off, pick


def pyin_viterbi_forward(
    log_obs_v: torch.Tensor,
    log_obs_u: torch.Tensor,
    log_kernel,
    log_init: float,
    log_stay: float,
    log_switch: float,
):
    """The fused forward pass. ``log_obs_v/u`` are float32 ``[F, ..., n_bins]``;
    ``log_kernel`` holds the ``2*half+1`` log-transition taps (rounded to
    float32), the three scalars are rounded to float32. Returns ``(dv, du,
    off, pick)``: the final messages ``[..., n_bins]`` each, and per frame
    the backpointers ``off`` (the centred offset, true offset minus half)
    and ``pick`` (source is the unvoiced track), int8 ``[F, 2, ...,
    n_bins]`` with track 0 voiced, 1 unvoiced; row 0 is the initial step,
    all zeros. One launch on CUDA tensors; the plain version on the CPU."""
    ov, ou, lead = _rows(log_obs_v, log_obs_u)
    if ov.device.type == "cpu":
        return pyin_viterbi_forward_reference(log_obs_v, log_obs_u, log_kernel, log_init, log_stay, log_switch)
    if ov.device.type != "cuda":
        raise ValueError(f"pyin_viterbi_forward runs on cpu or cuda tensors, not {ov.device.type}")
    return _unflatten(*_launch(ov, ou, _kernel_taps(log_kernel), log_init, log_stay, log_switch), lead)
