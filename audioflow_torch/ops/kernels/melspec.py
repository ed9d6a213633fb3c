"""Fused log-mel spectrogram: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/melspec.cu``) replaces the Pallas kernel
``audioflow_tpu/ops/pallas/melspec.py::mel_spectrogram_pallas``. It computes
``log(max(fbᵀ·|DFT_w(frame)|², floor))`` over center=False frames of a
signal without writing the frames or the power spectrum to device memory.
The Pallas kernel's 64-frame x 8-row tiling and its overlapped tile tensor
are TPU artefacts and are not carried over; see the source's note for the
CUDA design. The kernel has two paths behind one launch, chosen by shape
(:func:`kernel_path`): a shared-memory FFT (``csrc/fft.cuh``) for a
power-of-two n_fft from 16 to 2048, dense DFT products against the banks for
any other. Both project the power spectrum onto the filterbank's nonzero
bands only (:func:`mel_bands`).

The FFT path works in staged runs: a run is consecutive frames of one row,
whose span of samples a block copies once into shared memory (16 bytes a
copy, at any row alignment) while it transforms the previous run, a warp
taking each frame from window to log. What bounds it is the SM's issue and
shared-memory pipe and the warps that hide their latency, not the bytes it
moves; :func:`fft_plan` mirrors the run length, staging width, runs a step
and warps a block that the library picks from n_fft, hop and the row
length, and the wrapper checks the mirror once a shape.

A :class:`MelSpec` is the kernel prepared once for one set of designs on one
device: the band layout, the twiddles and the path resolved, the pointers
packed. Each row the kernel reads is ``[carry | chunk]``, the two segments
read in place by their own pointers and row strides, and it writes the new
carry (the row's last ``carry.shape[-1]`` samples) into a fresh tensor:
:meth:`MelSpec.step` is a stream step in one launch, with no
concatenation. The offline call (:meth:`MelSpec.__call__`,
:func:`mel_spectrogram`) is the same launch with a carry of length 0.

On the CPU or the meta device every call is the plain version
(:func:`mel_spectrogram_reference`, the stream step over the concatenation);
for a CUDA tensor it launches the kernel, and raises for anything the kernel
does not take. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ...utils.cache import BoundedCache, on_device
from ..framing import frame, num_frames
from ..mel import floor_log
from . import fft
from ._build import _MAX_SMEM, LaunchCount, _row_stride, _rows, check_mirror, launch, load

LOG_MODES = {None: 0, "none": 0, "ln": 1, "log10": 2, "db": 3}

# mirrors of melspec.cu's constants, so that the path and the FFT path's
# plan need no build; the wrapper checks the mirrors against the library
_FRAMES = 16  # frames of a dense-path block
_MAX_WARPS = 10  # warps of an FFT-path block, at most
_STEP_FRAMES = 8  # frames a step holds at least, where runs are shorter
_STAGE_FLOATS = 6144  # a run's staging slot, at most

# band layouts on the device, keyed by the filterbank tensor they were read from
_BANDS = BoundedCache(maxsize=16)
# prepared launches of mel_spectrogram, keyed by its designs' identities
_PREPARED = BoundedCache(maxsize=16)


@dataclass
class MelspecCount(LaunchCount):
    """:class:`LaunchCount`, and of those launches the ones that read a carry
    in place (a stream step's) and the ones that took the FFT path's staged
    runs (every FFT-path launch: the design keeps no narrower form)."""

    carry_launches: int = 0
    staged_launches: int = 0


COUNT = MelspecCount()


class _Params(ctypes.Structure):
    """Mirror of melspec.cu's ``MelspecParams``: a design set on a device and its sizes."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("window", "tw", "cosb", "sinb", "bands", "wts")] + [
        (name, ctypes.c_int) for name in ("n_fft", "hop", "n_bins", "n_mels", "max_band", "log_mode")
    ] + [("floor", ctypes.c_float)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("melspec")
    lib.melspec_launch.argtypes = [
        ctypes.POINTER(_Params), ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.melspec_launch.restype = ctypes.c_int
    lib.melspec_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.melspec_smem_bytes.restype = ctypes.c_longlong
    lib.melspec_path.argtypes = [ctypes.c_int]
    lib.melspec_path.restype = ctypes.c_int
    lib.melspec_fft_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.melspec_fft_plan.restype = ctypes.c_longlong
    lib.melspec_params_bytes.argtypes = []
    lib.melspec_params_bytes.restype = ctypes.c_int
    check_mirror("melspec", ("_Params bytes",), ctypes.sizeof(_Params), lib.melspec_params_bytes)
    return lib


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _lib()


def kernel_path(n_fft: int) -> str:
    """The path the kernel takes, chosen by shape: ``"fft"`` for a
    power-of-two n_fft from 16 to 2048 (any hop), ``"dense"`` for any other."""
    return "fft" if fft.is_fft_size(n_fft) else "dense"


def dense_smem_bytes(n_fft: int) -> int:
    """Dynamic shared memory of one dense-path block."""
    return 4 * _FRAMES * (((n_fft + 3) & ~3) + n_fft // 2 + 1)


class FftPlan(NamedTuple):
    """The FFT path's launch parameters for one shape (melspec.cu's
    ``FftPlan``): ``frames`` a run (consecutive frames of one row, staged
    once), ``runs_row`` runs a row, ``group`` runs a step (staged together,
    one block barrier a step), ``warps`` a block, ``stage`` floats of a
    run's staging slot, ``wts_smem`` 1 where the band weights are staged in
    shared memory (in quads of 4 from each band's 4-float boundary), and
    ``smem`` bytes of shared memory a block."""

    frames: int
    runs_row: int
    group: int
    warps: int
    stage: int
    wts_smem: int
    smem: int


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _pass_twiddles(log_m: int) -> int:
    """float2 entries of the tables of the FFT passes after the first."""
    total, ns = 0, 0
    while ns < log_m:
        lr = min(4, log_m - ns)
        if ns:
            total += ((1 << lr) - 1) << ns
        ns += lr
    return total


def _layout_floats(m: int, n_mels: int, max_band: int, wts_smem: int, warps: int, group: int, stage: int) -> int:
    """Floats of an FFT-path block's shared memory: the window, the real
    split's and the passes' twiddles, the band table, the weights where
    staged, a frame slot a warp and two step buffers."""
    slot = _round4(2 * (m + (m >> 5)))
    tables = 2 * m + _round4(2 * (m // 2 + 1)) + _round4(2 * _pass_twiddles(m.bit_length() - 1)) + _round4(3 * n_mels)
    return tables + (4 * ((max_band + 6) // 4) * n_mels if wts_smem else 0) + warps * slot + 2 * group * stage


@functools.lru_cache(maxsize=256)
def fft_plan(n_fft: int, hop: int, t: int, c: int, n_mels: int, max_band: int) -> FftPlan:
    """Mirror of melspec.cu's ``fft_plan`` for rows of ``t`` samples, ``c``
    of them carried: the longest run whose span fits the staging slot, the
    runs of a row balanced; one frame a run where frames do not overlap
    (hop >= n_fft), so that no gap is staged; several runs a step where
    runs are shorter than 8 frames; a warp a frame of the step, up to 10
    (then as many frames a warp as that takes, spread evenly); the weights
    staged where they fit (``max_band``: the filterbank's longest band)."""
    m = n_fft // 2
    nf = (t - n_fft) // hop + 1
    if hop >= n_fft:
        frames = 1
    else:
        cap = min(nf, (_STAGE_FLOATS - 4 - n_fft) // hop + 1)
        runs = -(-nf // cap)
        frames = -(-nf // runs)
    runs_row = -(-nf // frames)
    span = (frames - 1) * hop + n_fft
    tail = min(t - ((nf - 1) * hop + n_fft), _STAGE_FLOATS - 4 - span) if c > 0 else 0
    stage = _round4(span + tail + 3)
    group = max(1, min(-(-_STEP_FRAMES // frames), _STAGE_FLOATS // stage))
    fs = group * frames
    per_warp = -(-fs // _MAX_WARPS)
    want = -(-fs // per_warp)
    slot = _round4(2 * (m + (m >> 5)))
    room = _MAX_SMEM // 4 - _layout_floats(m, n_mels, max_band, 1, 0, group, stage)
    wts_smem = int(room >= slot)
    if not wts_smem:
        room = _MAX_SMEM // 4 - _layout_floats(m, n_mels, max_band, 0, 0, group, stage)
    warps = max(1, min(want, int(room / slot)))  # C's division: toward zero
    return FftPlan(frames, runs_row, group, warps, stage, wts_smem,
                   4 * _layout_floats(m, n_mels, max_band, wts_smem, warps, group, stage))


def mel_bands(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The banded layout of a filterbank ``[n_bins, n_mels]``: int32
    ``[3, n_mels]`` of each column's first nonzero bin, its count of bins up
    to its last nonzero one (0 for an empty column) and the offset of its
    weights, and the float32 weights packed column after column. Only exact
    zeros outside each column's first-to-last range are left out."""
    fb = np.asarray(fb, np.float32)
    n_mels = fb.shape[1]
    layout = np.zeros((3, n_mels), np.int32)
    packed = []
    offset = 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m] != 0)
        if nz.size:
            lo, count = int(nz[0]), int(nz[-1] - nz[0] + 1)
            layout[:, m] = lo, count, offset
            packed.append(fb[lo : lo + count, m])
            offset += count
        else:
            layout[2, m] = offset
    wts = np.concatenate(packed) if packed else np.zeros(1, np.float32)
    return layout, wts.astype(np.float32)


def _device_bands(fb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`mel_bands` of a filterbank tensor, on its device, and its
    longest band's count: read back and laid out once per tensor and
    version (an in-place edit makes a new layout). The entry holds the
    tensor, so its address is not reused while the entry lives."""
    key = (fb.data_ptr(), str(fb.device), tuple(fb.shape), fb.stride(), fb._version)
    hit = _BANDS.get(key)
    if hit is None:
        layout, wts = mel_bands(fb.detach().cpu().numpy())
        hit = (fb, torch.from_numpy(layout).to(fb.device), torch.from_numpy(wts).to(fb.device), int(layout[1].max()))
        _BANDS[key] = hit
    return hit[1:]


def mel_spectrogram_reference(
    x: torch.Tensor,
    cosb: torch.Tensor,
    sinb: torch.Tensor,
    fb: torch.Tensor,
    hop: int,
    log: str | None = "ln",
    floor: float = 1e-10,
) -> torch.Tensor:
    """Plain torch version: ``log_mel(spectrogram(x, center=False), fb)``
    with the given banks; ``[..., T]`` -> ``[..., frames, n_mels]``."""
    frames = frame(x, cosb.shape[0], hop)
    re = torch.matmul(frames, cosb)
    im = torch.matmul(frames, sinb)
    return floor_log(torch.matmul(re * re + im * im, fb), floor, log)


def _check_designs(cosb, sinb, window, fb, hop, log):
    if log not in LOG_MODES:
        raise ValueError(f"unknown log {log!r}; known: {sorted(map(str, LOG_MODES))}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if cosb.ndim != 2 or sinb.shape != cosb.shape:
        raise ValueError(f"cos/sin banks must share a [n_fft, n_bins] shape: {cosb.shape}, {sinb.shape}")
    if tuple(window.shape) != (cosb.shape[0],):
        raise ValueError(f"window {tuple(window.shape)} does not take n_fft {cosb.shape[0]}")
    if fb.ndim != 2 or fb.shape[0] != cosb.shape[1]:
        raise ValueError(f"filterbank {tuple(fb.shape)} does not take {cosb.shape[1]} bins")
    for name, t in (("sin bank", sinb), ("window", window), ("filterbank", fb)):
        if t.device != cosb.device:
            raise ValueError(f"{name} is on {t.device}, the cos bank on {cosb.device}")


class MelSpec:
    """The kernel prepared for one set of designs on one device.

    ``cosb``/``sinb`` ``[n_fft, n_bins]`` are the window-folded DFT banks
    (``ops.stft.dft_banks``) of the dense path and the plain version,
    ``window [n_fft]`` the same analysis window unfolded
    (``ops.stft.padded_window`` as float32) for the FFT path, ``fb [n_bins,
    n_mels]`` the mel filterbank. ``log`` is "ln", "log10", "db" or None
    (floored linear mel). On a CUDA device everything that depends on the
    designs alone is resolved here, once: a call checks its signal, allocates
    its outputs and launches on the current stream.
    """

    def __init__(self, cosb, sinb, window, fb, hop: int, log: str | None = "ln", floor: float = 1e-10):
        _check_designs(cosb, sinb, window, fb, hop, log)
        self.designs = (cosb, sinb, window, fb)
        self.hop, self.log, self.floor = hop, log, floor
        self.n_fft, self.n_mels = cosb.shape[0], fb.shape[1]
        self.device = cosb.device
        self._params = None
        self._planned = None  # the (t, c) whose FFT-path plan was last checked
        if self.device.type in ("cpu", "meta"):  # meta tensors carry shapes only
            return
        if self.device.type != "cuda":
            raise ValueError(f"the melspec kernel runs on cpu or cuda tensors, not {self.device.type}")
        if any(t.dtype != torch.float32 for t in self.designs):
            raise ValueError(f"the kernel takes float32, got {[t.dtype for t in self.designs]}")
        if not all(t.is_contiguous() for t in self.designs):
            raise ValueError("the kernel takes contiguous designs")
        n_bins = cosb.shape[1]
        lib = _lib()
        self.path = kernel_path(self.n_fft)
        if self.path == "dense":
            smem = dense_smem_bytes(self.n_fft)
            check_mirror("melspec", (self.n_fft, n_bins), (0, smem),
                         lambda: (lib.melspec_path(self.n_fft), lib.melspec_smem_bytes(self.n_fft, n_bins)))
            if smem > _MAX_SMEM:
                raise ValueError(f"n_fft {self.n_fft} needs {smem} B of shared memory per block, over {_MAX_SMEM}")
        tw = on_device(fft.twiddles(self.n_fft), self.device) if self.path == "fft" else None
        bands, wts, self.max_band = _device_bands(fb)
        self._keep = (tw, bands, wts)  # alive as long as the pointers
        self._params = _Params(
            window.data_ptr(), None if tw is None else tw.data_ptr(), cosb.data_ptr(), sinb.data_ptr(),
            bands.data_ptr(), wts.data_ptr(), self.n_fft, hop, n_bins, self.n_mels, self.max_band, LOG_MODES[log],
            floor,
        )

    def _reference(self, x):
        if x.shape[-1] < self.n_fft:
            raise ValueError(f"signal length {x.shape[-1]} shorter than n_fft {self.n_fft}")
        cosb, sinb, _, fb = self.designs
        return mel_spectrogram_reference(x, cosb, sinb, fb, self.hop, self.log, self.floor)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(log-)mel spectrogram ``[..., frames, n_mels]`` of ``x [..., T]``:
        the launch with a carry of length 0. On the card ``x``'s rows may lie
        at any one stride; a layout without one is refused."""
        if self._params is None:
            if x.device != self.device:
                raise ValueError(f"the signal is on {x.device}, the designs on {self.device}")
            return self._reference(x)
        row = _row_stride(x)
        if row is None:
            raise ValueError("the kernel takes a signal whose rows lie at one stride (contiguous samples)")
        return self._launch(x[..., :0], 0, x, row)[1]

    def step(self, carry: torch.Tensor, chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One stream step: ``carry [..., C]`` and ``chunk [..., n]`` ->
        (new carry, frames), the new carry ``[..., C]`` the last C samples of
        ``[carry | chunk]`` and the frames ``[..., frames, n_mels]`` its
        (log-)mel spectrogram. On the card one launch reads both where they
        lie and writes the new carry into a fresh tensor, never a view of
        either."""
        if carry.shape[:-1] != chunk.shape[:-1]:
            raise ValueError(f"carry {tuple(carry.shape)} and chunk {tuple(chunk.shape)} differ in their lead axes")
        if self._params is None:
            buf = torch.cat([carry, chunk], dim=-1)
            return buf[..., buf.shape[-1] - carry.shape[-1] :], self(buf)
        chunk, chunk_row = _rows(chunk)
        carry, carry_row = _rows(carry)
        return self._launch(carry, carry_row, chunk, chunk_row)

    def _launch(self, carry, carry_row, chunk, chunk_row):
        device = self.device
        if chunk.device != device or carry.device != device:
            raise ValueError(f"the signal is on {chunk.device} and {carry.device}, the designs on {device}")
        if chunk.dtype != torch.float32 or carry.dtype != torch.float32:
            raise ValueError(f"the kernel takes float32, got {chunk.dtype} and {carry.dtype}")
        lead, n, c = chunk.shape[:-1], chunk.shape[-1], carry.shape[-1]
        t = c + n
        if t < self.n_fft:
            raise ValueError(f"signal length {t} shorter than n_fft {self.n_fft}")
        rows = lead.numel()
        if max(rows, t) >= 2**31:
            raise ValueError(f"{rows} rows of {t} samples: each must be below 2**31")
        if self.path == "fft" and (t, c) != self._planned:
            self._check_plan(t, c)
            self._planned = (t, c)
        n_frames = num_frames(t, self.n_fft, self.hop)
        out = torch.empty((*lead, n_frames, self.n_mels), dtype=torch.float32, device=device)
        new_carry = torch.empty((*lead, c), dtype=torch.float32, device=device) if c else carry[..., :0]
        launch("melspec", COUNT, _lib().melspec_launch, device, self._params, carry.data_ptr(), carry_row, c,
               chunk.data_ptr(), chunk_row, n, out.data_ptr(), new_carry.data_ptr(), rows)
        if c:
            COUNT.carry_launches += 1
        if self.path == "fft":
            COUNT.staged_launches += 1
        return new_carry, out

    def _check_plan(self, t: int, c: int) -> None:
        """Raise where the FFT path's plan for rows of ``t`` samples (``c``
        carried) needs more shared memory than a block has, or where the
        library's plan differs from :func:`fft_plan` (asked once a shape)."""
        shape = (self.n_fft, self.hop, t, c, self.n_mels, self.max_band)
        plan = fft_plan(*shape)

        def library():
            fields = (ctypes.c_int * 6)()
            smem = _lib().melspec_fft_plan(*shape, fields)
            return FftPlan(*fields, smem)

        check_mirror("melspec", shape, plan, library)
        if plan.smem > _MAX_SMEM:
            raise ValueError(f"n_fft {self.n_fft} at {t} samples needs {plan.smem} B of shared memory per block, "
                             f"over {_MAX_SMEM}")


def prepare(cosb, sinb, window, fb, hop: int, log: str | None = "ln", floor: float = 1e-10) -> MelSpec:
    """The :class:`MelSpec` of these designs, made once per set of tensors
    (and filterbank version: an in-place edit prepares anew). The entry
    holds the tensors, so their ids are not reused while it lives."""
    key = (id(cosb), id(sinb), id(window), id(fb), fb._version, hop, log, floor)
    hit = _PREPARED.get(key)
    if hit is None:
        hit = MelSpec(cosb, sinb, window, fb, hop, log, floor)
        _PREPARED[key] = hit
    return hit


def mel_spectrogram(
    x: torch.Tensor,
    cosb: torch.Tensor,
    sinb: torch.Tensor,
    window: torch.Tensor,
    fb: torch.Tensor,
    hop: int,
    log: str | None = "ln",
    floor: float = 1e-10,
) -> torch.Tensor:
    """(log-)mel spectrogram ``[..., frames, n_mels]`` of ``x [..., T]``:
    :class:`MelSpec` of the designs (see there), called on ``x``."""
    return prepare(cosb, sinb, window, fb, hop, log, floor)(x)
