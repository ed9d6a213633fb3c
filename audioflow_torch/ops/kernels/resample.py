"""The streaming resampler's step: the CUDA kernel's wrapper and its tables.

The kernel (``csrc/resample.cu``) computes one step of a
:class:`~audioflow_torch.ops.resample.StreamResamplePlan` in one launch: the
polyphase FIR over the carry's ``hist`` samples and the chunk, read from
their own pointers (the chunk at any row stride), and the new carry. It
replaces no TPU kernel: the JAX package leaves the band to XLA, and the
plain version (:func:`~audioflow_torch.ops.resample.resample_stream_step_reference`)
concatenates, pads and multiplies the dense ``[ipb + K, G]`` band, most of
whose entries are zeros. See the source's note for the design.

The tables come from the plan alone, so one algorithm serves every rate pair
and mode: :func:`stream_tables` reads each output column's phase, offset and
taps out of the plan's band, and :func:`kernel_tables` shifts and pads them
into the kernel's groups of eight outputs.

:func:`resample_stream_step` takes a tensor on the CPU or the meta device to
the plain version, launches the kernel for a CUDA tensor, and raises for
anything the kernel does not take. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...utils import cdiv
from ...utils.cache import BoundedCache
from .._mm import check_precision
from ._build import LaunchCount, _rows, check_mirror, launch, load

# outputs of a group, mirror of resample.cu's kJ
GROUP = 8

COUNT = LaunchCount()

# launch parameters by plan and device; entries hold the plan, so its id is
# not reused while they live
_PARAMS = BoundedCache(maxsize=64)


class _Params(ctypes.Structure):
    """Mirror of resample.cu's ``ResampleParams``: a plan's tables on a device and its sizes."""

    _fields_ = [("ct", ctypes.c_void_p), ("qbase", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in ("chunk_in", "hist", "ipb", "g", "n_groups", "span", "window", "n_blocks")
    ]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("resample")
    lib.resample_launch.argtypes = [
        ctypes.POINTER(_Params), ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.resample_launch.restype = ctypes.c_int
    lib.resample_path.argtypes = [ctypes.c_int]
    lib.resample_path.restype = ctypes.c_int
    lib.resample_params_bytes.argtypes = []
    lib.resample_params_bytes.restype = ctypes.c_int
    check_mirror("resample", ("_Params bytes",), ctypes.sizeof(_Params), lib.resample_params_bytes)
    return lib


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _lib()


def stream_tables(plan) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plan's band as per-column tables: int64 ``phase [G]`` and
    ``base [G]`` (output g of every block reads ``bank[phase[g]]`` against
    the block's inputs from ``base[g]`` on) and the float32 ``bank [L, K]``,
    read out of ``plan.matrix``, so that its entries are the band's own."""
    up, down, g, k = plan.up, plan.down, plan.block_out, plan.k_taps
    n = plan.n0 + np.arange(g, dtype=np.int64)
    phase = (n * down) % up
    base = (n * down) // up - (plan.n0 * down) // up
    bank = np.zeros((up, k), np.float32)
    bank[phase] = plan.matrix[base[:, None] + np.arange(k), np.arange(g)[:, None]]
    return phase, base, bank


@dataclass(frozen=True)
class KernelTables:
    """:func:`stream_tables` in the kernel's layout: outputs in groups of
    :data:`GROUP`; group q's inputs start at ``qbase[q]`` (the base of its
    first output) and output j of the group reads ``ct[s, j // 4, q, j % 4]``
    against input ``qbase[q] + s`` for s < ``span``: each output's taps
    shifted to its group's start and padded with zeros."""

    ct: np.ndarray  # [span, 2, n_groups, 4] float32
    qbase: np.ndarray  # [n_groups] int32
    span: int

    @property
    def n_groups(self) -> int:
        return self.qbase.shape[0]

    @property
    def window(self) -> int:
        """Inputs one block of G outputs reads, from its first on."""
        return int(self.qbase[-1]) + self.span


def kernel_tables(plan) -> KernelTables:
    phase, base, bank = stream_tables(plan)
    g, k = plan.block_out, plan.k_taps
    n_groups = cdiv(g, GROUP)
    qbase = base[:: GROUP]
    cols = np.arange(g)
    shift = base - qbase[cols // GROUP]
    span = int(shift.max()) + k
    ct = np.zeros((span, n_groups * GROUP), np.float32)
    ct[shift[:, None] + np.arange(k), cols[:, None]] = bank[phase]
    ct = ct.reshape(span, n_groups, 2, 4).transpose(0, 2, 1, 3)
    return KernelTables(np.ascontiguousarray(ct), qbase.astype(np.int32), span)


def _params(plan, device: torch.device) -> _Params:
    """The plan's launch parameters on a CUDA ``device``: its tables
    uploaded once per plan and device."""
    key = (id(plan), device.index)
    hit = _PARAMS.get(key)
    if hit is None or hit[0] is not plan:
        t = kernel_tables(plan)
        ct, qbase = torch.from_numpy(t.ct).to(device), torch.from_numpy(t.qbase).to(device)
        params = _Params(ct.data_ptr(), qbase.data_ptr(), plan.chunk_in, plan.hist, plan.ipb, plan.block_out,
                         t.n_groups, t.span, t.window, plan.n_out_chunk // plan.block_out)
        hit = (plan, params, ct, qbase)  # the tensors stay alive with the pointers
        _PARAMS[key] = hit
    return hit[1]


def resample_stream_step(
    plan, carry: torch.Tensor, chunk: torch.Tensor, precision: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One streaming step of ``plan``: ``chunk [..., chunk_in]`` and the
    carry ``[..., hist]`` -> (new carry, ``[..., n_out_chunk]``).

    On the CPU or the meta device the plain version; on a CUDA tensor one
    launch of the kernel, in float32. ``precision`` takes the JAX package's
    names for parity; the kernel computes in fp32 whatever it says.
    """
    device = chunk.device
    if device.type in ("cpu", "meta"):  # meta tensors carry shapes only
        from ..resample import resample_stream_step_reference

        return resample_stream_step_reference(plan, carry, chunk, precision)
    check_precision(precision)
    if device.type != "cuda":
        raise ValueError(f"resample_stream_step runs on cpu or cuda tensors, not {device.type}")
    if chunk.ndim == 0 or chunk.shape[-1] != plan.chunk_in:
        raise ValueError(f"chunk shape {tuple(chunk.shape)} does not end in the plan's chunk_in {plan.chunk_in}")
    lead = chunk.shape[:-1]
    if carry.shape != (*lead, plan.hist):
        raise ValueError(f"carry {tuple(carry.shape)} is not {(*lead, plan.hist)}")
    if carry.device != device:
        raise ValueError(f"carry is on {carry.device}, the chunk on {device}")
    if chunk.dtype != torch.float32 or carry.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32, got {chunk.dtype} and {carry.dtype}")
    rows = chunk.numel() // plan.chunk_in
    if rows >= 2**31:
        raise ValueError(f"{rows} rows are too many for one call")
    chunk, chunk_row = _rows(chunk)
    carry, carry_row = _rows(carry)
    params = _params(plan, device)
    y = torch.empty((*lead, plan.n_out_chunk), dtype=torch.float32, device=device)
    new_carry = torch.empty((*lead, plan.hist), dtype=torch.float32, device=device) if plan.hist else carry
    vec_in = chunk.data_ptr() % 16 == 0 and (rows == 1 or chunk_row % 4 == 0)
    launch("resample", COUNT, _lib().resample_launch, device, params, chunk.data_ptr(), chunk_row, carry.data_ptr(),
           carry_row, y.data_ptr(), new_carry.data_ptr(), rows, vec_in)
    return new_carry, y


def kernel_path(plan) -> str:
    """The path the kernel takes for ``plan``: ``"tile"`` where a block's
    window fits shared memory, ``"generic"`` where it does not."""
    return "tile" if _lib().resample_path(kernel_tables(plan).window) else "generic"
