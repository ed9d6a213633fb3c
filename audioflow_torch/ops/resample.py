"""Sample-rate conversion as a banded matmul.

A rational resampler (up=L, down=M) is a polyphase filter bank; a block of
``G`` consecutive outputs (G a multiple of L) consumes exactly
``ipb = G*M/L`` inputs, so the whole resample is ``frame(x, ipb+K, ipb) @ W``
with ``W [ipb + K, G]`` a banded matrix of phase weights. The filter designs
and plans below are host-side float64 numpy, copied bit for bit from
``audioflow_tpu/ops/resample.py`` so that the two packages use identical
coefficients.

The offline resampler (:func:`resample_apply`) multiplies the band with
plain ``torch.matmul`` (cuBLAS on the card) over shifted reshapes of the
signal, as the JAX package leaves it to XLA. The streaming step
(:func:`resample_stream_step`) is one launch of a hand-written polyphase
kernel on a CUDA tensor (:mod:`.kernels.resample`), which reads only the
band's nonzero taps; on the CPU it is the same banded matmul
(:func:`resample_stream_step_reference`).

Passthrough when rates match.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..utils import cdiv, rational_rate
from ..utils.cache import on_device
from ._mm import mm

# --------------------------------------------------------------------------
# filter design (host-side, float64)
# --------------------------------------------------------------------------

def kaiser_sinc_bank(up: int, down: int, half_width: int = 16, beta: float = 8.555) -> np.ndarray:
    """Windowed-sinc polyphase bank ``[up, K]``.

    ``half_width`` is scaled by ``ceil(down/up)`` when decimating so the
    anti-alias lowpass keeps ~2*half_width taps per *output* period — a
    fixed-length prototype would be far too short for strong decimation
    (e.g. 96k->16k). Effective K = 2*half_width*ceil(down/up) + 1; the
    prototype has odd length ``N = (K-1)*up + 1`` at the upsampled rate,
    cutoff ``1/max(up, down)`` (normalized), gain ``up`` to compensate
    zero-stuffing. bank[p, t] = h_full[(K-1-t)*up + p], so
    ``y[n] = sum_t bank[p, t] * x[n*down//up - (K-1)//2 + t]``.
    """
    half_eff = half_width * max(1, cdiv(down, up))
    n_total = 2 * half_eff * up + 1
    c = half_eff * up  # (N-1)/2, exactly divisible by up
    fc = 1.0 / max(up, down)
    k = np.arange(n_total, dtype=np.float64) - c
    h = up * fc * np.sinc(fc * k) * np.kaiser(n_total, beta)
    k_taps = 2 * half_eff + 1
    h_pad = np.zeros(k_taps * up, dtype=np.float64)
    h_pad[:n_total] = h
    bank = np.zeros((up, k_taps), dtype=np.float64)
    for p in range(up):
        for t in range(k_taps):
            idx = (k_taps - 1 - t) * up + p
            if idx < n_total:
                bank[p, t] = h_pad[idx]
    return bank


def cubic_lagrange_bank(up: int) -> np.ndarray:
    """4-tap cubic-Lagrange bank ``[up, 4]`` for fractions p/up.

    Identical polynomial to rubato's ``interp_cubic`` (Lagrange cubic through
    4 uniform points evaluated between the middle two):
      a0=y1; a1=-y0/3 - y1/2 + y2 - y3/6; a2=(y0+y2)/2 - y1;
      a3=(y1-y2)/2 + (y3-y0)/6;  y = ((a3*f + a2)*f + a1)*f + a0.
    Offset convention: ``y[n] = sum_t bank[p, t] * x[n*down//up - 1 + t]``.
    """
    f = np.arange(up, dtype=np.float64)[:, None] / up
    y0 = -f / 3.0 + f * f / 2.0 - f**3 / 6.0
    y1 = 1.0 - f / 2.0 - f * f + f**3 / 2.0
    y2 = f + f * f / 2.0 - f**3 / 2.0
    y3 = -f / 6.0 + f**3 / 6.0
    return np.concatenate([y0, y1, y2, y3], axis=1)


def linear_bank(up: int) -> np.ndarray:
    """2-tap linear interpolation bank (rubato PolynomialDegree::Linear analog)."""
    f = np.arange(up, dtype=np.float64)[:, None] / up
    return np.concatenate([1.0 - f, f], axis=1)


def _kaiser_entry(up, down, **kw):
    bank = kaiser_sinc_bank(up, down, **kw)
    return bank, -((bank.shape[1] - 1) // 2)


_BANKS = {
    "kaiser": _kaiser_entry,
    "cubic": lambda L, M, **kw: (cubic_lagrange_bank(L), -1),
    "linear": lambda L, M, **kw: (linear_bank(L), 0),
}


# --------------------------------------------------------------------------
# block-matmul machinery
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ResamplePlan:
    """Static compilation plan for one (rate pair, mode) resampler."""

    up: int
    down: int
    offset: int  # window anchor relative to n*down//up
    block_out: int  # G: outputs per block (multiple of up)
    ipb: int  # inputs per block = G*down/up
    k_taps: int
    matrix: np.ndarray  # [ipb + k_taps, G] float32 banded weights

    @property
    def lookahead(self) -> int:
        """Future input samples needed per output (streaming delay)."""
        return self.offset + self.k_taps - 1

    @property
    def history(self) -> int:
        """Past input samples needed (streaming carry length)."""
        return max(0, -self.offset)


def _block_matrix(bank: np.ndarray, up: int, down: int, g: int, n_shift: int = 0) -> np.ndarray:
    """Banded weight matrix for a block of ``g`` outputs starting at absolute
    output index ``n_shift`` (mod up); rows are window positions relative to
    the block's first window start."""
    k_taps = bank.shape[1]
    q0 = ((n_shift) * down) // up
    width = ((n_shift + g - 1) * down) // up - q0 + k_taps
    w = np.zeros((width, g), dtype=np.float64)
    for gg in range(g):
        n = n_shift + gg
        p = (n * down) % up
        base = (n * down) // up - q0
        w[base : base + k_taps, gg] = bank[p]
    return w.astype(np.float32)


@lru_cache(maxsize=64)
def make_plan(
    input_rate: int,
    output_rate: int,
    mode: str = "kaiser",
    min_block_out: int = 128,
    half_width: int = 16,
    beta: float = 8.555,
) -> ResamplePlan:
    L, M = rational_rate(input_rate, output_rate)
    kw = {"half_width": half_width, "beta": beta} if mode == "kaiser" else {}
    try:
        bank, offset = _BANKS[mode](L, M, **kw)
    except KeyError:
        raise ValueError(f"unknown resample mode {mode!r}; known: {sorted(_BANKS)}") from None
    k_taps = bank.shape[1]
    g = max(L, cdiv(min_block_out, L) * L)
    ipb = g * M // L
    w = _block_matrix(bank, L, M, g)
    assert w.shape[0] <= ipb + k_taps
    if w.shape[0] < ipb + k_taps:
        w = np.pad(w, ((0, ipb + k_taps - w.shape[0]), (0, 0)))
    return ResamplePlan(L, M, offset, g, ipb, k_taps, w)


# --------------------------------------------------------------------------
# streaming (fixed-shape chunk steps with carried history)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class StreamResamplePlan:
    """Static plan for chunked streaming resampling.

    Chunk k (input samples ``[k*chunk_in, (k+1)*chunk_in)``) emits the fixed
    count ``n_out_chunk = chunk_in*up/down`` of consecutive outputs, offset by
    the (negative) constant ``n0``: the m-th output overall is offline output
    ``n0 + m`` of the zero-prehistory stream. Concatenated streaming output
    with the first ``-n0`` samples dropped equals the offline resampler
    exactly (verified in tests). Carry = last ``hist`` input samples.

    This is the TPU analog of the reference's BatchResampler accumulate/chunk
    semantics (resampler.rs:114-167), with fixed shapes for jit.
    """

    up: int
    down: int
    chunk_in: int
    n_out_chunk: int
    n0: int  # output-index shift (<= 0); -n0 == streaming latency in output samples
    hist: int  # carried input samples
    block_out: int
    ipb: int
    k_taps: int
    matrix: np.ndarray  # [ipb + k_taps, block_out] f32

    @property
    def latency_out(self) -> int:
        return -self.n0


def stream_chunk_multiple(input_rate: int, output_rate: int, min_block_out: int = 128) -> int:
    """Inputs-per-block of the streaming plan: valid streaming chunk sizes
    are multiples of this (the single source of truth for graph-layer
    granularity computation)."""
    up, down = rational_rate(input_rate, output_rate)
    g = max(up, cdiv(min_block_out, up) * up)
    return g * down // up


@lru_cache(maxsize=64)
def make_stream_plan(
    input_rate: int,
    output_rate: int,
    mode: str = "kaiser",
    chunk_in: int = 4096,
    min_block_out: int = 128,
    half_width: int = 16,
    beta: float = 8.555,
) -> StreamResamplePlan:
    L, M = rational_rate(input_rate, output_rate)
    kw = {"half_width": half_width, "beta": beta} if mode == "kaiser" else {}
    try:
        bank, offset = _BANKS[mode](L, M, **kw)
    except KeyError:
        raise ValueError(f"unknown resample mode {mode!r}; known: {sorted(_BANKS)}") from None
    k_taps = bank.shape[1]
    g = max(L, cdiv(min_block_out, L) * L)
    ipb = stream_chunk_multiple(input_rate, output_rate, min_block_out)
    if chunk_in % ipb != 0:
        raise ValueError(
            f"chunk_in={chunk_in} must be a multiple of {ipb} "
            f"(= {g}*{M}/{L}) for rates {input_rate}->{output_rate}"
        )
    noc = chunk_in * L // M
    # largest n0 such that the last output of a chunk never reads past the
    # chunk's final input sample: ((n0+noc-1)*M)//L + offset + k_taps - 1 <= chunk_in - 1
    n0 = (chunk_in - k_taps - offset) * L // M - noc + 1
    while ((n0 + noc - 1) * M) // L + offset + k_taps - 1 > chunk_in - 1:
        n0 -= 1
    n0 = min(n0, 0)
    hist = -((n0 * M) // L + offset)
    assert hist >= 0, (n0, offset, hist)
    # block matrix with phases shifted by n0; n_shift must keep the row-0
    # alignment: window start of block b, col 0 is q(n0 + b*g) relative to
    # buf position b*ipb. Because g is a multiple of L, q advances by exactly
    # ipb per block, so one matrix serves all blocks.
    w = _block_matrix(bank, L, M, g, n_shift=n0)
    assert w.shape[0] <= ipb + k_taps
    if w.shape[0] < ipb + k_taps:
        w = np.pad(w, ((0, ipb + k_taps - w.shape[0]), (0, 0)))
    return StreamResamplePlan(L, M, chunk_in, noc, n0, hist, g, ipb, k_taps, w)


def _banded_matmul(
    x: torch.Tensor, w: torch.Tensor, n_blocks: int, ipb: int,
    precision: str | None = None,
) -> torch.Tensor:
    """Compute ``windows(x) @ w`` without materializing the windows.

    ``w [width, G]`` acts on overlapped windows of ``x`` at stride ``ipb``
    (width >= ipb). The band splits into ceil(width/ipb) segments, each a
    matmul whose left operand is a shifted reshape of ``x``: for 44.1k->16k
    that is width 538 = ipb 441 + k_taps 97, so two segments.
    """
    width = w.shape[0]
    need = n_blocks * ipb + width
    t = x.shape[-1]
    if t < need:
        x = torch.nn.functional.pad(x, (0, need - t))
    y = None
    for j0 in range(0, width, ipb):
        w_j = min(ipb, width - j0)
        seg = x[..., j0 : j0 + n_blocks * ipb].reshape(*x.shape[:-1], n_blocks, ipb)
        part = mm(seg[..., :w_j], w[j0 : j0 + w_j], precision)
        y = part if y is None else y + part
    return y


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float64 else x.dtype


def resample_apply(
    x: torch.Tensor,
    plan: ResamplePlan,
    n_out: int | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """Resample ``x [..., T]`` with a prebuilt plan. Tail is zero-padded.

    One banded matmul over the whole signal: the JAX package's chunked
    ``lax.scan`` form for long signals is a TPU cache-locality choice and
    computes the same products.
    """
    t = x.shape[-1]
    if n_out is None:
        n_out = cdiv(t * plan.up, plan.down)
    dt = _compute_dtype(x)
    xc = x.to(dt)
    if plan.history:
        xc = torch.nn.functional.pad(xc, (plan.history, 0))
    n_blocks = cdiv(n_out, plan.block_out)
    w = on_device(plan.matrix, x.device).to(dt)
    y = _banded_matmul(xc, w, n_blocks, plan.ipb, precision)
    y = y.reshape(*y.shape[:-2], n_blocks * plan.block_out)
    return y[..., :n_out].to(x.dtype)


def resample_stream_init(
    plan: StreamResamplePlan, lead_shape=(), dtype=torch.float32, device=None,
) -> torch.Tensor:
    """Zero history carry ``[..., hist]`` (matches the offline zero left-pad)."""
    return torch.zeros((*lead_shape, plan.hist), dtype=dtype, device=device)


def resample_stream_step(
    plan: StreamResamplePlan,
    carry: torch.Tensor,
    chunk: torch.Tensor,
    precision: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One streaming step: ``chunk [..., chunk_in]`` -> ``[..., n_out_chunk]``,
    with the carry ``[..., hist]`` in and out: the polyphase kernel on a CUDA
    tensor, :func:`resample_stream_step_reference` on the CPU
    (:func:`.kernels.resample.resample_stream_step`)."""
    from .kernels.resample import resample_stream_step as step

    return step(plan, carry, chunk, precision)


def resample_stream_step_reference(
    plan: StreamResamplePlan,
    carry: torch.Tensor,
    chunk: torch.Tensor,
    precision: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`resample_stream_step`: the carry and the
    chunk concatenated and multiplied with the dense band."""
    if chunk.shape[-1] != plan.chunk_in:
        raise ValueError(f"chunk length {chunk.shape[-1]} != plan chunk_in {plan.chunk_in}")
    buf = torch.cat([carry, chunk], dim=-1)
    n_blocks = plan.n_out_chunk // plan.block_out
    dt = _compute_dtype(buf)
    w = on_device(plan.matrix, buf.device).to(dt)
    y = _banded_matmul(buf.to(dt), w, n_blocks, plan.ipb, precision)
    y = y.reshape(*buf.shape[:-1], plan.n_out_chunk).to(chunk.dtype)
    new_carry = buf[..., buf.shape[-1] - plan.hist :] if plan.hist else carry
    return new_carry, y


def resample(
    x: torch.Tensor,
    input_rate: int,
    output_rate: int,
    mode: str = "kaiser",
    **kwargs,
) -> torch.Tensor:
    """Resample ``[..., T]`` from input_rate to output_rate.

    Identity passthrough when rates match.
    """
    if input_rate == output_rate:
        return x
    precision = kwargs.pop("precision", None)
    return resample_apply(
        x, make_plan(input_rate, output_rate, mode, **kwargs), precision=precision
    )
