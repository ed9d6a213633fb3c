"""Biquad IIR filters and cascades via blocked state-space matmuls.

Mirrors ``audioflow_tpu/ops/biquad.py``. A cascade of biquads is lifted to
state-space form and processed in blocks of ``Bk`` samples:

    y_blk  = x_blk @ T^t + s0 @ O^t
    s_next = s0 @ (A^Bk)^t + x_blk @ U^t

where ``T`` is the lower-triangular Toeplitz matrix of the cascade's impulse
response, ``O`` stacks C·A^i and ``U`` stacks A^(Bk-1-j)·B, all designed on
the host in float64 (a copy of the JAX package's design code, bit for bit).

The JAX package carries the state through a ``lax.scan`` over blocks, one
device loop. Eagerly that would be a few launches per block, thousands per
signal, so here the state recurrence ``s_{k+1} = s_k·P^t + v_k`` (``P =
A^Bk``, ``v_k = x_k·U^t``) runs as an affine prefix scan by doubling: in
``ceil(log2(blocks + 1))`` steps, ``s[k] += s[k - 2^m]·(P^(2^m))^t``, the
powers designed on the host in float64 (``IIRPlan.scan_pows``). Every step
is one matmul and one add over all blocks, so a call's launches grow with
the logarithm of its length, not with it. The sums are the blocked
recurrence's, grouped in another order.

Filter design follows the RBJ Audio-EQ-Cookbook (lowpass/highpass/bandpass/
notch/allpass/peaking/shelves).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..utils.cache import on_device
from ._mm import mm

# powers P^(2^m) kept per plan: enough for 2^31 blocks
_SCAN_LEVELS = 31


# --------------------------------------------------------------------------
# design (RBJ cookbook), float64 host-side
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Biquad:
    """Normalized biquad (a0 == 1): y += b0 x + b1 x' + b2 x'' - a1 y' - a2 y''."""

    b0: float
    b1: float
    b2: float
    a1: float
    a2: float

    def as_ba(self) -> tuple[np.ndarray, np.ndarray]:
        return (
            np.array([self.b0, self.b1, self.b2], dtype=np.float64),
            np.array([1.0, self.a1, self.a2], dtype=np.float64),
        )


def _rbj(fc: float, fs: float, q: float):
    w0 = 2.0 * math.pi * fc / fs
    return math.cos(w0), math.sin(w0) / (2.0 * q)


def _norm(b0, b1, b2, a0, a1, a2) -> Biquad:
    return Biquad(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def lowpass(fc: float, fs: float, q: float = 0.7071067811865476) -> Biquad:
    cosw, alpha = _rbj(fc, fs, q)
    return _norm((1 - cosw) / 2, 1 - cosw, (1 - cosw) / 2, 1 + alpha, -2 * cosw, 1 - alpha)


def highpass(fc: float, fs: float, q: float = 0.7071067811865476) -> Biquad:
    cosw, alpha = _rbj(fc, fs, q)
    return _norm((1 + cosw) / 2, -(1 + cosw), (1 + cosw) / 2, 1 + alpha, -2 * cosw, 1 - alpha)


def bandpass(fc: float, fs: float, q: float = 1.0) -> Biquad:
    """Constant 0 dB peak gain bandpass."""
    cosw, alpha = _rbj(fc, fs, q)
    return _norm(alpha, 0.0, -alpha, 1 + alpha, -2 * cosw, 1 - alpha)


def notch(fc: float, fs: float, q: float = 1.0) -> Biquad:
    cosw, alpha = _rbj(fc, fs, q)
    return _norm(1.0, -2 * cosw, 1.0, 1 + alpha, -2 * cosw, 1 - alpha)


def allpass(fc: float, fs: float, q: float = 0.7071067811865476) -> Biquad:
    cosw, alpha = _rbj(fc, fs, q)
    return _norm(1 - alpha, -2 * cosw, 1 + alpha, 1 + alpha, -2 * cosw, 1 - alpha)


def peaking(fc: float, fs: float, gain_db: float, q: float = 1.0) -> Biquad:
    """Parametric EQ band."""
    a = 10.0 ** (gain_db / 40.0)
    cosw, alpha = _rbj(fc, fs, q)
    return _norm(1 + alpha * a, -2 * cosw, 1 - alpha * a, 1 + alpha / a, -2 * cosw, 1 - alpha / a)


def low_shelf(fc: float, fs: float, gain_db: float, q: float = 0.7071067811865476) -> Biquad:
    a = 10.0 ** (gain_db / 40.0)
    cosw, alpha = _rbj(fc, fs, q)
    two_sqrt_a_alpha = 2.0 * math.sqrt(a) * alpha
    return _norm(
        a * ((a + 1) - (a - 1) * cosw + two_sqrt_a_alpha),
        2 * a * ((a - 1) - (a + 1) * cosw),
        a * ((a + 1) - (a - 1) * cosw - two_sqrt_a_alpha),
        (a + 1) + (a - 1) * cosw + two_sqrt_a_alpha,
        -2 * ((a - 1) + (a + 1) * cosw),
        (a + 1) + (a - 1) * cosw - two_sqrt_a_alpha,
    )


def high_shelf(fc: float, fs: float, gain_db: float, q: float = 0.7071067811865476) -> Biquad:
    a = 10.0 ** (gain_db / 40.0)
    cosw, alpha = _rbj(fc, fs, q)
    two_sqrt_a_alpha = 2.0 * math.sqrt(a) * alpha
    return _norm(
        a * ((a + 1) + (a - 1) * cosw + two_sqrt_a_alpha),
        -2 * a * ((a - 1) + (a + 1) * cosw),
        a * ((a + 1) + (a - 1) * cosw - two_sqrt_a_alpha),
        (a + 1) - (a - 1) * cosw + two_sqrt_a_alpha,
        2 * ((a - 1) - (a + 1) * cosw),
        (a + 1) - (a - 1) * cosw - two_sqrt_a_alpha,
    )


# --------------------------------------------------------------------------
# state space + blocked plan
# --------------------------------------------------------------------------

def biquad_state_space(bq: Biquad):
    """DF2-transposed state space: s in R^2, y = C s + D x."""
    a_mat = np.array([[-bq.a1, 1.0], [-bq.a2, 0.0]], dtype=np.float64)
    b_vec = np.array([bq.b1 - bq.a1 * bq.b0, bq.b2 - bq.a2 * bq.b0], dtype=np.float64)
    c_vec = np.array([1.0, 0.0], dtype=np.float64)
    d = float(bq.b0)
    return a_mat, b_vec, c_vec, d


def cascade_state_space(biquads: tuple[Biquad, ...]):
    """Series connection of biquads -> one (A, B, C, D) of order 2*len."""
    a_mat, b_vec, c_vec, d = biquad_state_space(biquads[0])
    for bq in biquads[1:]:
        a2, b2, c2, d2 = biquad_state_space(bq)
        n1, n2 = a_mat.shape[0], a2.shape[0]
        a_new = np.zeros((n1 + n2, n1 + n2))
        a_new[:n1, :n1] = a_mat
        a_new[n1:, n1:] = a2
        a_new[n1:, :n1] = np.outer(b2, c_vec)
        b_new = np.concatenate([b_vec, b2 * d])
        c_new = np.concatenate([c_vec * d2, c2])
        a_mat, b_vec, c_vec, d = a_new, b_new, c_new, d * d2
    return a_mat, b_vec, c_vec, d


@dataclass(frozen=True)
class IIRPlan:
    """Precomputed blocked-scan matrices for one biquad cascade: the JAX
    package's fields, and the port's two for the doubling scan."""

    order: int  # state dimension (2 * n_stages)
    block: int
    t_mat: np.ndarray  # [Bk, Bk] lower-tri Toeplitz of impulse response (f32)
    o_mat: np.ndarray  # [Bk, order]  state -> output contribution
    u_mat: np.ndarray  # [order, Bk]  input -> next-state contribution
    a_pow: np.ndarray  # [order, order]  A^Bk
    a_pows: np.ndarray  # [Bk + 1, order, order]  A^k for exact partial blocks
    xw_mat: np.ndarray  # [Bk, Bk + order]  [T^t | U^t]: both input products in one
    scan_pows: np.ndarray  # [_SCAN_LEVELS, order, order]  A^(Bk * 2^m)


@lru_cache(maxsize=64)
def make_iir_plan(biquads: tuple[Biquad, ...], block: int = 128) -> IIRPlan:
    a_mat, b_vec, c_vec, d = cascade_state_space(tuple(biquads))
    n = a_mat.shape[0]
    # impulse response h[0..block-1] and powers of A, exactly, in f64
    h = np.zeros(block, dtype=np.float64)
    h[0] = d
    powers = np.zeros((block + 1, n, n), dtype=np.float64)
    powers[0] = np.eye(n)
    for k in range(1, block + 1):
        powers[k] = a_mat @ powers[k - 1]
    for k in range(1, block):
        h[k] = c_vec @ powers[k - 1] @ b_vec
    idx = np.arange(block)
    t_mat = np.where(idx[:, None] >= idx[None, :], h[np.maximum(idx[:, None] - idx[None, :], 0)], 0.0)
    o_mat = np.stack([c_vec @ powers[i] for i in range(block)])  # [Bk, n]
    u_mat = np.stack([powers[block - 1 - j] @ b_vec for j in range(block)], axis=1)  # [n, Bk]
    # P^(2^m) by repeated squaring in f64; an unstable cascade may overflow
    # the levels that no signal reaches
    scan = np.zeros((_SCAN_LEVELS, n, n), dtype=np.float64)
    scan[0] = powers[block]
    with np.errstate(over="ignore", invalid="ignore"):
        for m in range(1, _SCAN_LEVELS):
            scan[m] = scan[m - 1] @ scan[m - 1]
        scan = scan.astype(np.float32)
    t32, u32 = t_mat.astype(np.float32), u_mat.astype(np.float32)
    return IIRPlan(
        n,
        block,
        t32,
        o_mat.astype(np.float32),
        u32,
        powers[block].astype(np.float32),
        powers.astype(np.float32),
        np.concatenate([t32.T, u32.T], axis=1),
        scan,
    )


def iir_apply(
    x: torch.Tensor,
    plan: IIRPlan,
    zi: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter ``x [..., T]`` through the cascade. Returns (y, final_state).

    ``zi [..., order]`` is the initial state (zeros if None): the streaming
    carry and the checkpoint format. T need not be a block multiple: the
    last block is zero-padded, which leaves its first outputs exact (the
    filter is causal), and the returned state is the state at sample T,
    from the state before that block through ``a_pows`` and the slice of
    ``u_mat``. float64 input computes in float32.
    """
    t_len = x.shape[-1]
    bk, n = plan.block, plan.order
    lead = x.shape[:-1]
    if t_len == 0:
        return x, (zi if zi is not None else x.new_zeros((*lead, n)))
    dt = torch.float32 if x.dtype == torch.float64 else x.dtype
    dev = x.device
    rows = math.prod(lead)
    xr = x.to(dt).reshape(rows, t_len)
    n_blk = -(-t_len // bk)
    tail = t_len - (n_blk - 1) * bk
    xb = torch.nn.functional.pad(xr, (0, bk - tail)) if tail < bk else xr
    # both input products in one: the in-block outputs and the state inputs v_k
    z = mm(xb.reshape(rows, n_blk, bk), on_device(plan.xw_mat, dev, dt))  # [rows, nb, Bk + n]
    s0 = xr.new_zeros((rows, n)) if zi is None else zi.to(dt).reshape(rows, n)
    # s[k]: the state before block k, k = 0..nb, from s[0] = zi and
    # s[k+1] = s[k]·P^t + v_k: an inclusive scan of [zi, v_0, ..., v_{nb-1}]
    s = torch.cat([s0[None], z[..., bk:].transpose(0, 1)])  # [nb + 1, rows, n]
    pows = on_device(plan.scan_pows, dev, dt)
    d, m = 1, 0
    while d <= n_blk:
        # the product reads the old s into a fresh tensor before s changes
        s[d:].add_(mm(s[:-d], pows[m].mT))
        d, m = 2 * d, m + 1
    y = z[..., :bk] + mm(s[:n_blk], on_device(plan.o_mat, dev, dt).mT).transpose(0, 1)
    y = y.reshape(rows, n_blk * bk)[:, :t_len].reshape(*lead, t_len)
    if tail == bk:
        return y, s[n_blk].reshape(*lead, n)
    # the state at sample T: s' = s @ (A^tail)^t + x_t @ U[:, Bk-tail:]^t
    xt = xr[:, t_len - tail :]
    u_t = on_device(plan.u_mat, dev, dt)[:, bk - tail :]
    s_end = mm(s[n_blk - 1], on_device(plan.a_pows, dev, dt)[tail].mT) + mm(xt, u_t.mT)
    return y, s_end.reshape(*lead, n)


def biquad_chain(
    x: torch.Tensor,
    biquads: tuple[Biquad, ...] | list[Biquad],
    block: int = 128,
    zi: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Convenience: design plan + apply in one call (plans are LRU-cached)."""
    plan = make_iir_plan(tuple(biquads), block)
    return iir_apply(x, plan, zi)
