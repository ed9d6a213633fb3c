"""Linear predictive coding: all-pole modeling by the autocorrelation method.

Mirrors ``audioflow_tpu/ops/lpc.py``. The autocorrelation is the port's
:func:`~.rhythm.autocorrelate`, and the Levinson-Durbin recursion is a loop
over the model order whose body is the JAX package's scan body: a masked
gather and a vector update over the fixed-size coefficient vector, batched
over all leading axes at once. Conventions: ``a[0] = 1`` and the predictor
is ``x[n] ~ -sum a[k] x[n-k]`` (the ``np.convolve(a, x)`` residual form).
"""

from __future__ import annotations

import torch

from ..utils import as_tensor
from .rhythm import autocorrelate

__all__ = ["lpc", "lpc_from_autocorr", "lpc_residual_energy"]


def lpc_from_autocorr(r: torch.Tensor, order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Levinson-Durbin: autocorrelation ``[..., >= order+1]`` -> (a, e).

    Returns the all-pole coefficients ``a`` ``[..., order+1]`` (``a[0] = 1``)
    and the final prediction-error energy ``e`` ``[...]``. Zero-energy input
    (r[0] == 0) yields a = [1, 0, ...], e = 0: guarded, not NaN.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if r.shape[-1] < order + 1:
        raise ValueError(f"need at least order+1 = {order + 1} autocorrelation lags, got {r.shape[-1]}")
    r = r[..., : order + 1]
    dtype = r.dtype
    jidx = torch.arange(order + 1, device=r.device)
    a = torch.zeros_like(r)
    a[..., 0] = 1.0
    e = r[..., 0]
    for i in range(1, order + 1):
        # s = sum_{j=0}^{i-1} a[j] * r[i-j]  (a[0] = 1 supplies the r[i] term)
        idx = torch.clamp(i - jidx, 0, order)
        mask = (jidx < i).to(dtype)
        s = (a * r[..., idx] * mask).sum(dim=-1)
        live = e > 0
        k = torch.where(live, -s / torch.where(live, e, 1.0), 0.0)
        # a'[j] = a[j] + k * a[i-j] for j = 1..i (a[i] was 0, so a'[i] = k)
        rev_mask = ((jidx >= 1) & (jidx <= i)).to(dtype)
        a = a + k[..., None] * (a[..., idx] * rev_mask)
        e = e * (1.0 - k * k)
    return a, e


def lpc(x, order: int, precision: str | None = None, device=None) -> torch.Tensor:
    """All-pole LPC coefficients of ``x`` ``[..., L]`` -> ``[..., order+1]``.

    Levinson-Durbin on the biased autocorrelation of the raw samples (window
    upstream if desired), batched over leading axes; for framed analysis
    pass ``frame(x, L, hop)``. ``x`` is a tensor, or numpy that goes to
    ``device`` ("cuda" unless given).
    """
    r = autocorrelate(as_tensor(x, device), max_lag=order, precision=precision)
    return lpc_from_autocorr(r, order)[0]


def lpc_residual_energy(x, order: int, precision: str | None = None, device=None) -> torch.Tensor:
    """Prediction-error energy per analysis vector ``[..., L]`` -> ``[...]``
    (the Levinson ``e``; the whitened-source power of the all-pole model)."""
    r = autocorrelate(as_tensor(x, device), max_lag=order, precision=precision)
    return lpc_from_autocorr(r, order)[1]
