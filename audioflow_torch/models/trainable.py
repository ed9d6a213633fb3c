"""Trainable feature frontend: differentiable DSP + learned head.

Mirrors ``audioflow_tpu/models/trainable.py``. A small trainable stack on
top of the fixed STFT: learnable per-mel filter gains, PCEN-style
compression with learnable (alpha, delta, r), and a linear or MLP
classifier head. Its train step is the port's multi-rank training path:
each rank takes its rows of the batch and the gradients are averaged over
the mesh's data dim; with a model dim too, the MLP head runs
tensor-parallel (the Megatron split). No kernel: the frontend's STFT is
``torch.fft`` (cuFFT on the card), the rest matmuls and elementwise ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import power, stft
from ..ops._mm import mm
from ..ops.features import pcen_smoother
from ..ops.mel import cached_filterbank
from ..parallel import _comm
from ..utils import resolve_device
from ..utils.cache import on_device

_HEAD_SHARDS = {"w1": 1, "b1": 0, "w2": 0}  # the Megatron split: dim of each sharded head parameter


class TrainableFrontend(nn.Module):
    """PCEN log-mel frontend with a classifier head; the JAX package's
    dataclass fields and defaults, its parameter names, and its maths.

    ``hidden > 0`` gives an MLP head whose hidden dim is the tensor-parallel
    one (``w1`` column-sharded, ``w2`` row-sharded, one all-reduce of the
    partial logits). ``remat`` recomputes the features in the backward pass
    (``torch.utils.checkpoint``) instead of keeping them. The parameters are
    drawn from ``seed`` by a CPU ``torch.Generator`` (other numbers than the
    JAX package's ``init_params``; ``convert.trainable_from_jax`` loads
    those) on ``device``: "cuda" unless given.
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        n_fft: int = 512,
        hop: int = 128,
        n_mels: int = 64,
        n_classes: int = 10,
        hidden: int = 0,
        smoothing: float = 0.04,
        remat: bool = False,
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.sample_rate, self.n_fft, self.hop, self.n_mels = sample_rate, n_fft, hop, n_mels
        self.n_classes, self.hidden, self.smoothing, self.remat = n_classes, hidden, smoothing, remat
        # the model dim's group once make_train_step has sharded the head
        self.tp_group = None
        dev = resolve_device(device)
        for name, value in self.init_params(seed).items():
            self.register_parameter(name, nn.Parameter(value.to(dev)))

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Fresh parameters on the CPU, the JAX package's shapes and scales."""
        g = torch.Generator().manual_seed(seed)
        params = {
            "mel_gain": torch.ones(self.n_mels),
            "pcen_alpha": torch.full((self.n_mels,), 0.98),
            "pcen_delta": torch.full((self.n_mels,), 2.0),
            "pcen_r": torch.full((self.n_mels,), 0.5),
        }
        if self.hidden > 0:
            params.update(
                w1=torch.randn(self.n_mels, self.hidden, generator=g) * (1.0 / np.sqrt(self.n_mels)),
                b1=torch.zeros(self.hidden),
                w2=torch.randn(self.hidden, self.n_classes, generator=g) * (1.0 / np.sqrt(self.hidden)),
                b2=torch.zeros(self.n_classes),
            )
        else:
            params.update(
                w=torch.randn(self.n_mels, self.n_classes, generator=g) * 0.02,
                b=torch.zeros(self.n_classes),
            )
        return params

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x [batch, T] -> PCEN log-mel features [batch, frames, n_mels].

        The frame EMA (``M[t] = (1-s) M[t-1] + s mels[t]``, warm-started at
        ``M[0] = mels[0]``) is ``ops.features.pcen_smoother``'s doubling
        scan: the JAX package's recurrence summed in another order."""
        fb = on_device(cached_filterbank(self.n_fft // 2 + 1, self.n_mels, self.sample_rate), x.device)
        spec = power(stft(x, self.n_fft, self.hop, center=False))
        mels = mm(spec, fb) * F.softplus(self.mel_gain)
        smooth, _ = pcen_smoother(mels, self.smoothing)
        eps = 1e-6
        alpha = torch.sigmoid(self.pcen_alpha)
        r = torch.sigmoid(self.pcen_r)
        delta = F.softplus(self.pcen_delta)
        return (mels / (eps + smooth) ** alpha + delta) ** r - delta**r

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat:
            feats = checkpoint(self.features, x, use_reentrant=False)
        else:
            feats = self.features(x)
        feats = feats.mean(dim=-2)  # [batch, n_mels]
        if self.hidden <= 0:
            return feats @ self.w + self.b
        if self.tp_group is None:
            return F.relu(feats @ self.w1 + self.b1) @ self.w2 + self.b2
        # Megatron: the replicated features feed the column shard of w1 ("f":
        # their gradient is summed over the model dim), the row shard of w2
        # gives partial logits, summed once ("g"); b2 is added after the sum
        feats = _comm.CopyToGroup.apply(feats, self.tp_group)
        partial = F.relu(feats @ self.w1 + self.b1) @ self.w2
        return _comm.ReduceFromGroup.apply(partial, self.tp_group) + self.b2

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return F.cross_entropy(self.logits(x), y.long(), reduction="mean")



def _shard_head(model: TrainableFrontend, mesh, model_axis: str) -> None:
    """Keep only this rank's shard of ``w1`` (columns), ``b1`` and ``w2``
    (rows) over the mesh's ``model_axis``, in place, and let the model's
    ``logits`` sum the partial logits over that dim."""
    if model.hidden <= 0:
        raise ValueError("model_axis sharding requires TrainableFrontend(hidden > 0)")
    n, i = mesh[model_axis].size(), mesh.get_local_rank(model_axis)
    if model.hidden % n:
        raise ValueError(f"hidden {model.hidden} does not split over {n} model shards")
    with torch.no_grad():
        for name, dim in _HEAD_SHARDS.items():
            full = getattr(model, name)
            part = full.chunk(n, dim=dim)[i].clone()
            setattr(model, name, nn.Parameter(part))
    model.tp_group = mesh.get_group(model_axis)


def make_train_step(
    model: TrainableFrontend,
    optimizer=None,
    mesh=None,
    data_axis: str = "data",
    model_axis: str | None = None,
):
    """Build ``step(x, y) -> loss`` for ``model``; returns ``(step, optimizer)``.

    ``optimizer`` is a factory called on the model's parameters (default
    ``functools.partial(torch.optim.Adam, lr=1e-3)``: optax.adam's b1, b2
    and eps, eps outside the square root in both); the optimizer it builds
    is returned. A step updates the model in place and returns the mean
    loss over the whole batch.

    With ``mesh`` (a ``DeviceMesh``), ``x`` and ``y`` are this rank's rows
    of the batch (``parallel.shard_batch``), equal in number on every rank;
    the gradients and the loss are averaged over ``mesh[data_axis]``.

    With ``model_axis`` too (requires ``model.hidden > 0`` and a 2-D mesh,
    e.g. ``make_mesh(4, axes=("data", "model"), shape=(2, 2))``), the MLP
    head runs tensor-parallel: ``w1`` column-sharded and ``w2`` row-sharded
    over the model dim (done here before the optimizer
    is built, so its state is sharded too), one all-reduce of the partial
    logits in the forward pass and the matching one of the features'
    gradient in the backward pass.
    """
    if model_axis is not None:
        if model.hidden <= 0:
            raise ValueError("model_axis sharding requires TrainableFrontend(hidden > 0)")
        if mesh is None:
            raise ValueError("model_axis needs a mesh")
        _shard_head(model, mesh, model_axis)
    optimizer = (optimizer or functools.partial(torch.optim.Adam, lr=1e-3))(model.parameters())
    group = None if mesh is None else mesh.get_group(data_axis)
    n_data = 1 if mesh is None else mesh[data_axis].size()

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss(x, y)
        loss.backward()
        if group is not None:
            # the mean over the whole batch: every rank holds as many rows
            for p in model.parameters():
                p.grad = _comm.all_reduce(p.grad, group) / n_data
            loss = _comm.all_reduce(loss.detach(), group) / n_data
        optimizer.step()
        return loss.detach()

    return step, optimizer
