"""Multi-rank scaling: mesh construction, batch sharding, multi-process
init, and per-lane fault masking.

Mirrors ``audioflow_tpu/parallel/__init__.py`` in PyTorch's own model: one
process per rank over ``torch.distributed``, the mesh a ``DeviceMesh`` with
named dims (``("data",)``, or ``("data", "model")`` for the tensor-parallel
head), and every function taking and returning the rank's local shard. The
workload is embarrassingly parallel over files, so the primary strategy is
data-parallel batch sharding: each rank runs the graph on its rows of the
batch with no cross-rank traffic. Tensor parallelism exists where there is a
model dim to split (the trainable MLP head, ``models.make_train_step(...,
model_axis=)``). Sequence parallelism exists for the one-long-signal case
(:mod:`.sp`: the time axis sharded, halo exchanges for the frame overlap).

The world is the caller's: :func:`multihost_init` wraps
``init_process_group`` with the backend the caller names, NCCL for ranks on
cards of their own, gloo for ranks on the CPU or ranks that share one card
(NCCL refuses two ranks on one device; gloo takes CUDA tensors in its
all-reduce and all-gather, and a halo exchange is staged through
page-locked host memory, see ``_comm``). Nothing switches backend or device
on its own.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..errors import AudioError, ErrorCode
from ..utils import resolve_device
from . import sp
from .sp import (
    sequence_sharded_fir,
    sequence_sharded_frontend,
    sequence_sharded_graph,
    sequence_sharded_iir,
    sequence_sharded_limiter,
    sequence_sharded_master,
    sequence_sharded_resample,
    sequence_sharded_spectrogram,
)

__all__ = [
    "batch_sharding", "compile_sharded", "make_mesh", "mask_lanes", "multihost_init", "pad_batch", "shard_batch",
    "sp", "sequence_sharded_fir", "sequence_sharded_frontend", "sequence_sharded_graph", "sequence_sharded_iir",
    "sequence_sharded_limiter", "sequence_sharded_master", "sequence_sharded_resample",
    "sequence_sharded_spectrogram",
]


def make_mesh(
    n_devices: int | None = None,
    axes: tuple[str, ...] = ("data",),
    shape: tuple[int, ...] | None = None,
    devices=None,
) -> DeviceMesh:
    """Build a device mesh over the world's ranks (the process group must
    exist: :func:`multihost_init`). Every rank calls it with the same
    arguments.

    1-D ``("data",)`` by default (pure DP). Pass ``axes=("data", "model")``
    and ``shape`` for a 2-D mesh. ``n_devices`` defaults to the world size
    and cannot exceed it; every rank of the world holds a shard. ``devices``
    is the device the ranks compute on: "cuda" unless given ("cpu" for a
    CPU world). On the card, each rank takes card ``LOCAL_RANK`` modulo the
    cards the host has, so ranks that outnumber the cards share them.
    """
    if not dist.is_initialized():
        raise AudioError(
            "make_mesh needs a process group: call parallel.multihost_init(backend=...) first",
            code=ErrorCode.DEVICE_UNAVAILABLE,
        )
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise AudioError(f"requested {n} devices, have {world}", code=ErrorCode.DEVICE_UNAVAILABLE)
    if n < world:
        raise AudioError(
            f"requested {n} devices in a world of {world} ranks; every rank holds a shard",
            code=ErrorCode.DEVICE_UNAVAILABLE,
        )
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise AudioError(f"mesh shape {shape} != device count {n}", code=ErrorCode.DEVICE_UNAVAILABLE)
    dev = resolve_device(devices)
    if dev.type == "cuda":
        # chosen here, before the mesh would pick LOCAL_RANK itself, which
        # names no card when several ranks share one
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh: DeviceMesh, ndim: int = 2, axis: str = "data") -> tuple:
    """The placements of a batch-sharded tensor on ``mesh``: the leading
    (file/batch) axis sharded over ``axis``, replicated over any other dim."""
    if ndim < 1:
        raise AudioError(f"a batch has at least one axis, got ndim {ndim}", code=ErrorCode.SHAPE_MISMATCH)
    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def shard_batch(x, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``x [batch, ...]`` (a numpy array or a tensor,
    the same on every rank) on the mesh's device, in its own dtype.

    The batch dimension must divide by the axis size (pad upstream with
    :func:`pad_batch`).
    """
    size = mesh[axis].size()
    if x.shape[0] % size:
        raise AudioError(
            f"batch {x.shape[0]} not divisible by data-axis size {size}; pad first",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    rows = x.shape[0] // size
    i = mesh.get_local_rank(axis)
    part = x[i * rows : (i + 1) * rows]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(mesh_device(mesh))


def pad_batch(x: np.ndarray, mesh: DeviceMesh, axis: str = "data") -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad the batch to a multiple of the data-axis size.

    Returns (padded, valid_mask[batch_padded] bool).
    """
    size = mesh[axis].size()
    b = x.shape[0]
    target = -(-b // size) * size
    mask = np.zeros(target, dtype=bool)
    mask[:b] = True
    if target != b:
        pad = [(0, target - b)] + [(0, 0)] * (x.ndim - 1)
        x = np.pad(x, pad)
    return x, mask


def compile_sharded(
    graph,
    mesh: DeviceMesh,
    axis: str = "data",
    donate: bool = False,
    shard: str = "batch",
):
    """A Graph's chain over the mesh, as a function of this rank's shard.

    ``shard="batch"`` (default): the function takes the rank's rows of the
    batch (:func:`shard_batch`) and is ``graph.chain`` itself: the
    embarrassingly-parallel per-file mode, with no collective.

    ``shard="time"``: ONE long signal's time axis sharded: the node chain is
    mapped onto the :mod:`.sp` machinery (finite-halo exchanges,
    affine/max-plus carry composition; see
    :func:`~audioflow_torch.parallel.sequence_sharded_graph` for node
    coverage). The function takes the rank's ``[batch, T / n]`` slice of the
    time axis; a node without a time-sharded mapping raises a typed error
    naming itself.

    ``donate`` is accepted for the JAX package's signature; PyTorch runs
    eagerly and donates no buffer.
    """
    if shard == "time":
        return sequence_sharded_graph(graph, mesh, axis=axis)
    if shard != "batch":
        raise AudioError(
            f"unknown shard mode {shard!r}; known: batch, time",
            code=ErrorCode.CONFIG_VALIDATION_ERROR,
        )
    return graph.chain


def mask_lanes(out: torch.Tensor, valid_mask) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lane fault isolation: zero out failed or padded lanes.

    ``valid_mask [batch]``: False lanes (bad decode, padding) are zeroed so
    a bad file never aborts the batch; callers filter by the mask on the
    host. Returns ``(masked, mask)`` with the mask on ``out``'s device.
    """
    m = torch.as_tensor(np.asarray(valid_mask) if not isinstance(valid_mask, torch.Tensor) else valid_mask,
                        device=out.device)
    shape = (-1,) + (1,) * (out.ndim - 1)
    return out * m.reshape(shape).to(out.dtype), m


def multihost_init(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "nccl",
    timeout: float | None = None,
) -> bool:
    """Initialise the default process group; returns True when this call did
    the initialisation, False when a group already exists.

    ``backend`` is the caller's choice and is never changed here: "nccl"
    for ranks on cards of their own, "gloo" for ranks on the CPU or ranks
    that share a card. ``coordinator`` is the rendezvous (``host:port``,
    ``tcp://host:port`` or ``file:///path``); without it the ranks meet
    through the environment that ``torch.distributed.run`` sets (``env://``),
    except that a world of one (``num_processes=1``) needs no rendezvous and
    keeps its store in memory. ``timeout`` (seconds) bounds every collective.

    Real misconfiguration (a wrong coordinator address, inconsistent
    num_processes/process_id, unreachable peers) is logged and re-raised:
    carrying on as one process after a failed init would shard a fraction
    of the batch and quietly report wrong throughput.
    """
    from ..obs import get_logger

    log = get_logger("parallel")
    if dist.is_initialized():
        log.debug("torch.distributed already initialized; multihost_init is a no-op")
        return False
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if coordinator is None and num_processes == 1:
        kw.update(store=dist.HashStore(), world_size=1, rank=0)
    else:
        method = "env://" if coordinator is None else coordinator
        kw.update(
            init_method=method if "://" in method else f"tcp://{method}",
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
        )
    try:
        dist.init_process_group(backend, **kw)
    except ValueError as err:
        log.error(
            "multi-host init misconfigured (coordinator=%s, num_processes=%s, "
            "process_id=%s, backend=%s): %s", coordinator, num_processes, process_id, backend, err,
        )
        raise
    except RuntimeError as err:
        log.error(
            "multi-host init failed (coordinator=%s, num_processes=%s, "
            "process_id=%s, backend=%s): %s", coordinator, num_processes, process_id, backend, err,
        )
        raise
    log.info(
        "multi-host initialized: rank %d/%d on %s", dist.get_rank(), dist.get_world_size(), backend,
    )
    return True
