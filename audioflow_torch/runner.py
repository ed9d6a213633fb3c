"""Batch runner: the production driving loop over many files.

Mirrors ``audioflow_tpu/runner.py``. Host decode (the loader's background
thread), the copy to the card and the graph overlap: while the card runs
batch k, the loader decodes batch k+1, and on the card the copy of a batch
from the loader's page-locked ring is enqueued without waiting. Outputs
reach the sinks one batch late, so that the host read of batch k waits only
on batch k; that read also waits for the copy of batch k, which frees its
staging slot before the loader can refill it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .errors import AudioError, ConfigError, ErrorCode
from .graph import Graph
from .io import BatchLoader, DecodedBatch
from .obs import RunMetrics, Timer, get_logger
from .obs.metrics import sync
from .sinks import EventDispatcher, Sink
from .utils import resolve_device

_log = get_logger("runner")


def mask_lanes(out: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-lane fault isolation: zero the lanes whose ``valid [batch]`` is
    False (bad decode, wrong rate, padding), on the device, so garbage from
    a bad lane can never reach a sink."""
    shape = (-1,) + (1,) * (out.ndim - 1)
    return out * valid.reshape(shape).to(out.dtype)


def run_batch(
    graph: Graph,
    batch: DecodedBatch,
    stride: int,
    batch_size: int,
    expect_rate: int | None,
    device: torch.device,
    mesh=None,
) -> torch.Tensor:
    """One batch of :func:`run_batches`: the masked output of its lanes, on
    ``device``, without waiting for the device.

    The batch is brought to ``stride`` samples (truncated with a warning, or
    zero-padded) and to ``batch_size`` rows (the tail batch), and lanes
    whose rate is not ``expect_rate`` are marked invalid in ``batch.valid``.
    With ``mesh``, the rows are padded to a multiple of the data dim
    (``parallel.pad_batch``), each rank runs the graph on its own rows, and
    every rank receives the whole output (one all-gather).
    """
    x = batch.samples
    if x.shape[1] > stride:
        _log.warning("batch longer than stride; truncating %d -> %d", x.shape[1], stride)
        x = x[:, :stride]
    bad_rate = batch.valid & (batch.rates != (expect_rate or 0))
    if expect_rate and bad_rate.any():
        _log.warning("masking %d lanes with sample rate != %d", int(bad_rate.sum()), expect_rate)
        batch.valid &= ~bad_rate
    vmask = np.zeros(batch_size, dtype=bool)
    vmask[: len(batch.paths)] = batch.valid
    if mesh is not None:  # to a multiple of the data dim, the extra rows invalid
        from .parallel import _comm, pad_batch, shard_batch

        vmask = pad_batch(vmask, mesh)[0]
    xd = torch.from_numpy(x).to(device, non_blocking=True)
    # the same zero padding as the JAX package: to the stride, and to a full
    # batch for the tail
    xd = torch.nn.functional.pad(xd, (0, stride - xd.shape[1], 0, len(vmask) - xd.shape[0]))
    vd = torch.from_numpy(vmask).to(device)
    if mesh is None:
        return mask_lanes(graph.chain(xd), vd)[: len(batch.paths)]
    out = mask_lanes(graph.chain(shard_batch(xd, mesh)), shard_batch(vd, mesh))
    return _comm.all_gather(out, mesh.get_group("data")).flatten(0, 1)[: len(batch.paths)]


def run_batches(
    graph: Graph,
    loader: BatchLoader,
    sinks: Sequence[Sink] = (),
    mesh=None,
    events: EventDispatcher | None = None,
    expect_rate: int | None = None,
    device: torch.device | str | None = None,
) -> RunMetrics:
    """Run ``graph`` over every batch the loader yields, on ``device``
    ("cuda" unless given; without a card that raises, it never carries on on
    the CPU unasked).

    Uses a fixed ``stride`` from the loader (set ``loader.stride``; otherwise
    the first batch's stride is reused and longer later files are truncated
    with a warning). Failed decode lanes and lanes at another rate than
    ``expect_rate`` (the graph's input rate by default) are masked, never
    fatal. Outputs are written to ``sinks`` batch by batch (valid lanes
    only). On the card the loader's ring is page-locked, so that the copy of
    a batch does not hold up the host.

    The metrics count only the samples processed (lanes truncated to the
    stride count as truncated). The port compiles nothing ahead of time, so
    ``compile_seconds`` is the time of a warm-up call of the first batch,
    synchronised, any kernel build at first use included; as in the JAX
    package, ``wall_seconds`` leaves it out, and the first batch is then run
    again inside the wall time.

    With ``mesh`` (a ``DeviceMesh`` with a "data" dim; every rank of the
    world calls this with the same loader), each batch is padded to a
    multiple of the data dim, each rank runs the graph on its rows on the
    mesh's device (``device`` is then not read), and the outputs are
    gathered; rank 0 alone writes the sinks and emits the events.
    ``n_devices`` is the world size.
    """
    if mesh is None:
        device, n_dev, root = resolve_device(device), 1, True
    else:
        import torch.distributed as dist

        from .parallel import mesh_device

        if mesh.mesh_dim_names != ("data",):
            raise ConfigError(
                f"run_batches shards over a 1-D ('data',) mesh, got {mesh.mesh_dim_names}",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        device, n_dev, root = mesh_device(mesh), mesh.size(), dist.get_rank() == 0
    events = events or EventDispatcher(enabled=False)
    expect_rate = expect_rate or graph.input_rate

    m = RunMetrics(n_devices=n_dev)
    pending = None  # (device_out, batch) — one batch of latency for overlap
    stride = loader.stride

    def _flush(pair):
        dev_out, batch = pair
        if not root:
            return
        host = dev_out.cpu().numpy()
        ok = batch.valid
        for sink in sinks:
            sink.write(host[ok])
        events.emit_result(host[ok], final=False, index=m.batches)

    with Timer() as t_total:
        for batch in loader.batches(pin_memory=device.type == "cuda"):
            if stride is None:
                stride = batch.samples.shape[1]
            if m.batches == 0:
                with Timer() as tc:
                    sync(run_batch(graph, batch, stride, loader.batch_size, expect_rate, device, mesh))
                m.compile_seconds = tc.elapsed
            out = run_batch(graph, batch, stride, loader.batch_size, expect_rate, device, mesh)
            if pending is not None:
                _flush(pending)
            pending = (out, batch)
            m.batches += 1
            m.files += len(batch.paths)
            m.failed_files += int((~batch.valid).sum())
            # count only the audio actually processed (lanes may be truncated
            # to the stride), so realtime_factor is never overstated
            ok = batch.valid & (batch.rates > 0)
            eff = np.minimum(batch.lengths, stride)
            m.audio_seconds += float((eff[ok] / batch.rates[ok]).sum()) if ok.any() else 0.0
        if pending is not None:
            _flush(pending)
    # throughput excludes the one-time warm-up (reported separately)
    m.wall_seconds = max(t_total.elapsed - m.compile_seconds, 1e-9)
    if m.files == 0:
        raise AudioError("loader yielded no batches", code=ErrorCode.FILE_NOT_FOUND)
    _log.info(
        "run complete: %d files (%d failed), %.1f audio-s, %.0fx realtime",
        m.files, m.failed_files, m.audio_seconds, m.realtime_factor,
    )
    return m
