"""Batch loader: decode -> padded host batch in a staging ring, with
background prefetch so that decode overlaps device compute.

Mirrors ``audioflow_tpu/io/loader.py``: the same :class:`DecodedBatch`,
:func:`decode_batch` and :class:`BatchLoader` contract, ring and outputs.
One addition: :meth:`BatchLoader.batches` can allocate the ring
page-locked, for the batch runner on the card (see there).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from ..errors import ErrorCode, IOError_
from ..utils import round_up
from . import native


@dataclass
class DecodedBatch:
    """One host-side batch ready for the copy to the device."""

    samples: np.ndarray  # [batch, T] f32, zero-padded
    lengths: np.ndarray  # [batch] i64 (0 for failed lanes)
    rates: np.ndarray  # [batch] i32
    valid: np.ndarray  # [batch] bool — per-lane fault isolation
    paths: list
    decode_seconds: float = 0.0  # host time of decode_batch

    @property
    def audio_seconds(self) -> float:
        ok = self.valid & (self.rates > 0)
        if not ok.any():
            return 0.0
        return float((self.lengths[ok] / self.rates[ok]).sum())


def decode_batch(
    sources: Sequence,
    pad_multiple: int = 128,
    stride: int | None = None,
    use_native: bool = True,
    out: np.ndarray | None = None,
) -> DecodedBatch:
    """Decode a list of WAV/FLAC/AIFF paths or byte buffers into a padded
    mono batch.

    A failing file zeroes its lane and flips ``valid`` — the batch always
    survives (per-lane error isolation). ``out`` optionally supplies the
    (warm, reused) staging buffer — see
    :func:`audioflow_torch.io.native.decode_batch_mono`; it requires
    ``stride``.
    """
    t0 = time.perf_counter()
    buffers: list[bytes] = []
    paths = list(sources)
    for src in paths:
        if isinstance(src, (bytes, bytearray, memoryview)):
            buffers.append(bytes(src))
        else:
            try:
                with open(src, "rb") as f:
                    buffers.append(f.read())
            except OSError:
                buffers.append(b"")  # poisoned lane

    if out is not None and stride is None:
        stride = out.shape[1]
    if stride is None:
        from . import probe_audio

        max_frames = 1
        for b in buffers:
            try:
                max_frames = max(max_frames, probe_audio(b).n_frames)
            except IOError_:
                pass
        stride = round_up(int(max_frames), pad_multiple)

    if use_native and native.available():
        out, frames, rates = native.decode_batch_mono(buffers, stride, out=out)
        valid = frames >= 0
        lengths = np.where(valid, frames, 0)
        return DecodedBatch(
            out, lengths.astype(np.int64), rates, valid, paths, time.perf_counter() - t0
        )

    # numpy fallback
    n = len(buffers)
    if out is None:
        out = np.zeros((n, stride), dtype=np.float32)
    else:
        out[:] = 0.0
    lengths = np.zeros(n, dtype=np.int64)
    rates = np.zeros(n, dtype=np.int32)
    valid = np.zeros(n, dtype=bool)
    from . import read_audio

    for i, b in enumerate(buffers):
        try:
            data, rate = read_audio(b)
        except IOError_:
            continue
        if data.ndim == 2:
            data = data.mean(axis=1)
        m = min(len(data), stride)
        out[i, :m] = data[:m]
        lengths[i], rates[i], valid[i] = m, rate, True
    return DecodedBatch(out, lengths, rates, valid, paths, time.perf_counter() - t0)


class BatchLoader:
    """Iterate file batches with a background decode thread (prefetch=2).

    While the device crunches batch k, the loader decodes batch k+1 on host
    CPU threads — the ingest never stalls the card unless decode itself is
    the bottleneck.
    """

    def __init__(
        self,
        files: Iterable,
        batch_size: int,
        pad_multiple: int = 128,
        stride: int | None = None,
        prefetch: int = 2,
        use_native: bool = True,
    ):
        self.files = list(files)
        if batch_size <= 0:
            raise IOError_("batch_size must be positive", code=ErrorCode.CONFIG_VALIDATION_ERROR)
        self.batch_size = batch_size
        self.pad_multiple = pad_multiple
        self.stride = stride
        self.prefetch = prefetch
        self.use_native = use_native

    def __len__(self) -> int:
        return -(-len(self.files) // self.batch_size)

    def _groups(self) -> Iterator[list]:
        for i in range(0, len(self.files), self.batch_size):
            yield self.files[i : i + self.batch_size]

    def __iter__(self) -> Iterator[DecodedBatch]:
        return self.batches()

    def batches(self, pin_memory: bool = False) -> Iterator[DecodedBatch]:
        """The batches, as iterating the loader gives them.

        ``pin_memory=True`` allocates the staging ring page-locked (it needs
        a card), so that a ``non_blocking`` copy to the card runs
        asynchronously, and several times faster than from pageable memory
        (PERF.md). Such a copy may still read its slot after ``Tensor.to``
        returns, so the consumer must have waited on its copy of batch k
        before it asks for batch k + 2: the ring refills batch k's slot only
        after that. ``runner.run_batches`` does, since it flushes batch k to
        the host before it asks for batch k + 2.
        """
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        # Staging-buffer ring (only with a fixed stride): decoding into a
        # warm, reused buffer beats a fresh allocation, which pays a page
        # fault per page. Ring depth prefetch+3 means a buffer is recycled
        # only after that many newer batches were yielded; consumers
        # (runner.run_batches) copy the samples to the device within one
        # step, far inside that window.
        ring: list[np.ndarray | None] = [None] * (self.prefetch + 3) if self.stride is not None else []

        def producer():
            try:
                for i, group in enumerate(self._groups()):
                    out = None
                    if ring:
                        slot = i % len(ring)
                        if ring[slot] is None:
                            shape = (self.batch_size, self.stride)
                            ring[slot] = torch.empty(shape, dtype=torch.float32, pin_memory=pin_memory).numpy()
                        out = ring[slot][: len(group)]
                    q.put(decode_batch(group, self.pad_multiple, self.stride, self.use_native, out=out))
                q.put(sentinel)
            except BaseException as exc:  # propagate, never silently truncate
                q.put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            yield item
        t.join()
