"""Throughput/timing metrics for graph runs.

Mirrors ``audioflow_tpu/obs/metrics.py``: the same :class:`Timer` and
:class:`RunMetrics`. The JAX package syncs by reading a value back and
times a loop inside one jitted scan; here :func:`sync` is
``torch.cuda.synchronize`` for output on the card (nothing on the CPU) and
:func:`measure_throughput` times a loop of calls with CUDA events.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


class Timer:
    """Wall-clock context manager: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self.start = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


@dataclass
class RunMetrics:
    """Per-run counters, with the north-star throughput numbers.

    ``compile_seconds``: the port has no ahead-of-time compile step, so the
    batch runner reports here the time of a warm-up call of its first batch,
    any kernel build at first use included; ``wall_seconds`` leaves it out,
    as in the JAX package.
    """

    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    batches: int = 0
    files: int = 0
    failed_files: int = 0
    compile_seconds: float = 0.0
    n_devices: int = 1
    extra: dict = field(default_factory=dict)

    @property
    def realtime_factor(self) -> float:
        """audio-seconds processed per wall-second (the headline metric)."""
        return self.audio_seconds / self.wall_seconds if self.wall_seconds > 0 else 0.0

    @property
    def realtime_factor_per_chip(self) -> float:
        return self.realtime_factor / max(self.n_devices, 1)

    def to_dict(self) -> dict:
        return {
            "audio_seconds": self.audio_seconds,
            "wall_seconds": self.wall_seconds,
            "batches": self.batches,
            "files": self.files,
            "failed_files": self.failed_files,
            "compile_seconds": self.compile_seconds,
            "n_devices": self.n_devices,
            "realtime_factor": self.realtime_factor,
            "realtime_factor_per_chip": self.realtime_factor_per_chip,
            **self.extra,
        }


def sync(y) -> None:
    """Wait for the device work behind ``y`` (a tensor, or a tuple or list of
    them): ``torch.cuda.synchronize`` on the card; the CPU is synchronous."""
    leaf = y
    while isinstance(leaf, (tuple, list)):
        leaf = leaf[0]
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def measure_throughput(fn, x, audio_seconds: float, iters: int = 10, warmup: int = 2) -> RunMetrics:
    """Time ``iters`` calls of ``fn(x)`` after ``warmup`` calls.

    On the card the loop is timed with CUDA events around it and one
    synchronize at its end; on the CPU with the host clock. The first
    warmup call's time is ``compile_seconds`` (kernel builds at first use).
    """
    m = RunMetrics()
    with Timer() as tc:
        sync(fn(x))
    m.compile_seconds = tc.elapsed
    for _ in range(max(warmup - 1, 0)):
        sync(fn(x))
    cuda = isinstance(x, torch.Tensor) and x.is_cuda
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            y = fn(x)
        end.record()
        end.synchronize()
        m.wall_seconds = start.elapsed_time(end) / 1e3
    else:
        with Timer() as t:
            for _ in range(iters):
                y = fn(x)
        m.wall_seconds = t.elapsed
    leaf = y
    while isinstance(leaf, (tuple, list)):
        leaf = leaf[0]
    if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
        assert bool(torch.isfinite(leaf).all()), "non-finite output in benchmark"
    m.audio_seconds = audio_seconds * iters
    m.batches = iters
    return m
