"""Observability of the port: throughput metrics, logging, stats
persistence, the app lifecycle, and the tracer.

Mirrors ``audioflow_tpu/obs``: :func:`profile_trace` writes a
torch.profiler trace where the JAX package's writes a ``jax.profiler`` one.
The port's device-time breakdown by path is :mod:`audioflow_torch.profiling`.

:mod:`trace` is the port's one tracer: spans at the graph's layer
boundaries (``graph.scan_stream``, ``graph.init_state``,
``graph.stream_step``, ``node.<Type>``, ``graph.align``,
``graph.concat``) and the one-time work of a process
(``kernels.build.<src>``, ``kernels.load.<src>``, ``graph.shape_pass``).
It is on while ``trace.enable()`` is in force or while a torch profiler
records, so a profiled run (``profile_trace``, ``audioflow bench
--profile-dir``) carries every span in its Chrome trace as
``audioflow.<name>``; off, a span costs one flag check.
``trace.snapshot()`` gives the newest recording's totals by span (count,
host and host self time, CUDA-event device time) and the one-time table.
"""

from . import trace
from .lifecycle import AppDirs, AppPhase, LifecycleManager
from .logging import get_logger, setup_logging
from .metrics import RunMetrics, Timer, measure_throughput, sync
from .profiling import profile_trace
from .stats import StatsFile, default_stats_path

__all__ = [
    "AppDirs",
    "AppPhase",
    "LifecycleManager",
    "RunMetrics",
    "StatsFile",
    "Timer",
    "default_stats_path",
    "get_logger",
    "measure_throughput",
    "profile_trace",
    "setup_logging",
    "sync",
    "trace",
]
