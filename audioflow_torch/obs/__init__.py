"""Observability of the port: throughput metrics, logging, stats
persistence and the app lifecycle.

Mirrors ``audioflow_tpu/obs``: :func:`profile_trace` writes a
torch.profiler trace where the JAX package's writes a ``jax.profiler`` one.
The port's device-time breakdown by path is :mod:`audioflow_torch.profiling`.
"""

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
]
