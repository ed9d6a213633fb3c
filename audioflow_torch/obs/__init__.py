"""Observability of the port: throughput metrics, logging, stats
persistence and the app lifecycle.

Mirrors ``audioflow_tpu/obs``. Its ``profile_trace`` (``jax.profiler``)
has no counterpart here: the port's device-time breakdown is
:mod:`audioflow_torch.profiling`.
"""

from .lifecycle import AppDirs, AppPhase, LifecycleManager
from .logging import get_logger, setup_logging
from .metrics import RunMetrics, Timer, measure_throughput, sync
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
    "setup_logging",
    "sync",
]
