"""torch.profiler integration: the trace behind ``audioflow bench --profile-dir``.

Mirrors ``audioflow_tpu/obs/profiling.py`` (``jax.profiler.trace``). The
trace is a Chrome trace written by ``torch.profiler.tensorboard_trace_handler``
(``<host>_<pid>.<time>.pt.trace.json``), which TensorBoard's profiler plugin
and Perfetto open. The JAX package carries on untraced where its backend has
no profiler; torch.profiler exists on the CPU and on the card, so here a
failure to trace is raised.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the CPU and, where a card is visible, the card into ``log_dir``;
    a no-op when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
