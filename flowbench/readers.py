"""Arithmetic that several metrics' readers share (``flowbench/metrics/``)."""

from __future__ import annotations

import math

import numpy as np

from .reference import design
from .roofline import least_seconds, melspec_work
from .stats import percentile


def rate(r, audio="audio_s", wall="wall_s"):
    """Audio seconds over wall seconds of the whole window."""
    s = r.window.samples
    if audio not in s or wall not in s:
        return None
    return s[audio] / s[wall]


def p95_ms(r, key):
    """The 95th percentile of all of a window's samples, in ms."""
    v = r.window.samples.get(key)
    return 1e3 * percentile(v, 95) if v else None


def mean_ms(r, key):
    v = r.window.samples.get(key)
    return 1e3 * sum(v) / len(v) if v else None


def idle_pct(r):
    """The device's idle share of the traced stretch, in %."""
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def busy_ms_per_unit(r):
    """Device busy time of the traced stretch over the units of work done in it."""
    t = r.trace
    if t is None or r.traced_units <= 0:
        return None
    return 1e3 * t.busy_s / r.traced_units


def step_ops(r):
    return r.counts.get("step_ops") or None


def _nodes(config):
    g = config.get("graph") or config["fork"]["trunk"]
    return g["nodes"]


def melspec_roofline_pct(r):
    """The least time of one melspec call (its shapes in the cell: the rows,
    and the chunk's resampled samples with the framing's carry) over the
    mean device time per recorded melspec launch, in %."""
    t = r.trace
    if t is None or "chunk_in" not in r.window.samples:
        return None
    launches = [v for k, v in t.ops.items() if "melspec" in k]
    n = sum(c for _, c in launches)
    if n == 0:
        return None
    measured = sum(s for s, _ in launches) / n
    samples = r.window.samples["chunk_in"]
    mel = None
    for node in _nodes(r.config):
        if node["type"] == "Resample":
            samples = samples * node["output_rate"] // node["input_rate"]
        if node["type"] == "LogMelSpec":
            mel = node
    if mel is None:
        return None
    n_fft, hop = mel["n_fft"], mel["hop"]
    samples += (math.ceil(n_fft / hop) - 1) * hop
    sr = mel["sample_rate"]
    fb = design.slaney_filterbank(n_fft, mel["n_mels"], sr, mel["f_min"], mel["f_max"] or sr / 2)
    nnz = int(np.count_nonzero(fb.astype(np.float32)))
    flops, nbytes = melspec_work(r.window.samples["rows"], samples, n_fft, hop, mel["n_mels"], nnz)
    least = least_seconds(r.device_kind, flops, nbytes)
    return None if least is None else 100.0 * least / measured
