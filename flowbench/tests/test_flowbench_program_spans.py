"""The readers of the program's own spans (``flowbench/program_spans.py``)
on a synthetic snapshot of ``audioflow_torch.obs.trace``, on nothing, on a
program without the tracer, and in a traced run of the stream cell on the
CPU, where only the host's readings exist."""

import sys
import time

import pytest
import torch

import audioflow_torch.obs
from audioflow_torch.obs import trace
from flowbench.bench import Bench
from flowbench.case import Window
from flowbench.cell import Readings, run_cell
from flowbench.devtrace import Summary

import smallcells
from smallcells import SECONDS, small_traffic

CELL = "logmel-stream-2048"
READERS = ("resample_device_ms_per_chunk", "logmel_device_ms_per_chunk", "scan_edge_device_ms_per_pass",
           "graph_host_self_ms_per_pass", "setup_shape_pass_s")
DEVICE = READERS[:3]


def _stat(count, host_s, self_s, device_s=None, device_count=0):
    return {"count": count, "host_s": host_s, "self_s": self_s, "device_s": device_s, "device_count": device_count}


# 4 passes of 31 chunks, two nodes and an alignment a chunk
SNAPSHOT = {
    "recording": 7,
    "spans": {
        "graph.scan_stream": _stat(4, 0.140, 0.0008, 0.1360, 4),
        "graph.init_state": _stat(4, 0.020, 0.0200, 0.0004, 4),
        "graph.stream_step": _stat(124, 0.110, 0.0124, 0.1280, 124),
        "node.Resample": _stat(124, 0.060, 0.0600, 0.0744, 124),
        "graph.align": _stat(126, 0.004, 0.0040, 0.0164, 126),
        "node.LogMelSpec": _stat(124, 0.038, 0.0380, 0.0372, 124),
        "graph.concat": _stat(4, 0.002, 0.0020, 0.0060, 4),
    },
    "first": {"graph.shape_pass": 0.93, "kernels.build.melspec": 4.2},
}


def _readings(traced=True, units=4):
    bench = Bench()
    w = bench.workload(CELL)
    return Readings(CELL, bench.config(w["config"]), bench.traffic(w["traffic"]), "NVIDIA H100 80GB HBM3", 12.5,
                    Window({}, 1, 0), Summary(1.0, 0.9) if traced else None, units, {})


def _read(name, r):
    return Bench().reader(name).read(r)


def test_the_readers_arithmetic_on_a_snapshot(monkeypatch):
    monkeypatch.setattr(trace, "snapshot", lambda: SNAPSHOT)
    r = _readings()
    got = {name: _read(name, r) for name in READERS}
    assert got["resample_device_ms_per_chunk"] == pytest.approx(1e3 * 0.0744 / 124)  # 0.6 ms
    assert got["logmel_device_ms_per_chunk"] == pytest.approx(1e3 * 0.0372 / 124)  # 0.3 ms
    assert got["scan_edge_device_ms_per_pass"] == pytest.approx(1e3 * (0.1360 - 0.1280 + 0.0164) / 4)  # 6.1 ms
    no_align = {**SNAPSHOT, "spans": {k: v for k, v in SNAPSHOT["spans"].items() if k != "graph.align"}}
    monkeypatch.setattr(trace, "snapshot", lambda: no_align)  # a graph that delays no node's output
    assert _read("scan_edge_device_ms_per_pass", r) == pytest.approx(1e3 * (0.1360 - 0.1280) / 4)
    assert got["graph_host_self_ms_per_pass"] == pytest.approx(1e3 * (0.0008 + 0.0200 + 0.0124) / 4)
    assert got["setup_shape_pass_s"] == 0.93


def test_the_readers_read_nothing_where_there_is_nothing(monkeypatch):
    for r in (_readings(traced=False), _readings(units=0)):  # untraced, or no pass in the stretch
        assert all(_read(name, r) is None for name in READERS)
    r = _readings()
    monkeypatch.setattr(trace, "snapshot", lambda: {"recording": 0, "spans": {}, "first": {}})
    assert all(_read(name, r) is None for name in READERS)  # no recording yet
    host_only = {**SNAPSHOT, "spans": {k: {**v, "device_s": None, "device_count": 0}
                                       for k, v in SNAPSHOT["spans"].items()}}
    monkeypatch.setattr(trace, "snapshot", lambda: host_only)
    assert all(_read(name, r) is None for name in DEVICE)  # no CUDA events: the CPU
    assert _read("graph_host_self_ms_per_pass", r) is not None


def test_the_readers_read_nothing_from_a_program_without_the_tracer(monkeypatch):
    monkeypatch.delattr(audioflow_torch.obs, "trace")
    monkeypatch.setitem(sys.modules, "audioflow_torch.obs.trace", None)
    assert all(_read(name, _readings()) is None for name in READERS)


def test_a_traced_run_on_the_cpu_reports_the_host_readings():
    bench = smallcells.bench()
    result, notes = run_cell(bench, CELL, 2**31 + 17, SECONDS, True, torch.device("cpu"), time.perf_counter(),
                             small_traffic(bench, CELL))
    assert result["correct"], notes
    got = set(result["metrics"]) & set(READERS)
    assert got == {"graph_host_self_ms_per_pass", "setup_shape_pass_s"}
    assert result["metrics"]["graph_host_self_ms_per_pass"]["value"] > 0
    assert result["metrics"]["step_ops.resident"]["value"] > 0
