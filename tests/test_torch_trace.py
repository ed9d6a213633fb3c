"""``audioflow_torch.obs.trace``, the port's tracer, on the CPU: the off path
touches neither the profiler nor the clock, the spans of a ``scan_stream``
pass nest and count exactly in the tracer's records and in a profiler's
Chrome trace, a span's self time holds its own code's time and none of the
tracer's, recordings start where tracing turns on, and one-time work (the
graph's first shape pass, each successful nvcc build) is recorded once.
"""

import json
import os
import stat
import threading
import time
import uuid

import pytest
import torch

from audioflow_torch.errors import AudioError
from audioflow_torch.models import log_mel_frontend
from audioflow_torch.obs import trace
from audioflow_torch.ops.kernels import _build

CHUNK = 14112  # the benchmark's chunk of the headline graph at 44.1 kHz
CHUNKS = 3
ROWS = 2
NODES = ("node.Resample", "node.LogMelSpec")


@pytest.fixture(scope="module")
def graph():
    return log_mel_frontend()  # Resample(44100 -> 16000, kaiser), LogMelSpec(1024, 256, 128)


@pytest.fixture(scope="module")
def x():
    return torch.randn(ROWS, CHUNK * CHUNKS, generator=torch.Generator().manual_seed(0))


def _traced_pass(graph, x):
    with trace.enable(records=True):
        y = graph.scan_stream(x, CHUNK)
    return y, trace.snapshot(), trace.records()


def _aligns(graph, chunks):
    """The ``graph.align`` spans a pass of ``chunks`` chunks opens: a
    node's input zeroed in its warmup, a node's delayed output aligned."""
    lens, warmups = graph.chunk_lens(CHUNK), graph._warmups(CHUNK)
    pendings = graph.init_state(CHUNK, (ROWS,))[1]
    zeroed = sum(min(n, w - k * n) > 0 and not node.warmup_passthrough
                 for k in range(chunks) for node, n, w in zip(graph.nodes, lens, warmups))
    return zeroed + chunks * sum(p is not None for p in pendings)


def test_off_spans_touch_neither_the_profiler_nor_the_clock(graph, x, monkeypatch):
    want = graph.scan_stream(x, CHUNK)  # the first shape pass is behind us
    before = trace.snapshot()

    def forbidden(*args, **kwargs):
        raise AssertionError("the off path reached the profiler, the clock or a CUDA event")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(trace, "_Mark", forbidden)
    monkeypatch.setattr(trace, "_clock", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    got = graph.scan_stream(x, CHUNK)
    assert torch.equal(got, want)
    assert trace.snapshot() == before  # no recording started, nothing added


def test_the_spans_of_a_pass_count_nest_and_share_its_id(graph, x):
    y, snap, recs = _traced_pass(graph, x)
    assert torch.equal(y, graph.scan_stream(x, CHUNK))
    spans = snap["spans"]
    want = {"graph.scan_stream": 1, "graph.init_state": 1, "graph.stream_step": CHUNKS, "graph.concat": 1,
            "graph.align": _aligns(graph, CHUNKS)}
    want.update({n: CHUNKS for n in NODES})
    assert want["graph.align"] >= CHUNKS  # the resampler's output waits for the log-mel's latency
    assert {k: v["count"] for k, v in spans.items()} == want
    assert all(v["device_s"] is None and v["device_count"] == 0 for v in spans.values())  # no card here
    assert len(recs) == sum(want.values())
    by_id = {r.id: r for r in recs}
    (root,) = [r for r in recs if r.name == "graph.scan_stream"]
    assert root.parent == 0 and {r.pass_id for r in recs} == {root.id}
    steps = sorted((r for r in recs if r.name == "graph.stream_step"), key=lambda r: r.index)
    assert [s.index for s in steps] == list(range(CHUNKS))
    for r in recs:
        if r.name in ("graph.init_state", "graph.stream_step", "graph.concat"):
            assert r.parent == root.id
        elif r.name in NODES:
            assert by_id[r.parent].name == "graph.stream_step" and r.index == NODES.index(r.name)
        elif r.name == "graph.align":
            assert by_id[r.parent].name == "graph.stream_step" and r.index in (0, 1)
        assert by_id.get(r.parent, root).start_ns <= r.start_ns <= r.end_ns <= by_id.get(r.parent, root).end_ns
    # host time sums the records; self time is the duration less the whole
    # of each child, its entry and exit included: exact for a leaf, below
    # the duration less the children's durations for a parent
    children = {r.id: 0 for r in recs}
    for r in recs:
        if r.parent:
            children[r.parent] += r.end_ns - r.start_ns
    for name, v in spans.items():
        own = [r for r in recs if r.name == name]
        assert round(v["host_s"] * 1e9) == sum(r.end_ns - r.start_ns for r in own)
        if all(children[r.id] == 0 for r in own):
            assert round(v["self_s"] * 1e9) == round(v["host_s"] * 1e9)
        else:
            assert 0 <= round(v["self_s"] * 1e9) <= sum(r.end_ns - r.start_ns - children[r.id] for r in own)


class _Clock:
    """A clock that only the test's own work moves: what the tracer does costs it nothing."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(trace, "_clock", clock)
    with trace.enable(records=True):
        with trace.span("test.parent"):
            clock.now += 5
            with trace.span("test.child", index=0):
                clock.now += 3
                with trace.span("test.leaf"):
                    clock.now += 2
            with trace.span("test.child", index=1):
                clock.now += 7
            clock.now += 1
    spans = trace.snapshot()["spans"]
    ns = {k: (round(v["host_s"] * 1e9), round(v["self_s"] * 1e9)) for k, v in spans.items()}
    assert ns == {"test.parent": (18, 6), "test.child": (12, 10), "test.leaf": (2, 2)}


class _SlowLock:
    """The tracer's lock, slowed down: its bookkeeping then takes measurable time."""

    def __init__(self, seconds):
        self.lock, self.seconds = threading.Lock(), seconds

    def __enter__(self):
        time.sleep(self.seconds)
        self.lock.acquire()

    def __exit__(self, *exc):
        self.lock.release()


def test_the_tracers_own_work_is_in_no_parents_self_time(monkeypatch):
    """A parent whose body only opens children reads a self time near zero,
    however long the children's entry and exit take."""
    monkeypatch.setattr(trace._T, "lock", _SlowLock(0.002))
    children = 10
    with trace.enable():
        with trace.span("test.parent"):
            for i in range(children):
                with trace.span("test.child", index=i):
                    pass
    spans = trace.snapshot()["spans"]
    parent = spans["test.parent"]
    assert spans["test.child"]["count"] == children
    assert parent["host_s"] >= children * 0.002  # the children's bookkeeping is inside the parent
    assert parent["self_s"] < 0.1 * parent["host_s"]  # and none of it is the parent's own


def test_a_profiler_trace_holds_the_spans_nested(graph, x, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    graph.scan_stream(x, CHUNK)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graph.scan_stream(x, CHUNK)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    marks = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("audioflow.")]

    def inside(name, outer):
        return [m for m in marks if m[0] == name and outer[1] <= m[1] and m[2] <= outer[2]]

    (scan,) = [m for m in marks if m[0] == "audioflow.graph.scan_stream"]
    steps = inside("audioflow.graph.stream_step", scan)
    assert len(steps) == CHUNKS
    for step in steps:
        assert [len(inside(f"audioflow.{n}", step)) for n in NODES] == [1, 1]
    assert len([m for step in steps for m in inside("audioflow.graph.align", step)]) == _aligns(graph, CHUNKS)
    assert len(inside("audioflow.graph.concat", scan)) == len(inside("audioflow.graph.init_state", scan)) == 1
    # the profiler turned the spans on: its stretch is the newest recording
    assert trace.snapshot()["spans"]["graph.stream_step"]["count"] == CHUNKS


def test_a_new_recording_starts_where_tracing_turns_on_again(graph, x):
    from torch.profiler import ProfilerActivity, profile

    _, first_rec, _ = _traced_pass(graph, x)
    with trace.enable():
        with trace.span("test.items"):
            pass
    snap = trace.snapshot()
    assert snap["recording"] == first_rec["recording"] + 1
    assert {k: v["count"] for k, v in snap["spans"].items()} == {"test.items": 1}
    assert trace.records() == []  # a recording keeps no raw records unless asked
    graph.scan_stream(x, CHUNK)  # off
    with profile(activities=[ProfilerActivity.CPU]):
        graph.scan_stream(x, CHUNK)
        graph.scan_stream(x, CHUNK)
    snap = trace.snapshot()
    assert snap["recording"] == first_rec["recording"] + 2 and "test.items" not in snap["spans"]
    assert snap["spans"]["graph.scan_stream"]["count"] == 2
    assert snap["spans"]["node.Resample"]["count"] == 2 * CHUNKS


def test_first_use_is_recorded_once_per_name(graph):
    graph.init_state(CHUNK, (ROWS,))
    shape_pass = trace.snapshot()["first"]["graph.shape_pass"]
    assert shape_pass > 0
    graph.init_state(CHUNK, (ROWS,))
    assert trace.snapshot()["first"]["graph.shape_pass"] == shape_pass
    name = f"test.once.{uuid.uuid4().hex}"
    with trace.first(name):
        time.sleep(0.02)
    assert trace.first(name) is trace.NOOP
    with trace.first(name):
        time.sleep(0.2)
    assert 0.02 <= trace.snapshot()["first"][name] < 0.2
    failing = f"test.fails.{uuid.uuid4().hex}"
    with pytest.raises(ValueError):
        with trace.first(failing):
            raise ValueError
    assert failing not in trace.snapshot()["first"]


FAKE_NVCC = """#!/bin/sh
# a stand-in for nvcc: sleeps the seconds its source holds, then writes the
# output; fails on a source that says so
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
body="$(cat "$src")"
if [ "$body" = fail ]; then echo "error: stand-in failure"; exit 1; fi
sleep "$body"
echo "ptxas info: 0 registers" && : > "$out"
"""


def test_each_nvcc_build_records_its_own_seconds(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    tag = uuid.uuid4().hex[:8]
    quick, slow = f"quick{tag}", f"slow{tag}"
    (csrc / f"{quick}.cu").write_text("0.1")
    (csrc / f"{slow}.cu").write_text("0.8")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    # the slow source first: timed from one start, the quick one would read its seconds too
    _build._compile([slow, quick])
    first = trace.snapshot()["first"]
    assert 0.1 <= first[f"kernels.build.{quick}"] < 0.6
    assert first[f"kernels.build.{slow}"] >= 0.8
    assert all(os.path.exists(_build._library(n)) for n in (quick, slow))
    assert "ptxas info" in _build.BUILD_LOG[quick]
    assert not hasattr(_build, "BUILD_SECONDS")
    # a failed build records nothing, so its retry in the same process is timed
    broken = f"broken{tag}"
    (csrc / f"{broken}.cu").write_text("fail")
    with pytest.raises(AudioError, match=f"nvcc failed on {broken}.cu"):
        _build._compile([broken])
    assert f"kernels.build.{broken}" not in trace.snapshot()["first"]
    assert "stand-in failure" in _build.BUILD_LOG[broken]
    (csrc / f"{broken}.cu").write_text("0.1")
    _build._compile([broken])
    assert 0.1 <= trace.snapshot()["first"][f"kernels.build.{broken}"] < 0.6
