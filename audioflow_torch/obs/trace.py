"""The port's tracer: spans at the layer boundaries of the program, and a
table of one-time work.

Tracing is on while :func:`enable` is in force or while a torch profiler
records (``torch.profiler.profile``, so ``audioflow bench --profile-dir``
and any profiled run turn it on with no flag of its own). Off, :func:`span`
costs one flag check: no ``record_function``, no CUDA event, no clock read,
no allocation.

An on span records its name, an optional index (the chunk, the node), its
parent (a stack per thread) and its pass: the outermost span open on its
thread when it started (a ``graph.scan_stream`` call and everything inside
it share one). Its host time runs from the end of its entry to the start of
its exit (``time.perf_counter_ns``), so the tracer's own work falls outside
it; its host self time is that less the whole of each child span, the
child's entry and exit included, so a span's self time is its own code's.
Under a profiler it also sits in the trace as an op ``audioflow.<name>``
(torch's fast record function, 1-2 us where ``record_function`` takes
12-15; category ``cpu_op`` in the Chrome trace), on the profiler's clock over
the kernels it launched: the profiler's Chrome trace is the spans' export.

Given a CUDA tensor or device, a span times its device interval by
timing-enabled CUDA events on that device's current stream. Inside a pass
the timed spans of one stream tile it: a timed span opened after another
timed span of its pass on the same stream starts at that span's last event
(a sibling's end, its parent's start) and records only its end, so device
work launched between two timed spans of a pass counts in the later one.
A span given no device whose children time theirs spans from its first
timed child's start to its last one's end, at no event of its own. The
events are read at :func:`snapshot`, outside the traced stretch, and go
back to a pool for the next recording; a recording holding more than
:data:`PENDING_MAX` unread reads the passes the card has finished at a
pass's end, without waiting.

A *recording* is a stretch during which tracing was on: a new one starts at
:func:`enable`, or when a span finds tracing on after the previous one found
it off. Each keeps exact aggregates by span name: count, host total, host
self time and device total. ``enable(records=True)`` also keeps the newest
:data:`RING` raw records, which :func:`records` returns. :func:`snapshot`
reads the newest recording.

:func:`first` records one-time work (a kernel's build and load, the graph's
first shape pass), always and once per name per process, whether tracing is
on or not.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager

import torch

PREFIX = "audioflow."  # a span's name in a profiler's trace; its device copy there is no kernel
RING = 16384  # raw span records a recording keeps, the newest, where asked for
# unread event pairs a recording holds before a pass's end reads the finished
# ones; below it, only snapshot() and records() read them, so that no
# elapsed-time read (7-10 us each on the H100's host) lands in a traced stretch
PENDING_MAX = 1 << 15

_profiler = torch.autograd.profiler  # its ``_is_profiler_enabled`` is True while a profiler records
_Mark = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter_ns

# the two flags the off path reads or writes, module globals because a global
# is the cheapest lookup there is: enable() contexts in force, and whether
# the last span found tracing off
_forced = 0
_lapsed = True


class _Noop:
    """The context of a span while tracing is off, and of work already recorded by :func:`first`."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class Record:
    """One span: ``device_ms`` is None until its events are read, or where it recorded none."""

    __slots__ = ("id", "parent", "pass_id", "name", "index", "start_ns", "end_ns", "device_ms")

    def __init__(self, id, parent, pass_id, name, index, start_ns, end_ns):
        self.id, self.parent, self.pass_id, self.name, self.index = id, parent, pass_id, name, index
        self.start_ns, self.end_ns, self.device_ms = start_ns, end_ns, None


class _Stat:
    __slots__ = ("count", "host_ns", "self_ns", "device_ms", "device_count")

    def __init__(self):
        self.count = self.host_ns = self.self_ns = self.device_count = 0
        self.device_ms = 0.0


class _Recording:
    def __init__(self, number: int, records: bool = False):
        self.number = number
        self.stats: dict[str, _Stat] = {}
        self.records: deque[Record] | None = deque(maxlen=RING) if records else None
        # the passes whose events are not read yet, oldest first:
        # ((stat, record, start event, end event) of each timed span,
        #  (pool, event) of each event the pass recorded, each stream's last event)
        self.pending: deque = deque()
        self.unread = 0  # event pairs in ``pending``

    def resolve(self, wait: bool) -> None:
        """Read the events of the passes the card has finished, waiting for
        the unfinished ones where ``wait``, and give them back to their pools."""
        while self.pending:
            pairs, owned, lasts = self.pending[0]
            if wait:
                for e in lasts:
                    e.synchronize()
            elif not all(e.query() for e in lasts):
                return
            self.pending.popleft()
            self.unread -= len(pairs)
            for stat, rec, e0, e1 in pairs:
                ms = e0.elapsed_time(e1)
                stat.device_ms += ms
                stat.device_count += 1
                if rec is not None:
                    rec.device_ms = ms
            for pool, e in owned:
                pool.append(e)


class _Local(threading.local):
    """A thread's open spans and its open pass's events."""

    def __init__(self):
        self.stack: list[_Span] = []
        self.edges: dict = {}  # lane -> the pass's newest event on its stream
        self.pairs: list = []
        self.owned: list = []


class _Tracer:
    """The process's tracer; :func:`span`, :func:`first`, :func:`enable`
    and :func:`snapshot` act on the one instance."""

    def __init__(self):
        self.recording: _Recording | None = None
        self.numbers = itertools.count(1)
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.local = _Local()
        self.first: dict[str, float] = {}  # name -> seconds of its first run

    def current(self) -> _Recording:
        global _lapsed
        if _lapsed or self.recording is None:
            with self.lock:
                if _lapsed or self.recording is None:
                    self.recording = _Recording(next(self.numbers))
                    _lapsed = False
        return self.recording


_T = _Tracer()


class _Lane:
    """A CUDA stream and its pool of free timing events."""

    __slots__ = ("stream", "pool")

    def __init__(self, stream):
        self.stream, self.pool = stream, deque()


_LANES: dict[tuple, _Lane] = {}  # current-stream triples -> their lanes, made once


def _lane(device) -> _Lane | None:
    """The lane of the current stream of the CUDA device of a tensor, a
    device or a device string; None for any other. Cheaper than
    ``torch.cuda.current_stream``, which builds a new Stream every call."""
    if isinstance(device, torch.Tensor):
        if not device.is_cuda:
            return None
        index = device.get_device()
    else:
        if isinstance(device, str):
            device = torch.device(device)
        if device is None or device.type != "cuda":
            return None
        index = torch.cuda.current_device() if device.index is None else device.index
    key = torch._C._cuda_getCurrentStream(index)  # (stream id, device index, device type)
    lane = _LANES.get(key)
    if lane is None:
        lane = _LANES[key] = _Lane(torch.cuda.Stream(stream_id=key[0], device_index=key[1], device_type=key[2]))
    return lane


def _event(lane, loc):
    """A free event of the lane's pool, recorded on its stream now as the pass's newest there."""
    pool = lane.pool
    e = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    e.record(lane.stream)
    loc.owned.append((pool, e))
    loc.edges[lane] = e
    return e


class _Span:
    __slots__ = ("name", "index", "device", "id", "parent", "pass_id", "child_ns", "in_ns", "start_ns", "mark",
                 "lane", "e0", "e1")

    def __init__(self, name, device, index):
        self.name, self.device, self.index = name, device, index

    def __enter__(self):
        in_ns = _clock()
        t = _T
        t.current()
        loc = t.local
        stack = loc.stack
        self.id = next(t.ids)
        if stack:
            self.parent, self.pass_id = stack[-1].id, stack[-1].pass_id
        else:
            self.parent, self.pass_id = 0, self.id
        stack.append(self)
        self.child_ns = 0
        self.mark = None
        if _profiler._is_profiler_enabled:
            self.mark = _Mark(PREFIX + self.name)
            self.mark.__enter__()
        self.e0 = self.e1 = None
        self.lane = lane = None if self.device is None else _lane(self.device)
        if lane is not None:
            # the pass's newest event on this stream, where there is one, is this span's start
            e0 = loc.edges.get(lane)
            self.e0 = _event(lane, loc) if e0 is None else e0
        self.in_ns = in_ns
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        end_ns = _clock()
        t = _T
        loc = t.local
        if self.lane is not None:
            self.e1 = _event(self.lane, loc)
        if self.mark is not None:
            self.mark.__exit__(*exc)
        stack = loc.stack
        stack.pop()
        up = stack[-1] if stack else None
        if up is not None and self.e1 is not None and up.lane is None:  # an untimed parent spans its timed children
            if up.e0 is None:
                up.e0 = self.e0
            up.e1 = self.e1
        host_ns = end_ns - self.start_ns
        rec = None
        with t.lock:
            r = t.recording
            stat = r.stats.get(self.name)
            if stat is None:
                stat = r.stats[self.name] = _Stat()
            stat.count += 1
            stat.host_ns += host_ns
            stat.self_ns += host_ns - self.child_ns
            if r.records is not None:
                rec = Record(self.id, self.parent, self.pass_id, self.name, self.index, self.start_ns, end_ns)
                r.records.append(rec)
        if self.e1 is not None:
            loc.pairs.append((stat, rec, self.e0, self.e1))
        if up is not None:
            up.child_ns += _clock() - self.in_ns
        elif loc.pairs:  # the pass ends: its events wait to be read
            done = (loc.pairs, loc.owned, list(loc.edges.values()))
            loc.pairs, loc.owned, loc.edges = [], [], {}
            with t.lock:
                r.pending.append(done)
                r.unread += len(done[0])
                if r.unread > PENDING_MAX:
                    r.resolve(wait=False)
        else:
            loc.owned, loc.edges = [], {}
        return False


def span(name: str, device=None, index: int | None = None):
    """A context that records the span ``name`` while tracing is on (see the
    module's docstring). ``device``: a tensor, a device or a device string;
    where it is a CUDA one, the span times its device interval by CUDA
    events on that device's current stream, tiled with the other timed
    spans of its pass. ``index``: the chunk or node the span is for, kept in
    its raw record."""
    global _lapsed
    if _forced or _profiler._is_profiler_enabled:
        return _Span(name, device, index)
    _lapsed = True
    return NOOP


class _First:
    __slots__ = ("name", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            with _T.lock:
                _T.first.setdefault(self.name, time.perf_counter() - self.start)
        return False


def first(name: str):
    """A context that records its seconds under ``name`` the first time it
    completes in this process, traced or not; later, one lookup."""
    if name in _T.first:
        return NOOP
    return _First(name)


@contextmanager
def enable(records: bool = False):
    """Turn tracing on for the block, in a new recording; ``records`` keeps
    its newest :data:`RING` raw span records for :func:`records`."""
    global _forced, _lapsed
    with _T.lock:
        _forced += 1
        _T.recording = _Recording(next(_T.numbers), records)
        _lapsed = False
    try:
        yield
    finally:
        with _T.lock:
            _forced -= 1
            if not _forced and not _profiler._is_profiler_enabled:
                _lapsed = True  # the recording ends here


def snapshot() -> dict:
    """The newest recording, its finished passes' device events waited for
    once: ``{"recording": n (0: none yet), "spans": {name: {"count",
    "host_s", "self_s", "device_s", "device_count"}}, "first": {name:
    seconds}}``; ``device_s`` is the sum of the span's device intervals, over
    ``device_count`` of its spans (None where none recorded events)."""
    r = _T.recording
    out = {"recording": 0, "spans": {}, "first": dict(_T.first)}
    if r is None:
        return out
    with _T.lock:
        r.resolve(wait=True)
        out["recording"] = r.number
        out["spans"] = {
            name: {"count": s.count, "host_s": s.host_ns / 1e9, "self_s": s.self_ns / 1e9,
                   "device_s": s.device_ms / 1e3 if s.device_count else None, "device_count": s.device_count}
            for name, s in r.stats.items()
        }
    return out


def records() -> list[Record]:
    """The newest recording's raw records (the newest :data:`RING`, where it
    was made by ``enable(records=True)``; else none), in the order they
    ended, device intervals read as :func:`snapshot` does."""
    r = _T.recording
    if r is None or r.records is None:
        return []
    with _T.lock:
        r.resolve(wait=True)
        return list(r.records)
