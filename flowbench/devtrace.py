"""The traced stretch of a window: torch.profiler on the host and the card,
reduced to what the per-layer metrics and the breakdown read.

:class:`Tracer` starts the profiler when the window starts and stops it after
``seconds`` (the device synchronised at both ends, the stretch marked by the
user annotation ``flowbench.traced``). :func:`reduce` reads the exported
Chrome trace: the device's busy time (the union of its kernels, copies and
sets inside the stretch), each kernel's time and recorded launches, and the
device's idle gaps, each split over the innermost ``flowbench.*`` span the
host was inside meanwhile ("outside any span" where it was in none).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "flowbench.traced"
OUTSIDE = "outside any span"


@dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)  # device op name -> [seconds, recorded launches]
    idle: dict = field(default_factory=dict)  # host span -> idle seconds of the device
    events: int = 0  # device events recorded in the stretch
    launches: dict = field(default_factory=dict)  # the program's kernel launch counters over the stretch


def kernel_counts() -> dict:
    """The launch counters (``COUNT.launches``) of the program's hand-written
    kernels that are loaded, by kernel module."""
    prefix = "audioflow_torch.ops.kernels."
    return {
        name[len(prefix):]: mod.COUNT.launches
        for name, mod in list(sys.modules.items())
        if name.startswith(prefix) and hasattr(getattr(mod, "COUNT", None), "launches")
    }


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _leaf_segments(spans, lo, hi):
    """``[(start, end, name)]`` tiling ``[lo, hi]`` by the innermost span
    active at each instant (spans nest: a later start inside an earlier span
    is deeper)."""
    cuts = sorted({lo, hi, *(t for a, b, _ in spans for t in (a, b) if lo < t < hi)})
    ordered = sorted(spans, key=lambda s: (s[0], -s[1]))
    segs, stack, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        while k < len(ordered) and ordered[k][0] <= mid:
            while stack and stack[-1][1] <= ordered[k][0]:
                stack.pop()
            stack.append(ordered[k])
            k += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        segs.append((a, b, stack[-1][2] if stack else OUTSIDE))
    return segs


def reduce(events: list[dict]) -> Summary:
    """The :class:`Summary` of a Chrome trace's ``traceEvents``."""
    marks = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    win = [e for e in marks if e["name"] == WINDOW]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    lo, hi = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    spans = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"].removeprefix("flowbench."))
        for e in marks
        if e["name"].startswith("flowbench.") and e["name"] != WINDOW
    ]
    dev = []
    ops: dict = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        dev.append((a, b))
        tot = ops.setdefault(e["name"], [0.0, 0])
        tot[0] += (b - a) / 1e6
        tot[1] += 1
    busy = _union(dev)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    idle: dict = {}
    segs = _leaf_segments([s for s in spans if s[1] > lo and s[0] < hi], lo, hi)
    i = 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            a, b, name = segs[j]
            idle[name] = idle.get(name, 0.0) + (min(b, g1) - max(a, g0)) / 1e6
            j += 1
    return Summary((hi - lo) / 1e6, sum(b - a for a, b in busy) / 1e6, ops, idle, len(dev))


class Tracer:
    """torch.profiler over the first ``seconds`` of a window. The driver
    calls :meth:`begin` as the window starts and :meth:`poll` after each
    unit of work (a pass, a chunk, a batch), which counts the units done
    inside the stretch and ends it once ``seconds`` have passed."""

    def __init__(self, seconds: float, device: torch.device):
        self.seconds = seconds
        self.device = device
        self.units = 0
        self.summary: Summary | None = None
        self._prof = None
        self._mark = None
        self._counts: dict = {}
        self._t0 = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._sync()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self._counts = kernel_counts()
        self._t0 = time.perf_counter()

    def poll(self, units: int = 1) -> None:
        if self._prof is None:
            return
        self.units += units
        if time.perf_counter() - self._t0 >= self.seconds:
            self.end()

    def end(self) -> None:
        if self._prof is None:
            return
        self._sync()
        launches = {k: v - self._counts.get(k, 0) for k, v in kernel_counts().items()}
        self._mark.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="flowbench-trace-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.summary = reduce(json.load(f)["traceEvents"])
            self.summary.launches = launches
        finally:
            os.remove(path)


class NoTracer:
    """The tracer of an untraced run: every call does nothing."""

    active = False
    units = 0
    summary = None

    def begin(self) -> None:
        pass

    def poll(self, units: int = 1) -> None:
        pass

    def end(self) -> None:
        pass
