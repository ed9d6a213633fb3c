"""The benchmark's own spans around its calls into each layer of the program.

Each span is timed on the host clock and, while a trace is on, also lands in
the profiler's trace as a user annotation named ``flowbench.<name>``, so that
the trace can say what the host was doing in each idle gap of the device.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class Spans:
    """Host spans in memory: ``records`` holds ``(name, start, end)`` in
    seconds of ``time.perf_counter``."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []

    @contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(f"flowbench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.records.append((name, t0, time.perf_counter()))
