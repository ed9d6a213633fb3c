"""Closed loop over audio that sits on the card: ``Graph.scan_stream`` passes
back to back for the whole window.

Traffic keys: ``signal`` (a recipe of :mod:`flowbench.signals`, made on the
card), ``clips``, ``clip_seconds`` (cut to whole chunks), ``chunk_target``
(the chunk is the graph's granularity times as many as fit in it),
``warm_passes``, ``compare_clips``, ``trace_seconds``. The window is timed
by CUDA events around all of it; the last pass's output is compared, on
``compare_clips`` clips drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flowbench import signals
from flowbench.case import Window, build_graph, input_rate, steady_step_ops, trim


def _per_slice(ends: list[float], width: float) -> list[int]:
    counts = [0] * (int(max(ends, default=0) // width) + 1)
    for e in ends:
        counts[int(e // width)] += 1
    return counts


class Case:
    def __init__(self, ctx):
        self.ctx = ctx
        self.rate = input_rate(ctx.config)
        gran = build_graph(ctx.config).chunk_granularity()
        self.chunk = gran * max(1, ctx.traffic["chunk_target"] // gran)

    def setup(self):
        t, ctx = self.ctx.traffic, self.ctx
        with ctx.part("graph"):
            self.graph = build_graph(ctx.config)
        with ctx.part("inputs"):
            self.x = self._clips()
        for i in range(t["warm_passes"]):
            with ctx.part(f"warm pass {i}"):
                self.graph.scan_stream(self.x, self.chunk)

    def _clips(self) -> torch.Tensor:
        t = self.ctx.traffic
        n = int(t["clip_seconds"] * self.rate) // self.chunk * self.chunk
        return signals.make(t["signal"], t["clips"], n, self.rate, self.ctx.seed, self.ctx.device)

    def inputs(self):
        """The clips a run compares, ``[compare_clips, T]`` on the card, and their rate."""
        return self._clips()[self._sample()], self.rate

    def window(self, seconds, tracer) -> Window:
        dev, spans = self.ctx.device, self.ctx.spans
        cuda = dev.type == "cuda"
        passes, ends = 0, []
        tracer.begin()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        while True:
            with spans.span("graph.scan_stream"):
                out = self.graph.scan_stream(self.x, self.chunk)
            passes += 1
            tracer.poll()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        if cuda:
            end.record()
            end.synchronize()
            wall = start.elapsed_time(end) / 1e3
        else:
            wall = time.perf_counter() - t0
        self.last = out
        audio = passes * self.x.shape[0] * self.x.shape[1] / self.rate
        return Window(
            {"audio_s": audio, "wall_s": wall, "chunk_in": self.chunk, "rows": self.x.shape[0]},
            attempted=passes,
            failed=0,
            notes={"passes": passes, "chunk": self.chunk, "passes by 5 s": _per_slice(ends, 5.0)},
        )

    def outputs(self):
        latency = self.graph.stream_latency(self.chunk)
        rows = self._sample()
        return self.x[rows], self.rate, trim(self.last[rows], latency)

    def _sample(self) -> torch.Tensor:
        clips, k = self.ctx.traffic["clips"], self.ctx.traffic["compare_clips"]
        pick = signals.rng(self.ctx.seed, 1).choice(clips, size=min(k, clips), replace=False)
        return torch.from_numpy(np.sort(pick)).to(self.ctx.device)

    def step_ops(self) -> int:
        return steady_step_ops(self.graph, self.x[:, : self.chunk].contiguous(), (self.x.shape[0],))

    def release(self):
        self.graph = self.last = None
