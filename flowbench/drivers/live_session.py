"""Open loop of live streams through one ``StreamSession``: every
``push_ms`` each stream pushes its next ``push_ms`` of capture, on a
schedule that does not slow when the program does.

Traffic keys: ``signal`` (a recipe of :mod:`flowbench.signals`, held in
pageable host memory as a capture holds it), ``streams`` (the session's
lead shape), ``push_ms`` (the audio of a push, pushed every ``push_ms``
unless ``push_every_ms`` sets a faster schedule, as a sweep for the
session's capacity does), ``warm_seconds`` (pushed through a session of
their own in set-up), ``trace_seconds``. The session takes its default
chunk. For each push that completes a chunk, the latency runs from the
moment the push was due to the moment every branch of the chunk's results
is in host memory. Every chunk of the window is compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flowbench import signals
from flowbench.case import Window, build_graph, input_rate, steady_step_ops, trim


def _wait_until(due: float) -> None:
    while True:
        left = due - time.perf_counter()
        if left <= 0:
            return
        if left > 2e-3:
            time.sleep(left - 1e-3)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class Case:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.rate = input_rate(ctx.config)
        self.push = round(self.rate * t["push_ms"] / 1e3)
        self.period = t.get("push_every_ms", t["push_ms"]) / 1e3
        self.streams = t["streams"]
        self.n_warm = round(t["warm_seconds"] * 1e3 / t["push_ms"])
        self.n_push = round(ctx.seconds / self.period)
        self.audio = None

    def _session(self):
        from audioflow_torch.session import StreamSession

        return StreamSession(self.graph, lead_shape=(self.streams,), device=self.ctx.device).open()

    def _pushes(self, first, count):
        for i in range(first, first + count):
            yield self.audio[:, i * self.push : (i + 1) * self.push]

    def setup(self):
        ctx = self.ctx
        with ctx.part("inputs"):
            self.audio = self._audio()
        with ctx.part("graph"):
            self.graph = build_graph(ctx.config)
        with ctx.part("warm session"):
            warm = self._session()
            for piece in self._pushes(0, self.n_warm):
                if warm.push(piece):
                    [r.data for r in warm.poll_all()]
            warm.close()
        with ctx.part("open"):
            self.sess = self._session()

    def _audio(self) -> np.ndarray:
        t = self.ctx.traffic
        total = (self.n_warm + self.n_push) * self.push
        return _host(signals.make(t["signal"], self.streams, total, self.rate, self.ctx.seed, self.ctx.device))

    def inputs(self):
        """The window's capture, ``[streams, T]`` on the device, and its rate."""
        if self.audio is None:
            self.audio = self._audio()
        a = self.n_warm * self.push
        return torch.from_numpy(self.audio[:, a : a + self.n_push * self.push]).to(self.ctx.device), self.rate

    def window(self, seconds, tracer) -> Window:
        spans = self.ctx.spans
        latency, host, late, outs = [], [], [], []
        tracer.begin()
        t0 = time.perf_counter() + 1e-3
        for i, piece in enumerate(self._pushes(self.n_warm, self.n_push)):
            due = t0 + i * self.period
            with spans.span("schedule.wait"):
                _wait_until(due)
            sent = time.perf_counter()
            late.append(sent - due)
            traced = tracer.active
            with spans.span("session.push"):
                k = self.sess.push(piece)
            if not k:
                continue
            with spans.span("session.poll_all"):
                results = self.sess.poll_all()
            polled = time.perf_counter()
            with spans.span("result.host_copy"):
                outs += [r.data for r in results]
            done = time.perf_counter()
            latency += [done - due] * len(results)
            if not traced:
                host += [(polled - sent) / len(results)] * len(results)
            tracer.poll(len(results))
        self.outs = outs
        due_chunks = self.n_push * self.push // self.sess.chunk_in
        return Window(
            {"chunk_latency_s": latency, "session_host_s": host},
            attempted=due_chunks,
            failed=due_chunks - len(outs),
            notes={
                "chunks": len(outs),
                "chunk_in": self.sess.chunk_in,
                "late_ms_max": 1e3 * max(late),
                "late_ms_p95": 1e3 * float(np.percentile(late, 95)),
                "late_ms_last": 1e3 * late[-1],
            },
        )

    def outputs(self):
        first = self.outs[0]
        if isinstance(first, dict):
            cat = {k: np.concatenate([o[k] for o in self.outs], axis=1) for k in first}
        else:
            cat = np.concatenate(self.outs, axis=1)
        latency = self.graph.stream_latency(self.sess.chunk_in)
        signal, rate = self.inputs()
        return signal, rate, {k: torch.from_numpy(v) for k, v in trim(cat, latency).items()}

    def step_ops(self) -> int:
        chunk = torch.from_numpy(np.ascontiguousarray(self.audio[:, : self.sess.chunk_in])).to(self.ctx.device)
        return steady_step_ops(self.graph, chunk, (self.streams,))

    def release(self):
        if getattr(self, "sess", None) is not None:
            self.sess.close()
        self.graph = self.sess = self.outs = None
