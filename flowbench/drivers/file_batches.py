"""Batch feature extraction over a corpus of WAV files: ``runner.run_batches``
with a ``BatchLoader`` and the native decoder, cycling through the corpus
for the window.

Traffic keys: ``signal`` (a recipe of :mod:`flowbench.signals`, written as
16-bit mono WAV files at the graph's input rate under ``TMPDIR`` in set-up),
``files``, ``clip_seconds``, ``batch``, ``stride_multiple`` (the loader's
stride is the clip rounded up to it, as ``audioflow run`` sets it),
``warm_laps`` (laps of the corpus run in set-up), ``laps_cap`` (the corpus is
listed that many times over; the window ends at its deadline long before),
``sample_batches`` (a sample of the window's batches, drawn from the seed,
is kept for the comparison), ``trace_seconds``. Files that fail to decode
count as failed.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from flowbench import signals
from flowbench.case import Window, build_graph, input_rate


class _Deadline:
    """What ``run_batches`` takes as its loader: the loader's batches up to
    a deadline, each one's decode time and files recorded."""

    def __init__(self, loader, deadline, spans, tracer, index):
        self.loader, self.deadline, self.spans, self.tracer, self.index = loader, deadline, spans, tracer, index
        self.batch_size, self.stride = loader.batch_size, loader.stride
        self.decode_s, self.files, self.order = [], 0, []
        self.failed = 0

    def batches(self, pin_memory=False):
        gen = self.loader.batches(pin_memory=pin_memory)
        try:
            while True:
                with self.spans.span("loader.next"):
                    batch = next(gen, None)
                if batch is None:
                    return
                if not self.tracer.active:
                    self.decode_s.append(batch.decode_seconds)
                self.files += len(batch.paths)
                self.failed += int((~batch.valid).sum())
                self.order.append([self.index[p] for p, ok in zip(batch.paths, batch.valid) if ok])
                yield batch
                self.tracer.poll()
                if time.perf_counter() >= self.deadline:
                    return
        finally:
            gen.close()


class _Sample:
    """A sink that keeps a uniform sample of ``k`` of the batches it is
    given (reservoir sampling from ``rng``) and counts the rest."""

    def __init__(self, k, rng, spans):
        self.k, self.rng, self.spans = k, rng, spans
        self.kept: list[tuple[int, np.ndarray]] = []
        self.batches = self.rows = 0

    def write(self, host) -> None:
        with self.spans.span("sink.write"):
            b = self.batches
            self.batches += 1
            self.rows += len(host)
            if len(self.kept) < self.k:
                self.kept.append((b, host))
            else:
                j = int(self.rng.integers(0, b + 1))
                if j < self.k:
                    self.kept[j] = (b, host)

    def close(self):
        return None


class Case:
    def __init__(self, ctx):
        self.ctx = ctx
        self.rate = input_rate(ctx.config)
        self.dir = None

    def setup(self):
        from audioflow_torch.io import BatchLoader
        from audioflow_torch.runner import run_batches

        t, ctx = self.ctx.traffic, self.ctx
        n = int(t["clip_seconds"] * self.rate)
        with ctx.part("inputs"):
            self.pcm = self._pcm()
        with ctx.part("files"):
            self.dir = Path(tempfile.mkdtemp(prefix="flowbench-files-"))
            self.paths = [str(self.dir / f"{i:05d}.wav") for i in range(t["files"])]
            for path, row in zip(self.paths, self.pcm):
                signals.write_wav(Path(path), row, self.rate)
        self.index = {p: i for i, p in enumerate(self.paths)}
        self.stride = -(-n // t["stride_multiple"]) * t["stride_multiple"]
        with ctx.part("graph"):
            self.graph = build_graph(ctx.config)
        self._run = run_batches
        self._loader = lambda laps: BatchLoader(self.paths * laps, batch_size=t["batch"], stride=self.stride)
        with ctx.part("warm laps"):
            run_batches(self.graph, self._loader(t["warm_laps"]), sinks=[], device=ctx.device)

    def _pcm(self) -> np.ndarray:
        t = self.ctx.traffic
        n = int(t["clip_seconds"] * self.rate)
        return signals.to_pcm16(signals.make(t["signal"], t["files"], n, self.rate, self.ctx.seed, self.ctx.device))

    def _signal(self, files) -> torch.Tensor:
        """The decoded samples of ``files`` as the runner pads them: ``[rows, stride]``."""
        pcm = torch.from_numpy(self.pcm[files]).to(self.ctx.device)
        return torch.nn.functional.pad(pcm.to(torch.float32) / 32768.0, (0, self.stride - pcm.shape[1]))

    def inputs(self):
        """As many files as a run compares (the corpus in its order, cycled),
        decoded and padded, and their rate."""
        t = self.ctx.traffic
        n = int(t["clip_seconds"] * self.rate)
        self.pcm = self._pcm()
        self.stride = -(-n // t["stride_multiple"]) * t["stride_multiple"]
        files = [i % t["files"] for i in range(t["sample_batches"] * t["batch"])]
        return self._signal(files), self.rate

    def window(self, seconds, tracer) -> Window:
        t, spans = self.ctx.traffic, self.ctx.spans
        sink = _Sample(t["sample_batches"], signals.rng(self.ctx.seed, 1), spans)
        tracer.begin()
        t0 = time.perf_counter()
        self.win = _Deadline(self._loader(t["laps_cap"]), t0 + seconds, spans, tracer, self.index)
        with spans.span("runner.run_batches"):
            self._run(self.graph, self.win, sinks=[sink], device=self.ctx.device)
        wall = time.perf_counter() - t0
        self.sink = sink
        return Window(
            {"audio_s": sink.rows * t["clip_seconds"], "wall_s": wall, "decode_s": self.win.decode_s},
            attempted=self.win.files,
            failed=self.win.failed,
            notes={"batches": sink.batches, "files": self.win.files, "failed": self.win.failed},
        )

    def outputs(self):
        kept = sorted(self.sink.kept, key=lambda bh: bh[0])
        files = [i for b, _ in kept for i in self.win.order[b]]
        out = torch.from_numpy(np.concatenate([h for _, h in kept]))
        return self._signal(files), self.rate, {"out": out}

    def step_ops(self) -> int:
        return 0

    def release(self):
        self.graph = self.sink = None
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None
