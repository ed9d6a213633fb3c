"""What a driver is given and what it gives back, and the helpers drivers share.

A driver module (``flowbench/drivers/<name>.py``) defines ``Case(ctx)`` with:

* ``setup()``: the inputs from the seed, the program's entry point built
  from the configuration, every shape of the window warmed up;
* ``window(seconds, tracer) -> Window``: the measured window;
* ``outputs() -> (signal, rate, outputs)``: the window's inputs that the
  reference reads, ``[rows, T]`` at ``rate``, and the program's outputs
  compared with it, by branch, the stream's latency taken off;
* ``step_ops() -> int``: the aten ops of one steady step of the cell's graph;
* ``release()``: drop the program's state;
* ``inputs() -> (signal, rate)``: the inputs a run compares, made without
  the program (the control's).

Drivers reach the program only through its public entry points.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from .spans import Spans


@dataclass
class Context:
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: torch.device
    spans: Spans = field(default_factory=Spans)
    setup_parts: dict = field(default_factory=dict)  # set-up seconds by part, for standard error

    @contextmanager
    def part(self, name: str):
        """Time a part of the set-up (the device synchronised at its end)."""
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + time.perf_counter() - t0


@dataclass
class Window:
    """A window's raw readings: ``samples`` by name for the metrics' readers
    (host-clock samples of the spans, counts), work ``attempted`` and
    ``failed``, and ``notes`` for the run's standard error."""

    samples: dict
    attempted: int
    failed: int
    notes: dict = field(default_factory=dict)


def build_graph(config: dict):
    """The program's graph (``graph``) or fork (``fork``) of a configuration,
    through the program's graph specs."""
    from audioflow_torch.config import fork_from_spec, graph_from_spec

    if "fork" in config:
        return fork_from_spec(config["fork"])
    return graph_from_spec(config["graph"])


def input_rate(config: dict) -> int:
    return int((config["fork"]["trunk"] if "fork" in config else config["graph"])["input_rate"])


def aten_ops(fn) -> int:
    """The aten ops one call of ``fn`` runs, views left out, counted exactly
    by a dispatch mode (a frozen copy of ``audioflow_torch.profiling.aten_ops``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func is not torch.ops.aten._unsafe_view.default:
                self.n += 1
            return func(*args, **(kwargs or {}))

    with CountOps() as ops:
        fn()
    return ops.n


def steady_step_ops(graph, chunk: torch.Tensor, lead: tuple) -> int:
    """Aten ops of the second step of a fresh stream of ``graph`` over
    ``chunk`` (the first also zeroes the preroll)."""
    state = graph.init_state(chunk.shape[-1], lead, chunk.dtype, chunk.device)
    state, _ = graph.stream_step(state, chunk)
    return aten_ops(lambda: graph.stream_step(state, chunk))


def trim(outputs, latency) -> dict:
    """The program's streamed outputs ``{branch: [rows, positions, ...]}``
    (or one tensor, branch ``"out"``) with each branch's stream latency
    (``graph.stream_latency``: an int, or a dict by branch) taken off the
    front, so that position ``i`` is the offline output's ``i``."""
    if not isinstance(outputs, dict):
        outputs, latency = {"out": outputs}, {"out": latency}
    return {k: v[:, latency[k]:] for k, v in outputs.items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
