"""The streaming session: open -> push -> poll -> flush/close.

Mirrors ``audioflow_tpu/session/__init__.py``, the session layer of the
dictation app, with the stream graph on the card as the "service":

* ``push(samples)`` lands irregular host pushes in a staging accumulator on
  the graph's device (:class:`audioflow_torch.ops.ring.Staging`) and steps
  every full chunk; the chunk count is tracked on the host, so a push reads
  nothing back from the card;
* each chunk stepped yields a **partial** :class:`Result` whose ``data`` is
  copied to the host on first access only, so a push loop with no eager
  consumer runs at the card's pace; ``flush()`` zero-pads the tail and
  yields the **committed** final result;
* ``poll()``/``poll_all()`` drain the result queue;
* ``snapshot()``/``restore()`` persist the state in the JAX package's
  ``.npz`` format (:mod:`audioflow_torch.convert`), so a snapshot of either
  package restores in the other.

The JAX package pads each staging write to a power-of-two bucket width, so
that jit compiles a handful of shapes. Eager torch compiles nothing per
shape, so the port writes each piece at its own width: the chunks stepped
are the same.
"""

from __future__ import annotations

import enum
import queue
import time
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from ..convert import state_from_leaves, state_leaves
from ..errors import ErrorCode, SessionError
from ..graph import Graph  # noqa: F401  (re-exported, as in the JAX package)
from ..obs import StatsFile, get_logger
from ..ops import ring as _ring
from ..sinks import EventDispatcher, Sink
from ..utils import resolve_device

_log = get_logger("session")


class SessionState(enum.Enum):
    IDLE = "idle"
    OPEN = "open"
    CLOSED = "closed"
    FAILED = "failed"


def _to_host(tree):
    """Tensors of a tensor or a ``{name: tensor}`` dict as numpy arrays."""
    if isinstance(tree, dict):
        return {k: v.cpu().numpy() for k, v in tree.items()}
    return tree.cpu().numpy()


class _Stacked:
    """The outputs of one multi-chunk drain, shared by its ``b`` Results:
    stacked and copied to the host once, on the first access by any of them."""

    __slots__ = ("_outs", "_host")

    def __init__(self, outs: list):
        self._outs = outs
        self._host = None

    def fetch(self):
        if self._host is None:
            outs = self._outs
            if isinstance(outs[0], dict):
                stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
            else:
                stacked = torch.stack(outs)
            self._host = _to_host(stacked)
            self._outs = None
        return self._host


class Result:
    """Output of one chunk (partial) or of the end of the stream (final).

    ``data`` copies the output from the card to the host on first access, so
    producing results never makes the push loop wait on the card."""

    __slots__ = ("_raw", "_host", "_stacked", "_j", "final", "index", "timestamp")

    def __init__(
        self,
        data,
        final: bool,
        index: int,
        timestamp: float | None = None,
        _stacked: _Stacked | None = None,
        _j: int = 0,
    ):
        self._raw = data
        self._host = None
        self._stacked = _stacked
        self._j = _j
        self.final = final
        self.index = index
        self.timestamp = time.time() if timestamp is None else timestamp

    @property
    def data(self):
        if self._host is None:
            if self._stacked is not None:
                # one shared copy for the whole drained block, a view per chunk
                host = self._stacked.fetch()
                j = self._j
                self._host = {k: v[j] for k, v in host.items()} if isinstance(host, dict) else host[j]
                self._stacked = None
            else:
                # a bare tensor, or a Fork's {name: tensor}
                self._host = _to_host(self._raw)
                self._raw = None
        return self._host

    @property
    def materialized(self) -> bool:
        """True once the host copy exists."""
        return self._host is not None

    def __repr__(self):
        state = "host" if self.materialized else "device"
        return f"Result(index={self.index}, final={self.final}, {state})"


class StreamSession:
    """A single stream (or a batch of a fixed lead shape) through a graph.

    ``graph`` is a :class:`~audioflow_torch.graph.Graph` or a
    :class:`~audioflow_torch.graph.Fork`. The session runs on ``device``
    ("cuda" unless given; pass ``device="cpu"`` for the CPU)."""

    def __init__(
        self,
        graph,
        chunk_in: int | None = None,
        lead_shape: tuple = (),
        dtype: torch.dtype = torch.float32,
        sinks: Sequence[Sink] = (),
        events: EventDispatcher | None = None,
        emit_partials: bool = True,
        stats: StatsFile | None = None,
        ring_capacity: int | None = None,
        device=None,
    ):
        self.graph = graph
        gran = graph.chunk_granularity()
        if chunk_in is None:
            chunk_in = gran * max(1, 4096 // gran)
        if chunk_in % gran:
            raise SessionError(
                f"chunk_in {chunk_in} not a multiple of graph granularity {gran}",
                code=ErrorCode.SESSION_STATE_INVALID,
            )
        self.chunk_in = chunk_in
        # staging: room for the residual (< chunk_in) and the largest single
        # push piece (the headroom); larger pushes are split
        self.ring_capacity = ring_capacity or (4 * chunk_in + 1)
        if self.ring_capacity < 2 * chunk_in + 1:
            raise SessionError(
                f"ring_capacity {self.ring_capacity} < 2*chunk_in+1",
                code=ErrorCode.SESSION_STATE_INVALID,
            )
        self.lead_shape = tuple(lead_shape)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.sinks = list(sinks)
        self.events = events or EventDispatcher(enabled=False)
        self.emit_partials = emit_partials
        self.stats = stats

        self.state = SessionState.IDLE
        self._step = None
        self._carry: Any = None
        self._stage: _ring.Staging | None = None
        # a drain of k >= 2 full chunks steps them in blocks of 8, 4 or 2
        # (as large as the staging holds) and shares one host copy per block
        self._drain_buckets = tuple(b for b in (8, 4, 2) if b * self.chunk_in <= self.ring_capacity)
        self._pending = 0  # samples staged and not yet stepped (tracked on the host)
        self._results: queue.Queue[Result] = queue.Queue()
        self._chunk_index = 0
        self._samples_in = 0

    # ------------------------------------------------------------- lifecycle
    def _init_carry(self):
        return self.graph.init_state(self.chunk_in, self.lead_shape, self.dtype, self.device)

    def open(self, precompile: str | bool = True) -> "StreamSession":
        """Open the session. A truthy ``precompile`` (the default) runs one
        step on a fresh init state, and a staging write and take, before the
        first push: kernels build at first use and the allocator warms up off
        the live path. The live state is never touched: every step here
        returns new tensors. ``"all"`` also steps one block of each drain
        bucket."""
        if self.state is SessionState.OPEN:
            return self  # idempotent, like connect-on-connected
        if self.state is SessionState.CLOSED:
            raise SessionError("session closed", code=ErrorCode.SESSION_CLOSED)
        self._step = self.graph.compile_stream(donate=False)
        self._carry = self._init_carry()
        self._stage = _ring.staging_init(self.ring_capacity, self.lead_shape, self.dtype, self.device)
        self._pending = 0
        if precompile:
            z = torch.zeros((*self.lead_shape, self.chunk_in), dtype=self.dtype, device=self.device)
            self._step(self._init_carry(), z)
            stage = _ring.staging_push(self._stage, z)
            _ring.staging_take(stage, self.chunk_in)
            if precompile == "all":
                for b in self._drain_buckets:
                    zb = torch.zeros((*self.lead_shape, b * self.chunk_in), dtype=self.dtype, device=self.device)
                    self._multi_step(self._init_carry(), zb, b)
        self.state = SessionState.OPEN
        from .registry import REGISTRY

        REGISTRY.register(self)
        self.events.emit_session_state("open", chunk_in=self.chunk_in)
        return self

    def __enter__(self):
        return self.open()

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.state = SessionState.FAILED
            self.events.emit_session_state("failed")
        return False

    # ------------------------------------------------------------------ push
    def push(self, samples) -> int:
        """Feed PCM ``[*lead_shape, n]``; steps every complete chunk. Returns
        the chunks stepped.

        The samples go to the card and land in the staging buffer, and full
        chunks are taken from its front and stepped; nothing is read back.
        """
        if self.state is not SessionState.OPEN:
            raise SessionError(
                f"push on {self.state.value} session", code=ErrorCode.SESSION_STATE_INVALID
            )
        arr = np.asarray(samples, np.float32)
        if arr.shape[:-1] != self.lead_shape:
            raise SessionError(
                f"lead shape {arr.shape[:-1]} != session lead {self.lead_shape}",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        n = arr.shape[-1]
        # chunk cadence: with nothing pending, a staging write and a take of
        # the same samples is the identity, so the push is stepped directly;
        # a push of exactly one drain bucket likewise
        if self._pending == 0 and n == self.chunk_in:
            self._samples_in += n
            self._process(self._upload(arr), final=False)
            return 1
        if self._pending == 0 and n % self.chunk_in == 0 and n // self.chunk_in in self._drain_buckets:
            self._samples_in += n
            b = n // self.chunk_in
            self._process_multi(self._upload(arr), b)
            return b
        # staging invariant: the residual is < chunk_in at every drain, so a
        # write may add capacity - chunk_in; larger pushes are split, with
        # drains between the pieces (no sample is ever dropped)
        headroom = self.ring_capacity - self.chunk_in
        done = 0
        for i in range(0, n, headroom):
            piece = arr[..., i : i + headroom]
            m = piece.shape[-1]
            self._stage = _ring.staging_push(self._stage, self._upload(piece))
            self._pending += m
            self._samples_in += m
            while self._pending >= self.chunk_in:
                k = self._pending // self.chunk_in
                b = next((bb for bb in self._drain_buckets if bb <= k), 1)
                self._stage, flat, _ = _ring.staging_take(self._stage, b * self.chunk_in)
                self._pending -= b * self.chunk_in
                if b == 1:
                    self._process(flat, final=False)
                else:
                    self._process_multi(flat, b)
                done += b
        return done

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, self.dtype)

    def _multi_step(self, carry, flat: torch.Tensor, b: int):
        """``b`` chunks of ``flat`` stepped from ``carry``: the body of
        ``Graph.scan_stream``, from the live state."""
        outs = []
        for j in range(b):
            carry, out = self._step(carry, flat[..., j * self.chunk_in : (j + 1) * self.chunk_in])
            outs.append(out)
        return carry, outs

    def _emit_level(self, chunk: torch.Tensor) -> None:
        rms = float(torch.sqrt(torch.mean(chunk**2)))
        peak = float(torch.max(torch.abs(chunk))) if chunk.numel() else 0.0
        self.events.emit_audio_level(rms=rms, peak=peak)

    def _process_multi(self, flat: torch.Tensor, b: int) -> None:
        self._carry, outs = self._multi_step(self._carry, flat, b)
        stacked = _Stacked(outs)
        for j in range(b):
            res = Result(None, False, self._chunk_index, _stacked=stacked, _j=j)
            self._chunk_index += 1
            if self.emit_partials:
                self._results.put(res)
            for sink in self.sinks:
                sink.write(res.data)
            if self.events.enabled:
                self._emit_level(flat[..., j * self.chunk_in : (j + 1) * self.chunk_in])
                self.events.emit_result(res.data, final=False, index=res.index)

    def _process(self, chunk: torch.Tensor, final: bool) -> Result:
        self._carry, out = self._step(self._carry, chunk)
        res = Result(out, final, self._chunk_index)
        self._chunk_index += 1
        if self.emit_partials or final:
            self._results.put(res)
        for sink in self.sinks:
            sink.write(res.data)  # sinks take host data: copied here
        if self.events.enabled:
            self._emit_level(chunk)
            self.events.emit_result(res.data, final=final, index=res.index)
        return res

    # ------------------------------------------------------------------ poll
    def poll(self, timeout: float | None = 0.0) -> Result | None:
        """The next result, or None (non-blocking by default)."""
        try:
            return self._results.get(timeout=timeout) if timeout else self._results.get_nowait()
        except queue.Empty:
            return None

    def poll_all(self) -> list[Result]:
        out = []
        while True:
            r = self.poll()
            if r is None:
                return out
            out.append(r)

    # ----------------------------------------------------------------- flush
    def flush(self) -> Result | None:
        """Zero-pad and step the tail, emitting the final committed result.
        A no-op (None) when nothing is pending and a chunk was stepped."""
        if self.state is not SessionState.OPEN:
            raise SessionError(
                f"flush on {self.state.value} session", code=ErrorCode.SESSION_STATE_INVALID
            )
        if self._pending == 0 and self._chunk_index > 0:
            return None
        self._stage, chunk, _ = _ring.staging_take(self._stage, self.chunk_in)
        self._pending = 0
        return self._process(chunk, final=True)

    def close(self) -> dict:
        """Flush, close the sinks, record stats. Returns a summary dict."""
        if self.state is SessionState.CLOSED:
            return {}
        if self.state is SessionState.OPEN and (self._pending > 0 or self._chunk_index == 0):
            self.flush()
        for sink in self.sinks:
            sink.close()
        rate = self.graph.input_rate or 0
        audio_s = self._samples_in / rate if rate else 0.0
        if self.stats is not None:
            self.stats.record_run(audio_s)
            self.stats.save()
        self.state = SessionState.CLOSED
        from .registry import REGISTRY

        REGISTRY.unregister(self)
        self.events.emit_session_state("closed")
        _log.info("session closed: %d chunks, %.2f audio-s", self._chunk_index, audio_s)
        return {"chunks": self._chunk_index, "audio_seconds": audio_s}

    # ------------------------------------------------------------ checkpoint
    @staticmethod
    def _snapshot_path(path) -> Path:
        # np.savez appends .npz to other suffixes; snapshot and restore agree
        p = Path(path)
        return p if p.suffix == ".npz" else p.with_name(p.name + ".npz")

    def snapshot(self, path: str) -> None:
        """Persist the state, the pending samples and the counters, in the
        JAX package's format: ``__buffer`` (the staged samples not yet
        stepped), ``__chunk_index``, ``__samples_in`` and ``leaf_i``."""
        arrays = {f"leaf_{i}": a for i, a in enumerate(state_leaves(self._carry))}
        if self._pending:
            buffer = self._stage.buf[..., : self._pending].cpu().numpy()
        else:
            buffer = np.zeros((*self.lead_shape, 0), np.float32)
        path = self._snapshot_path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path,
            __buffer=buffer,
            __chunk_index=self._chunk_index,
            __samples_in=self._samples_in,
            **arrays,
        )

    def restore(self, path: str) -> "StreamSession":
        """Restore a snapshot (of either package) into an open session with
        the same graph and chunk."""
        self.open()
        data = np.load(self._snapshot_path(path), allow_pickle=False)
        n_leaves = len(state_leaves(self._carry))
        self._carry = state_from_leaves(
            self._carry, [data[f"leaf_{i}"] for i in range(n_leaves)], self.device
        )
        self._stage = _ring.staging_init(self.ring_capacity, self.lead_shape, self.dtype, self.device)
        self._pending = 0
        buffer = data["__buffer"]
        if buffer.shape[-1]:
            self._stage = _ring.staging_push(self._stage, self._upload(buffer))
            self._pending = int(buffer.shape[-1])
        self._chunk_index = int(data["__chunk_index"])
        self._samples_in = int(data["__samples_in"])
        return self


from .scribe import ScribeConfig, ScribeSession  # noqa: E402  (the duplex ASR session)
from .transcript import (  # noqa: E402
    ScribeEvent,
    ScribeEventKind,
    TranscriptAccumulator,
    parse_scribe_message,
)
