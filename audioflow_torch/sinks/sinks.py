"""Output sinks: where graph results leave the device.

Mirrors ``audioflow_tpu/sinks/sinks.py``, file for file byte-equal. A chunk
may be a numpy array or a tensor on any device: it is brought to the host
(:func:`to_host`) before it is kept or written. :func:`auto_sink` picks a
sink from the output path's extension.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..errors import ErrorCode, SinkError
from . import wire


def to_host(chunk) -> np.ndarray:
    """``chunk`` as a numpy array; a tensor is copied off its device."""
    if hasattr(chunk, "detach"):  # a torch tensor, on the card or the CPU
        return chunk.detach().cpu().numpy()
    return np.asarray(chunk)


class Sink:
    """write(chunk) any number of times, then close() -> result/path."""

    def write(self, chunk) -> None:
        raise NotImplementedError

    def close(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ArraySink(Sink):
    """Accumulate chunks host-side; ``result()`` concatenates (axis 0)."""

    def __init__(self):
        self.chunks: list[np.ndarray] = []

    def write(self, chunk) -> None:
        self.chunks.append(to_host(chunk))

    def result(self) -> np.ndarray:
        if not self.chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(self.chunks, axis=0)

    def close(self):
        return self.result()


class NpySink(Sink):
    """Write the concatenated result to a .npy file on close."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self._acc = ArraySink()

    def write(self, chunk) -> None:
        self._acc.write(chunk)

    def close(self):
        out = self._acc.result()
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            np.save(self.path, out)
        except OSError as e:
            raise SinkError(f"npy write failed: {e}", code=ErrorCode.SINK_WRITE_FAILED)
        return self.path


class WavSink(Sink):
    """Stream PCM chunks to a WAV file (closes with a fixed header)."""

    def __init__(self, path: str | os.PathLike, sample_rate: int, bits: int = 16):
        self.path = Path(path)
        self.sample_rate = sample_rate
        self.bits = bits
        self._acc = ArraySink()

    def write(self, chunk) -> None:
        self._acc.write(chunk)

    def close(self):
        from ..io.wav import write_wav

        out = self._acc.result()
        if getattr(out, "ndim", 1) == 2 and out.shape[0] == 1:
            out = out[0]  # single-item batch -> mono wav, not 1-sample frames
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            write_wav(self.path, out, self.sample_rate, self.bits)
        except OSError as e:
            raise SinkError(f"wav write failed: {e}", code=ErrorCode.SINK_WRITE_FAILED)
        return self.path


class WireJsonlSink(Sink):
    """One wire message per chunk (:func:`wire.encode_audio_chunk`), JSONL
    to a file: the egress codec of the websocket sink, as a file."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        try:
            self._f = open(self.path, "w")
        except OSError as e:
            raise SinkError(f"cannot open {path}: {e}", code=ErrorCode.SINK_WRITE_FAILED)

    def write(self, chunk) -> None:
        self._f.write(wire.encode_audio_chunk(to_host(chunk)) + "\n")

    def close(self):
        self._f.close()
        return self.path


class CallbackSink(Sink):
    def __init__(self, fn):
        self.fn = fn

    def write(self, chunk) -> None:
        self.fn(to_host(chunk))


class JsonlSink(Sink):
    """Generic JSONL of chunk summaries (for VAD states, metrics, ...)."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "w")

    def write(self, chunk) -> None:
        arr = to_host(chunk)
        self._f.write(json.dumps(arr.tolist()) + "\n")

    def close(self):
        self._f.close()
        return self.path


def auto_sink(path: str | os.PathLike | None, sample_rate: int | None = None) -> Sink:
    """Pick a sink by destination (the Auto injection-method analog)."""
    if path is None:
        return ArraySink()
    suffix = Path(path).suffix.lower()
    if suffix == ".npy":
        return NpySink(path)
    if suffix == ".wav":
        if sample_rate is None:
            raise SinkError("wav sink needs sample_rate", code=ErrorCode.CONFIG_VALIDATION_ERROR)
        return WavSink(path, sample_rate)
    if suffix == ".jsonl":
        return WireJsonlSink(path)
    raise SinkError(f"no sink for extension {suffix!r}", code=ErrorCode.UNSUPPORTED_FORMAT)
