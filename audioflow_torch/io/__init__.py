"""Host I/O of the port: WAV, FLAC and AIFF codecs (numpy + native C++),
batch loading into a staging ring, prefetch.

Mirrors ``audioflow_tpu/io``; the codecs are copies, bit for bit in
behaviour, since the port may not import the JAX package.
"""

from __future__ import annotations

import os

from . import aiff, flac, native, wav
from .aiff import read_aiff, write_aiff
from .flac import read_flac, write_flac
from .loader import BatchLoader, DecodedBatch, decode_batch
from .wav import probe, read_wav, write_wav


def probe_audio(buf: bytes):
    """Container-dispatched probe: Wav/Flac/AiffInfo by magic bytes."""
    if buf[:4] == flac.MAGIC:
        return flac.probe(buf)
    if buf[:4] == aiff.MAGIC:
        return aiff.probe(buf)
    return wav.probe(buf)


def read_audio(src: "str | os.PathLike | bytes"):
    """Decode WAV, FLAC, or AIFF (path or raw bytes) to float32 in [-1, 1].

    Returns (samples ``[n]`` mono or ``[n, ch]``, sample_rate). Dispatches
    on the container magic, so callers never care which codec a file uses.
    """
    if isinstance(src, (bytes, bytearray, memoryview)):
        buf = bytes(src)
    else:
        from ..errors import ErrorCode, IOError_

        try:
            with open(src, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            raise IOError_(f"file not found: {src}", code=ErrorCode.FILE_NOT_FOUND) from None
    if buf[:4] == flac.MAGIC:
        return read_flac(buf)
    if buf[:4] == aiff.MAGIC:
        return read_aiff(buf)
    return read_wav(buf)


__all__ = [
    "aiff",
    "BatchLoader",
    "DecodedBatch",
    "decode_batch",
    "flac",
    "native",
    "probe",
    "probe_audio",
    "read_aiff",
    "read_audio",
    "read_flac",
    "read_wav",
    "wav",
    "write_aiff",
    "write_flac",
    "write_wav",
]
