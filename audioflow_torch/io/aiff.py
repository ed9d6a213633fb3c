"""AIFF / AIFF-C codec in pure NumPy (the third container, after WAV+FLAC).

Apple's IFF-based audio container: big-endian chunks, COMM holds the format
(channels, frames, bits, an 80-bit extended-float sample rate — the format's
one exotic feature), SSND holds the payload. AIFF-C adds a compression type:
supported here are 'NONE' (big-endian PCM), 'sowt' (byte-swapped = little-
endian PCM 16, the common Mac variant), 'fl32'/'FL32' (big-endian float32),
and 'fl64'/'FL64'. AIFF 8-bit PCM is SIGNED (unlike WAV's unsigned 8-bit).

A copy of ``audioflow_tpu/io/aiff.py``. Same contract as io/wav.py: float32 in [-1, 1], per-lane typed errors so
batch loaders keep fault isolation (SURVEY §5.3).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..errors import ErrorCode, IOError_

MAGIC = b"FORM"


class AiffInfo:
    __slots__ = ("sample_rate", "channels", "bits", "comp", "n_frames", "data_offset", "data_size")

    def __init__(self, sample_rate, channels, bits, comp, n_frames, data_offset, data_size):
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits = bits
        self.comp = comp
        self.n_frames = n_frames
        self.data_offset = data_offset
        self.data_size = data_size


def _read_extended(b: bytes) -> float:
    """80-bit IEEE 754 extended float (big-endian), AIFF's sample-rate type."""
    if len(b) != 10:
        raise IOError_("bad extended float", code=ErrorCode.DECODE_FAILED)
    (se,) = struct.unpack(">H", b[:2])
    (mant,) = struct.unpack(">Q", b[2:])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    if exp == 0x7FFF:
        raise IOError_("inf/nan sample rate", code=ErrorCode.DECODE_FAILED)
    # explicit integer bit: value = mant * 2^(exp - 16383 - 63)
    return sign * float(mant) * 2.0 ** (exp - 16383 - 63)


def probe(buf: bytes) -> AiffInfo:
    """Parse the FORM/AIFF(-C) header; raises IOError_ on malformed input."""
    if len(buf) < 12 or buf[:4] != MAGIC or buf[8:12] not in (b"AIFF", b"AIFC"):
        raise IOError_("not an AIFF/AIFF-C file", code=ErrorCode.DECODE_FAILED)
    is_aifc = buf[8:12] == b"AIFC"
    pos = 12
    comm = None
    comp = b"NONE"
    data_off = data_size = None
    n_frames = 0
    try:
        while pos + 8 <= len(buf):
            cid = buf[pos : pos + 4]
            (size,) = struct.unpack_from(">I", buf, pos + 4)
            body = pos + 8
            if cid == b"COMM":
                if size < 18:
                    raise IOError_("COMM chunk too small", code=ErrorCode.DECODE_FAILED)
                ch, n_frames, bits = struct.unpack_from(">hIh", buf, body)
                rate = _read_extended(buf[body + 8 : body + 18])
                if is_aifc and size >= 22:
                    comp = buf[body + 18 : body + 22]
                comm = (ch, bits, rate)
            elif cid == b"SSND":
                if size < 8:
                    raise IOError_("SSND chunk too small", code=ErrorCode.DECODE_FAILED)
                offset, _block = struct.unpack_from(">II", buf, body)
                data_off = body + 8 + offset
                data_size = min(size - 8 - offset, len(buf) - data_off)
            pos = body + size + (size & 1)  # chunks are word-aligned
    except struct.error:
        raise IOError_("truncated AIFF header", code=ErrorCode.DECODE_FAILED) from None
    if comm is None or data_off is None:
        raise IOError_("missing COMM/SSND chunk", code=ErrorCode.DECODE_FAILED)
    ch, bits, rate = comm
    comp_u = comp.upper()
    if comp_u not in (b"NONE", b"SOWT", b"FL32", b"FL64"):
        raise IOError_(
            f"unsupported AIFF-C compression {comp!r}", code=ErrorCode.UNSUPPORTED_FORMAT
        )
    if comp_u == b"FL32":
        bits = 32
    if comp_u == b"FL64":
        bits = 64
    if comp_u == b"SOWT" and bits != 16:
        raise IOError_("'sowt' is 16-bit only", code=ErrorCode.UNSUPPORTED_FORMAT)
    if bits not in (8, 16, 24, 32, 64):
        raise IOError_(f"unsupported bit depth {bits}", code=ErrorCode.UNSUPPORTED_FORMAT)
    if ch < 1 or rate <= 0:
        raise IOError_("bad channel count / sample rate", code=ErrorCode.DECODE_FAILED)
    frame_bytes = ch * (bits // 8)
    n = min(n_frames, data_size // frame_bytes if frame_bytes else 0)
    return AiffInfo(int(round(rate)), ch, bits, comp_u.decode(), n, data_off, data_size)


def read_aiff(src: str | os.PathLike | bytes) -> tuple[np.ndarray, int]:
    """Decode an AIFF/AIFF-C file (path or bytes) to float32 in [-1, 1].

    Returns (samples ``[n]`` mono or ``[n, ch]``, sample_rate).
    """
    if isinstance(src, (bytes, bytearray, memoryview)):
        buf = bytes(src)
    else:
        try:
            with open(src, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            raise IOError_(f"file not found: {src}", code=ErrorCode.FILE_NOT_FOUND) from None
    info = probe(buf)
    n = info.n_frames * info.channels
    payload = buf[info.data_offset :]
    try:
        if info.comp == "FL32":
            x = np.frombuffer(payload, ">f4", count=n).astype(np.float32)
        elif info.comp == "FL64":
            x = np.frombuffer(payload, ">f8", count=n).astype(np.float32)
        elif info.comp == "SOWT":
            x = np.frombuffer(payload, "<i2", count=n).astype(np.float32) / 32768.0
        elif info.bits == 16:
            x = np.frombuffer(payload, ">i2", count=n).astype(np.float32) / 32768.0
        elif info.bits == 32:
            x = np.frombuffer(payload, ">i4", count=n).astype(np.float32) / 2147483648.0
        elif info.bits == 8:  # AIFF 8-bit is signed
            x = np.frombuffer(payload, np.int8, count=n).astype(np.float32) / 128.0
        elif info.bits == 24:
            raw = np.frombuffer(payload, np.uint8, count=n * 3).reshape(-1, 3)
            as_i32 = (
                (raw[:, 0].astype(np.int32) << 16)
                | (raw[:, 1].astype(np.int32) << 8)
                | raw[:, 2].astype(np.int32)
            )
            as_i32 = (as_i32 << 8) >> 8
            x = as_i32.astype(np.float32) / 8388608.0
        else:  # pragma: no cover - guarded by probe
            raise IOError_(f"unsupported bits {info.bits}", code=ErrorCode.UNSUPPORTED_FORMAT)
    except ValueError as err:
        raise IOError_(f"decode failed: {err}", code=ErrorCode.DECODE_FAILED) from None
    if info.channels > 1:
        return x.reshape(info.n_frames, info.channels), info.sample_rate
    return x, info.sample_rate


def _write_extended(value: float) -> bytes:
    """Encode a positive sample rate as an 80-bit extended float."""
    if value <= 0:
        raise IOError_("sample rate must be positive", code=ErrorCode.CONFIG_VALIDATION_ERROR)
    import math

    m, e = math.frexp(value)  # value = m * 2^e, m in [0.5, 1)
    exp = e - 1 + 16383
    mant = int(m * (1 << 64))
    return struct.pack(">H", exp) + struct.pack(">Q", mant)


def write_aiff(path: str | os.PathLike, data: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Encode float32 [-1, 1] to big-endian PCM16 AIFF (fixture/export use)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n_frames, channels = data.shape
    if bits != 16:
        raise IOError_(f"write supports 16 bits, got {bits}", code=ErrorCode.UNSUPPORTED_FORMAT)
    payload = (np.clip(data, -1, 1) * 32767.0).astype(">i2").tobytes()
    comm = struct.pack(">hIh", channels, n_frames, bits) + _write_extended(float(sample_rate))
    ssnd = struct.pack(">II", 0, 0) + payload
    body = b"AIFF"
    body += b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)
