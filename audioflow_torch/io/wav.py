"""WAV (RIFF) codec in pure NumPy — the portable decode path.

A copy of ``audioflow_tpu/io/wav.py``, bit for bit in behaviour (the port
may not import the JAX package). A faster multithreaded C++ decoder with the
same contract lives in :mod:`audioflow_torch.io.native`; this module is the
fallback and the oracle the native path is tested against.

Supports PCM 8/16/24/32-bit and IEEE float32/64, mono or interleaved
multi-channel, plus WAVE_FORMAT_EXTENSIBLE headers.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

from ..errors import ErrorCode, IOError_

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_ALAW = 6
_FMT_MULAW = 7
_FMT_EXTENSIBLE = 0xFFFE


def _g711_tables():
    """256-entry G.711 decode tables (int16 scale), computed from the spec.

    mu-law: s = sign * (((mant << 3) + 0x84) << exp) - 0x84), code bits
    inverted on the wire; max magnitude 32124. A-law: even bits inverted
    (XOR 0x55); segment 0 is linear; max magnitude 32256. These reproduce
    the published ITU tables exactly (asserted in tests).
    """
    codes = np.arange(256, dtype=np.int32)
    # mu-law
    u = ~codes & 0xFF
    exp = (u >> 4) & 7
    mant = u & 0x0F
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    mu = np.where(u & 0x80, -mag, mag).astype(np.int16)
    # A-law
    a = codes ^ 0x55
    exp = (a >> 4) & 7
    mant = a & 0x0F
    mag = np.where(exp == 0, (mant << 4) + 8, ((mant << 4) + 0x108) << np.maximum(exp - 1, 0))
    al = np.where(a & 0x80, mag, -mag).astype(np.int16)
    return mu.astype(np.float32) / 32768.0, al.astype(np.float32) / 32768.0


_MULAW_TABLE, _ALAW_TABLE = _g711_tables()


class WavInfo:
    __slots__ = ("sample_rate", "channels", "bits", "fmt", "n_frames", "data_offset", "data_size")

    def __init__(self, sample_rate, channels, bits, fmt, n_frames, data_offset, data_size):
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits = bits
        self.fmt = fmt
        self.n_frames = n_frames
        self.data_offset = data_offset
        self.data_size = data_size

    def __repr__(self):  # pragma: no cover
        return (
            f"WavInfo(rate={self.sample_rate}, ch={self.channels}, bits={self.bits}, "
            f"frames={self.n_frames})"
        )


def probe(buf: bytes, truncated: bool = False) -> WavInfo:
    """Parse the RIFF header; raises IOError_ on malformed input.

    With ``truncated=True`` the buffer may hold only the file head (e.g. the
    first 4 KB); the declared data-chunk size is trusted instead of being
    clamped to the buffer, so ``n_frames`` reflects the whole file.
    """
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise IOError_("not a RIFF/WAVE file", code=ErrorCode.DECODE_FAILED)
    pos = 12
    fmt = None
    data_off = data_size = None
    rate = channels = bits = None
    try:
        while pos + 8 <= len(buf):
            cid = buf[pos : pos + 4]
            (size,) = struct.unpack_from("<I", buf, pos + 4)
            body = pos + 8
            if cid == b"fmt ":
                if size < 16:
                    raise IOError_("fmt chunk too small", code=ErrorCode.DECODE_FAILED)
                fmt, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", buf, body)
                if fmt == _FMT_EXTENSIBLE and size >= 40:
                    # first two bytes of the SubFormat GUID hold the real format
                    (fmt,) = struct.unpack_from("<H", buf, body + 24)
            elif cid == b"data":
                data_off = body
                data_size = size if truncated else min(size, len(buf) - body)
            pos = body + size + (size & 1)  # chunks are word-aligned
    except struct.error:
        # file cut inside a chunk header: typed error, never struct.error,
        # so per-lane fault isolation keeps working (SURVEY §5.3)
        raise IOError_("truncated WAV header", code=ErrorCode.DECODE_FAILED) from None
    if fmt is None or data_off is None:
        raise IOError_("missing fmt/data chunk", code=ErrorCode.DECODE_FAILED)
    if fmt not in (_FMT_PCM, _FMT_FLOAT, _FMT_ALAW, _FMT_MULAW):
        raise IOError_(f"unsupported WAV format tag {fmt}", code=ErrorCode.UNSUPPORTED_FORMAT)
    if bits not in (8, 16, 24, 32, 64):
        raise IOError_(f"unsupported bit depth {bits}", code=ErrorCode.UNSUPPORTED_FORMAT)
    if fmt == _FMT_FLOAT and bits not in (32, 64):
        # IEEE-float WAV only exists at 32/64 bits; accepting e.g. FLOAT/16
        # here would make _decode_payload misread the payload later (and the
        # native decoder must reject the same bytes — contract parity).
        raise IOError_(
            f"float WAV requires 32/64 bits, got {bits}", code=ErrorCode.UNSUPPORTED_FORMAT
        )
    if fmt in (_FMT_ALAW, _FMT_MULAW) and bits != 8:
        raise IOError_(
            f"G.711 WAV requires 8 bits, got {bits}", code=ErrorCode.UNSUPPORTED_FORMAT
        )
    frame_bytes = channels * (bits // 8)
    n_frames = data_size // frame_bytes if frame_bytes else 0
    return WavInfo(rate, channels, bits, fmt, n_frames, data_off, data_size)


def _decode_payload(payload: bytes, info: WavInfo) -> np.ndarray:
    n = info.n_frames * info.channels
    if info.fmt == _FMT_MULAW:
        x = _MULAW_TABLE[np.frombuffer(payload, np.uint8, count=n)]
    elif info.fmt == _FMT_ALAW:
        x = _ALAW_TABLE[np.frombuffer(payload, np.uint8, count=n)]
    elif info.fmt == _FMT_FLOAT:
        dt = np.float32 if info.bits == 32 else np.float64
        x = np.frombuffer(payload, dt, count=n).astype(np.float32)
    elif info.bits == 16:
        x = np.frombuffer(payload, "<i2", count=n).astype(np.float32) / 32768.0
    elif info.bits == 32:
        x = np.frombuffer(payload, "<i4", count=n).astype(np.float32) / 2147483648.0
    elif info.bits == 8:
        x = (np.frombuffer(payload, np.uint8, count=n).astype(np.float32) - 128.0) / 128.0
    elif info.bits == 24:
        raw = np.frombuffer(payload, np.uint8, count=n * 3).reshape(-1, 3)
        as_i32 = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        as_i32 = (as_i32 << 8) >> 8  # sign-extend 24 -> 32
        x = as_i32.astype(np.float32) / 8388608.0
    else:  # pragma: no cover - guarded by probe
        raise IOError_(f"unsupported bits {info.bits}", code=ErrorCode.UNSUPPORTED_FORMAT)
    if info.channels > 1:
        return x.reshape(info.n_frames, info.channels)
    return x


def read_wav(src: str | os.PathLike | bytes) -> tuple[np.ndarray, int]:
    """Decode a WAV file (path or raw bytes) to float32 in [-1, 1].

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
    payload = buf[info.data_offset : info.data_offset + info.data_size]
    try:
        return _decode_payload(payload, info), info.sample_rate
    except IOError_:
        raise
    except (ValueError, struct.error) as err:
        # any residual decode error stays typed so batch loaders keep
        # per-lane fault isolation (SURVEY §5.3)
        raise IOError_(f"decode failed: {err}", code=ErrorCode.DECODE_FAILED) from None


def write_wav(path: str | os.PathLike, data: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Encode float32 [-1, 1] to PCM16/PCM32/float32 WAV."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n_frames, channels = data.shape
    if bits == 16:
        fmt, payload = _FMT_PCM, (np.clip(data, -1, 1) * 32767.0).astype("<i2").tobytes()
    elif bits == 32:
        fmt, payload = _FMT_FLOAT, data.astype("<f4").tobytes()
    else:
        raise IOError_(f"write supports 16/32 bits, got {bits}", code=ErrorCode.UNSUPPORTED_FORMAT)
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        out = io.BytesIO()
        out.write(b"RIFF")
        out.write(struct.pack("<I", 36 + len(payload)))
        out.write(b"WAVE")
        out.write(b"fmt ")
        out.write(struct.pack("<IHHIIHH", 16, fmt, channels, sample_rate, byte_rate, block_align, bits))
        out.write(b"data")
        out.write(struct.pack("<I", len(payload)))
        out.write(payload)
        f.write(out.getvalue())
