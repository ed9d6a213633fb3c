"""FLAC codec in pure Python — lossless decode oracle + encoder.

A copy of ``audioflow_tpu/io/flac.py``, bit for bit in behaviour: the
framework's second container format. Mirrors the WAV design exactly:
this module is the portable path AND the behavioral oracle; the
multithreaded C++ fast path in native/wavcodec.cpp decodes the same bytes
bit-identically (FLAC is lossless, so "bit-identical" is meaningful all the
way to the integer samples).

Decoder coverage (FLAC format spec): STREAMINFO + metadata skip, fixed and
variable blocking, all blocksize/rate/bps header codes, subframe types
CONSTANT / VERBATIM / FIXED (orders 0-4) / LPC (any order), wasted bits,
partitioned Rice residuals (RICE and RICE2, escape partitions), and stereo
decorrelation (left-side / right-side / mid-side).

Encoder: STREAMINFO (+ correct MD5), fixed-blocksize frames, per-block
choice of CONSTANT / FIXED order 0-4 by minimum residual magnitude, Rice
parameter per partition, correct CRC-8 / CRC-16 — output is accepted by any
conforming player and round-trips bit-exactly through both decoders.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np

from ..errors import ErrorCode, IOError_

MAGIC = b"fLaC"

_BLOCKSIZE_CODE = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
                   256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
                   8192: 13, 16384: 14, 32768: 15}
_RATE_CODE = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
              24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
_RATE_FROM_CODE = {v: k for k, v in _RATE_CODE.items()}
_BPS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_BPS_FROM_CODE = {v: k for k, v in _BPS_CODE.items()}
_FIXED_COEF = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


# --------------------------------------------------------------------------
# bit I/O
# --------------------------------------------------------------------------

class _BitReader:
    __slots__ = ("buf", "pos")  # pos in bits

    def __init__(self, buf: bytes, byte_offset: int = 0):
        self.buf = buf
        self.pos = byte_offset * 8

    def read(self, n: int) -> int:
        v = 0
        pos, buf = self.pos, self.buf
        end = pos + n
        if end > len(buf) * 8:
            raise IOError_("truncated FLAC stream", code=ErrorCode.DECODE_FAILED)
        while n:
            byte = buf[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, n)
            v = (v << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            pos += take
            n -= take
        self.pos = pos
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


class _BitWriter:
    __slots__ = ("bytes_", "acc", "nbits")

    def __init__(self):
        self.bytes_ = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, v: int, n: int) -> None:
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes_.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a one

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.bytes_)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

class FlacInfo:
    __slots__ = ("sample_rate", "channels", "bits", "n_frames", "frames_offset")

    def __init__(self, sample_rate, channels, bits, n_frames, frames_offset):
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits = bits
        self.n_frames = n_frames  # total samples per channel (0 = unknown)
        self.frames_offset = frames_offset

    def __repr__(self):  # pragma: no cover
        return (
            f"FlacInfo(rate={self.sample_rate}, ch={self.channels}, "
            f"bits={self.bits}, frames={self.n_frames})"
        )


def probe(buf: bytes) -> FlacInfo:
    """Parse STREAMINFO + skip metadata; raises IOError_ on malformed input."""
    if len(buf) < 4 or buf[:4] != MAGIC:
        raise IOError_("not a FLAC file", code=ErrorCode.DECODE_FAILED)
    pos = 4
    info = None
    while True:
        if pos + 4 > len(buf):
            raise IOError_("truncated FLAC metadata", code=ErrorCode.DECODE_FAILED)
        last = buf[pos] >> 7
        btype = buf[pos] & 0x7F
        (blen,) = struct.unpack(">I", b"\0" + buf[pos + 1 : pos + 4])
        body = pos + 4
        if btype == 0:  # STREAMINFO
            if blen < 34 or body + 34 > len(buf):
                raise IOError_("bad STREAMINFO", code=ErrorCode.DECODE_FAILED)
            br = _BitReader(buf, body)
            br.read(16)  # min blocksize
            br.read(16)  # max blocksize
            br.read(24)  # min framesize
            br.read(24)  # max framesize
            rate = br.read(20)
            channels = br.read(3) + 1
            bits = br.read(5) + 1
            total = br.read(36)
            if rate == 0:
                raise IOError_("invalid sample rate 0", code=ErrorCode.DECODE_FAILED)
            info = FlacInfo(rate, channels, bits, total, 0)
        pos = body + blen
        if last:
            break
    if info is None:
        raise IOError_("missing STREAMINFO", code=ErrorCode.DECODE_FAILED)
    info.frames_offset = pos
    return info


def _read_utf8_number(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_extra = 0
    mask = 0x40
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0 or n_extra > 6:
        raise IOError_("bad UTF-8 coded number", code=ErrorCode.DECODE_FAILED)
    v = b0 & (mask - 1)
    for _ in range(n_extra):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise IOError_("bad UTF-8 continuation", code=ErrorCode.DECODE_FAILED)
        v = (v << 6) | (b & 0x3F)
    return v


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> list[int]:
    method = br.read(2)
    if method > 1:
        raise IOError_(f"reserved residual method {method}", code=ErrorCode.DECODE_FAILED)
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    po = br.read(4)
    nparts = 1 << po
    if blocksize % nparts or (nparts > 1 and (blocksize >> po) <= order):
        raise IOError_("bad rice partition order", code=ErrorCode.DECODE_FAILED)
    out = []
    for p in range(nparts):
        n = (blocksize >> po) - (order if p == 0 else 0)
        k = br.read(pbits)
        if k == escape:
            raw_bits = br.read(5)
            if raw_bits:
                out.extend(br.read_signed(raw_bits) for _ in range(n))
            else:
                out.extend([0] * n)
        else:
            for _ in range(n):
                q = br.read_unary()
                v = (q << k) | br.read(k)
                out.append((v >> 1) ^ -(v & 1))  # zigzag
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> list[int]:
    if br.read(1):
        raise IOError_("bad subframe padding bit", code=ErrorCode.DECODE_FAILED)
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    bps -= wasted
    if stype == 0:  # CONSTANT
        v = br.read_signed(bps)
        out = [v] * blocksize
    elif stype == 1:  # VERBATIM
        out = [br.read_signed(bps) for _ in range(blocksize)]
    elif 8 <= stype <= 12:  # FIXED order 0-4
        order = stype - 8
        out = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        coef = _FIXED_COEF[order]
        for r in res:
            pred = sum(c * out[-1 - j] for j, c in enumerate(coef))
            out.append(r + pred)
    elif stype >= 32:  # LPC
        order = stype - 31
        out = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        if prec == 16:
            raise IOError_("invalid LPC precision", code=ErrorCode.DECODE_FAILED)
        shift = br.read_signed(5)
        if shift < 0:
            raise IOError_("negative LPC shift", code=ErrorCode.DECODE_FAILED)
        coef = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        for r in res:
            acc = sum(c * out[-1 - j] for j, c in enumerate(coef))
            out.append(r + (acc >> shift))
    else:
        raise IOError_(f"reserved subframe type {stype}", code=ErrorCode.DECODE_FAILED)
    if wasted:
        out = [v << wasted for v in out]
    return out


def _decode_frame(br: _BitReader, info: FlacInfo):
    """Decode one frame; returns per-channel int lists [channels][blocksize]."""
    sync = br.read(14)
    if sync != 0x3FFE:
        raise IOError_("lost FLAC frame sync", code=ErrorCode.DECODE_FAILED)
    if br.read(1):
        raise IOError_("reserved frame bit set", code=ErrorCode.DECODE_FAILED)
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    rate_code = br.read(4)
    ch_code = br.read(4)
    bps_code = br.read(3)
    if br.read(1):
        raise IOError_("reserved frame bit set", code=ErrorCode.DECODE_FAILED)
    _read_utf8_number(br)
    if bs_code == 0:
        raise IOError_("reserved blocksize code", code=ErrorCode.DECODE_FAILED)
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    elif bs_code == 1:
        blocksize = 192
    elif bs_code <= 5:
        blocksize = 576 << (bs_code - 2)
    else:
        blocksize = 256 << (bs_code - 8)
    if rate_code == 12:
        br.read(8)
    elif rate_code in (13, 14):
        br.read(16)
    elif rate_code == 15:
        raise IOError_("invalid sample-rate code", code=ErrorCode.DECODE_FAILED)
    br.read(8)  # header CRC-8 (validated by construction in the encoder)
    bps = info.bits if bps_code == 0 else _BPS_FROM_CODE.get(bps_code)
    if bps is None:
        raise IOError_("reserved bps code", code=ErrorCode.DECODE_FAILED)

    if ch_code <= 7:
        channels = ch_code + 1
        chans = [_decode_subframe(br, blocksize, bps) for _ in range(channels)]
    elif ch_code in (8, 9, 10):  # left-side / right-side / mid-side
        a = _decode_subframe(br, blocksize, bps + (1 if ch_code == 9 else 0))
        b = _decode_subframe(br, blocksize, bps + (1 if ch_code != 9 else 0))
        if ch_code == 8:  # left, side -> right = left - side
            chans = [a, [x - s for x, s in zip(a, b)]]
        elif ch_code == 9:  # side, right -> left = right + side
            chans = [[x + s for x, s in zip(b, a)], b]
        else:  # mid, side
            left, right = [], []
            for m, s in zip(a, b):
                m = (m << 1) | (s & 1)
                left.append((m + s) >> 1)
                right.append((m - s) >> 1)
            chans = [left, right]
    else:
        raise IOError_(f"reserved channel assignment {ch_code}", code=ErrorCode.DECODE_FAILED)
    br.align()
    br.read(16)  # frame CRC-16
    return chans


def decode_int(buf: bytes) -> tuple[np.ndarray, FlacInfo]:
    """Decode the whole stream to int32 samples ``[n_frames, channels]``."""
    info = probe(buf)
    br = _BitReader(buf, info.frames_offset)
    chans_all: list[list[int]] = [[] for _ in range(info.channels)]
    total = info.n_frames
    while (total == 0 or len(chans_all[0]) < total) and br.byte_pos() < len(buf):
        chans = _decode_frame(br, info)
        if len(chans) != info.channels:
            raise IOError_("frame channel count mismatch", code=ErrorCode.DECODE_FAILED)
        for c, vals in zip(chans_all, chans):
            c.extend(vals)
    out = np.stack([np.asarray(c, np.int64) for c in chans_all], axis=1)
    if total and out.shape[0] > total:
        out = out[:total]
    lim = np.int64(1) << (info.bits + 1)
    if out.size and (out.max() >= lim or out.min() < -lim):  # corrupt stream guard
        raise IOError_("decoded samples out of range", code=ErrorCode.DECODE_FAILED)
    return out.astype(np.int32), info


def read_flac(src: str | os.PathLike | bytes) -> tuple[np.ndarray, int]:
    """Decode a FLAC file (path or raw bytes) to float32 in [-1, 1].

    Returns (samples ``[n]`` mono or ``[n, ch]``, sample_rate) — the same
    contract as :func:`audioflow_torch.io.wav.read_wav`.
    """
    if isinstance(src, (bytes, bytearray, memoryview)):
        buf = bytes(src)
    else:
        try:
            with open(src, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            raise IOError_(f"file not found: {src}", code=ErrorCode.FILE_NOT_FOUND) from None
    ints, info = decode_int(buf)
    x = ints.astype(np.float32) / float(1 << (info.bits - 1))
    if info.channels == 1:
        x = x[:, 0]
    return x, info.sample_rate


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def _best_rice_param(res: list[int], pbits: int) -> int:
    tot = sum((v << 1) ^ (v >> 63) if v < 0 else v << 1 for v in res)  # zigzag sum
    mean = tot / max(1, len(res))
    k = 0
    while (1 << (k + 1)) < mean + 1 and k < (1 << pbits) - 2:
        k += 1
    return k


def _write_residual(bw: _BitWriter, res: list[int], bps: int) -> None:
    bw.write(0, 2)  # RICE (4-bit params)
    bw.write(0, 4)  # partition order 0
    k = _best_rice_param(res, 4)
    worst = max((abs(v) for v in res), default=0)
    # escape to raw if rice would blow up (pathological residuals)
    if worst and (worst.bit_length() + 2 - k) > 30:
        bw.write(15, 4)
        raw = min(32, worst.bit_length() + 1)
        bw.write(raw, 5)
        for v in res:
            bw.write(v, raw)
        return
    bw.write(k, 4)
    for v in res:
        z = ((v << 1) ^ (v >> 63)) if v < 0 else (v << 1)
        bw.write_unary(z >> k)
        bw.write(z, k)


def _encode_subframe(bw: _BitWriter, samples: list[int], bps: int) -> None:
    if all(s == samples[0] for s in samples):
        bw.write(0, 1)
        bw.write(0, 6)  # CONSTANT
        bw.write(0, 1)
        bw.write(samples[0], bps)
        return
    # pick the fixed order with minimum total residual magnitude
    best_order, best_res, best_cost = 0, samples, sum(abs(s) for s in samples)
    res = list(samples)
    for order in range(1, 5):
        if len(samples) <= order:
            break
        res = [res[i] - res[i - 1] for i in range(1, len(res))]  # successive diff
        cost = sum(abs(r) for r in res)
        if cost < best_cost:
            best_order, best_cost = order, cost
            best_res = res
    order = best_order
    bw.write(0, 1)
    bw.write(8 + order, 6)  # FIXED
    bw.write(0, 1)  # no wasted bits
    for s in samples[:order]:
        bw.write(s, bps)
    _write_residual(bw, best_res if order else list(samples), bps)


def write_flac(
    path: str | os.PathLike | None,
    data: np.ndarray,
    sample_rate: int,
    bits: int = 16,
    blocksize: int = 4096,
) -> bytes:
    """Encode float32 [-1, 1] (or int samples when an int dtype) to FLAC.

    Returns the encoded bytes; writes them to ``path`` unless it is None.
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    if bits not in (8, 16, 24, 32):
        raise IOError_(f"unsupported FLAC bits {bits}", code=ErrorCode.UNSUPPORTED_FORMAT)
    if np.issubdtype(data.dtype, np.floating):
        scale = float(1 << (bits - 1))
        ints = np.clip(np.round(data * scale), -scale, scale - 1).astype(np.int64)
    else:
        ints = data.astype(np.int64)
    n, channels = ints.shape
    if not 1 <= channels <= 8:
        raise IOError_(f"unsupported channel count {channels}", code=ErrorCode.UNSUPPORTED_FORMAT)

    frames = bytearray()
    for fi, start in enumerate(range(0, n, blocksize)):
        block = ints[start : start + blocksize]
        bs = block.shape[0]
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)  # fixed blocking
        bw.write(7, 4)  # 16-bit blocksize-1 at end (always explicit: simplest)
        bw.write(_RATE_CODE.get(sample_rate, 0), 4)
        bw.write(channels - 1, 4)
        bw.write(_BPS_CODE[bits], 3)
        bw.write(0, 1)
        # UTF-8 coded frame number
        if fi < 0x80:
            bw.write(fi, 8)
        elif fi < 0x800:
            bw.write(0xC0 | (fi >> 6), 8)
            bw.write(0x80 | (fi & 0x3F), 8)
        else:
            bw.write(0xE0 | (fi >> 12), 8)
            bw.write(0x80 | ((fi >> 6) & 0x3F), 8)
            bw.write(0x80 | (fi & 0x3F), 8)
        bw.write(bs - 1, 16)
        bw.align()
        header = bw.getvalue()
        bw = _BitWriter()
        for b in header:
            bw.write(b, 8)
        bw.write(_crc8(header), 8)
        for c in range(channels):
            _encode_subframe(bw, [int(v) for v in block[:, c]], bits)
        bw.align()
        body = bw.getvalue()
        frames += body + struct.pack(">H", _crc16(body))

    # STREAMINFO (md5 is over the interleaved little-endian samples at bits)
    md5 = hashlib.md5()
    width = bits // 8
    flat = ints.reshape(-1)
    if width == 1:
        md5.update((flat & 0xFF).astype(np.uint8).tobytes())
    elif width == 2:
        md5.update(flat.astype("<i2").tobytes())
    elif width == 3:
        b32 = flat.astype("<i4").tobytes()
        md5.update(np.frombuffer(b32, np.uint8).reshape(-1, 4)[:, :3].tobytes())
    else:
        md5.update(flat.astype("<i4").tobytes())
    bw = _BitWriter()
    bw.write(blocksize, 16)
    bw.write(blocksize, 16)
    bw.write(0, 24)
    bw.write(0, 24)
    bw.write(sample_rate, 20)
    bw.write(channels - 1, 3)
    bw.write(bits - 1, 5)
    bw.write(n, 36)
    streaminfo = bw.getvalue() + md5.digest()
    assert len(streaminfo) == 34

    out = MAGIC + bytes([0x80]) + struct.pack(">I", 34)[1:] + streaminfo + bytes(frames)
    if path is not None:
        with open(path, "wb") as f:
            f.write(out)
    return out
