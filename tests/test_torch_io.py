"""The port's host I/O against the JAX package's on the same bytes.

The codecs are copies, so every output must be bit-equal: samples (dtype
and value), rates, probe fields, and the ``ErrorCode`` of every rejected
input. The batch decoders (the port's native build of ``native/wavcodec.cpp``
and its numpy fallback) must equal each other and the JAX package's
``decode_batch`` bit for bit, poisoned lanes included, and the batch
loader's batches those of the JAX package's loader, through its staging
ring and without one (page-locked staging needs a card).
"""

import struct

import numpy as np
import pytest

import audioflow_tpu.io as jio
import audioflow_torch.io as tio
from audioflow_tpu.errors import IOError_ as JIOError
from audioflow_torch.errors import IOError_ as TIOError
from audioflow_torch.io import loader as tloader
from audioflow_torch.io import native as tnative

_EXT_GUID_TAIL = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"


def _wav_bytes(payload, fmt, ch, rate, bits, extensible=False, list_chunk=False):
    tag = 0xFFFE if extensible else fmt
    body = struct.pack("<HHIIHH", tag, ch, rate, rate * ch * bits // 8, ch * bits // 8, bits)
    if extensible:
        body += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt) + _EXT_GUID_TAIL
    chunks = b"fmt " + struct.pack("<I", len(body)) + body
    if list_chunk:  # odd-sized metadata chunk before data, word-aligned
        chunks += b"LIST" + struct.pack("<I", 9) + b"INFOINAMx" + b"\x00"
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _payload(rng, fmt, bits, n):
    if fmt == 3:
        dt = "<f4" if bits == 32 else "<f8"
        return rng.uniform(-1, 1, n).astype(dt).tobytes()
    if bits == 8:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if bits == 24:
        return rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
    dt = {16: "<i2", 32: "<i4"}[bits]
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=np.int64).astype(dt).tobytes()


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


_CASES = [  # (format tag, bits, channels, extensible, list chunk)
    (1, 8, 1, False, False),
    (1, 16, 1, False, False),
    (1, 16, 2, False, True),
    (1, 24, 1, False, False),
    (1, 24, 2, True, False),
    (1, 32, 1, False, False),
    (3, 32, 1, False, False),
    (3, 32, 2, True, True),
    (3, 64, 1, False, False),
    (6, 8, 1, False, False),
    (7, 8, 2, False, False),
]


@pytest.mark.parametrize("fmt,bits,ch,ext,lst", _CASES)
def test_wav_read_and_probe_bit_equal(fmt, bits, ch, ext, lst):
    rng = np.random.default_rng(bits * 10 + ch)
    buf = _wav_bytes(_payload(rng, fmt, bits, 301 * ch), fmt, ch, 22050, bits, ext, lst)
    got, rate = tio.read_wav(buf)
    want, jrate = jio.read_wav(buf)
    assert rate == jrate == 22050 and _same(got, want)
    assert got.shape == ((301,) if ch == 1 else (301, ch))
    tp, jp = tio.probe(buf), jio.probe(buf)
    assert [getattr(tp, k) for k in jp.__slots__] == [getattr(jp, k) for k in jp.__slots__]
    assert tio.probe_audio(buf).n_frames == 301
    got2, _ = tio.read_audio(buf)
    assert _same(got2, want)


def _raises_same(fn_t, fn_j, arg):
    with pytest.raises(TIOError) as et:
        fn_t(arg)
    with pytest.raises(JIOError) as ej:
        fn_j(arg)
    assert et.value.code.value == ej.value.code.value
    assert et.value.message == ej.value.message
    return et.value.code.value


def test_wav_rejects_like_jax():
    rng = np.random.default_rng(0)
    good = _wav_bytes(_payload(rng, 1, 16, 64), 1, 1, 16000, 16)
    cases = {
        "garbage": b"this is not a wav file at all.........",
        "cut in fmt": good[:22],
        "no data": good[:36],
        "adpcm": _wav_bytes(b"\x00" * 64, 2, 1, 16000, 4),
        "float16": _wav_bytes(b"\x00" * 64, 3, 1, 16000, 16),
        "alaw16": _wav_bytes(b"\x00" * 64, 6, 1, 16000, 16),
        "bits12": _wav_bytes(b"\x00" * 64, 1, 1, 16000, 12),
    }
    codes = {k: _raises_same(tio.read_wav, jio.read_wav, v) for k, v in cases.items()}
    assert codes["garbage"] == "DECODE_FAILED" and codes["float16"] == "UNSUPPORTED_FORMAT"
    _raises_same(tio.read_wav, jio.read_wav, "/nonexistent/file.wav")
    # a data chunk declared longer than the buffer is clamped the same way
    cut = good[:-7]
    assert _same(tio.read_wav(cut)[0], jio.read_wav(cut)[0])


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("ch", [1, 2])
def test_wav_write_byte_equal(tmp_path, bits, ch):
    x = np.random.default_rng(ch).uniform(-1.2, 1.2, (500, ch) if ch > 1 else 500).astype(np.float32)
    tio.write_wav(tmp_path / "t.wav", x, 44100, bits)
    jio.write_wav(tmp_path / "j.wav", x, 44100, bits)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


@pytest.mark.parametrize("bits,ch", [(16, 1), (16, 2), (24, 1), (8, 2)])
def test_flac_write_read_bit_equal(tmp_path, bits, ch):
    x = np.random.default_rng(bits).uniform(-0.9, 0.9, (1500, ch) if ch > 1 else 1500).astype(np.float32)
    x[:200] = 0.0  # a CONSTANT subframe
    tb = tio.write_flac(tmp_path / "t.flac", x, 16000, bits, blocksize=576)
    jb = jio.write_flac(None, x, 16000, bits, blocksize=576)
    assert tb == jb == (tmp_path / "t.flac").read_bytes()
    got, rate = tio.read_flac(jb)
    want, jrate = jio.read_flac(jb)
    assert rate == jrate == 16000 and _same(got, want)
    assert _same(tio.read_audio(jb)[0], want)
    tp, jp = tio.probe_audio(jb), jio.probe_audio(jb)
    assert (tp.sample_rate, tp.channels, tp.n_frames) == (jp.sample_rate, jp.channels, jp.n_frames)


def test_flac_rejects_like_jax():
    jb = jio.write_flac(None, np.zeros(600, np.float32), 16000)
    for bad in (b"fLaC" + b"\x00" * 3, jb[:-40], b"fLaC" + b"\xff" * 60):
        _raises_same(tio.read_flac, jio.read_flac, bad)


def _aifc(comp, bits, payload, ch=1, n=None):
    comm = struct.pack(">hIh", ch, n if n is not None else 100, bits) + jio.aiff._write_extended(8000.0)
    comm += comp + b"\x00\x00"
    ssnd = struct.pack(">II", 0, 0) + payload
    body = b"AIFC" + b"COMM" + struct.pack(">I", len(comm)) + comm + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    return b"FORM" + struct.pack(">I", len(body)) + body


def test_aiff_read_write_bit_equal(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (400, 2)).astype(np.float32)
    tio.write_aiff(tmp_path / "t.aiff", x, 44100)
    jio.write_aiff(tmp_path / "j.aiff", x, 44100)
    buf = (tmp_path / "t.aiff").read_bytes()
    assert buf == (tmp_path / "j.aiff").read_bytes()
    bufs = [
        buf,
        _aifc(b"sowt", 16, rng.integers(-30000, 30000, 100).astype("<i2").tobytes()),
        _aifc(b"fl32", 32, rng.uniform(-1, 1, 100).astype(">f4").tobytes()),
        _aifc(b"NONE", 24, rng.integers(0, 256, 300, dtype=np.uint8).tobytes()),
        _aifc(b"NONE", 8, rng.integers(0, 256, 100, dtype=np.uint8).tobytes()),
    ]
    for b in bufs:
        got, rate = tio.read_aiff(b)
        want, jrate = jio.read_aiff(b)
        assert rate == jrate and _same(got, want)
        assert _same(tio.read_audio(b)[0], want)
    for bad in (b"FORM\x00\x00\x00\x04AIFF", _aifc(b"ulaw", 16, b"\x00" * 200), buf[:30]):
        _raises_same(tio.read_aiff, jio.read_aiff, bad)


def _batch_buffers(tmp_path):
    """Seven sources: WAV at two rates and depths, stereo, FLAC, AIFF, a
    garbage buffer and a missing path (both poisoned lanes)."""
    rng = np.random.default_rng(11)
    tio.write_wav(tmp_path / "a.wav", rng.uniform(-1, 1, 3000).astype(np.float32), 16000)
    tio.write_wav(tmp_path / "b.wav", rng.uniform(-1, 1, (2500, 2)).astype(np.float32), 16000, 32)
    tio.write_flac(tmp_path / "c.flac", rng.uniform(-1, 1, 2000).astype(np.float32), 16000, 24)
    tio.write_aiff(tmp_path / "d.aiff", rng.uniform(-1, 1, 1000).astype(np.float32), 22050)
    return [
        str(tmp_path / "a.wav"),
        (tmp_path / "b.wav").read_bytes(),
        b"RIFF\x10\x00\x00\x00WAVEjunk",
        str(tmp_path / "c.flac"),
        str(tmp_path / "missing.wav"),
        str(tmp_path / "d.aiff"),
        _wav_bytes(_payload(rng, 1, 24, 900), 1, 1, 48000, 24),
    ]


def test_decode_batch_native_numpy_and_jax_bit_equal(tmp_path):
    assert tnative.available(), tnative.load_error()
    srcs = _batch_buffers(tmp_path)
    nat = tio.decode_batch(srcs, pad_multiple=128, use_native=True)
    npy = tio.decode_batch(srcs, pad_multiple=128, use_native=False)
    ref = jio.decode_batch(srcs, pad_multiple=128, use_native=False)
    for got in (nat, npy):
        for k in ("samples", "lengths", "rates", "valid"):
            assert _same(getattr(got, k), getattr(ref, k)), k
        assert got.paths == ref.paths and got.audio_seconds == ref.audio_seconds
    assert list(ref.valid) == [True, True, False, True, False, True, True]
    assert not nat.samples[[2, 4]].any()
    # a warm staging buffer gives the same batch
    out = np.full((7, nat.samples.shape[1]), 7.0, np.float32)
    again = tio.decode_batch(srcs, use_native=True, out=out)
    assert again.samples is out and _same(out, nat.samples)


def test_native_build_is_digest_named_outside_the_jax_package():
    so = tnative.library_path()
    assert so.parent.name == "audioflow_torch" and so.parent.parent.name == "build"
    assert so.name.startswith("libwavcodec-") and so.exists()
    with pytest.raises(ValueError):
        tnative.decode_batch_mono([b""], 16, out=np.zeros((1, 8), np.float32))


def _loader_files(tmp_path):
    rng = np.random.default_rng(5)
    files = []
    for i in range(11):
        p = tmp_path / f"f{i:02d}.wav"
        tio.write_wav(p, rng.uniform(-1, 1, 500 + 37 * i).astype(np.float32), 16000)
        files.append(str(p))
    files[4] = str(tmp_path / "nope.wav")
    return files


@pytest.mark.parametrize("use_native", [True, False])
def test_batch_loader_ring_recycles_like_jax(tmp_path, use_native):
    files = _loader_files(tmp_path)
    loader = tio.BatchLoader(files, batch_size=2, stride=1024, prefetch=1, use_native=use_native)
    got, buffers = [], []
    for i, batch in enumerate(loader):
        # the batch is what decode_batch gives for its files (the JAX loader's too)
        want = jio.decode_batch(files[2 * i : 2 * i + 2], stride=1024, use_native=False)
        assert _same(batch.samples, want.samples) and _same(batch.valid, want.valid)
        got.append(batch.samples.copy())
        buffers.append(batch.samples)
    assert len(got) == len(loader) == 6
    # ring depth prefetch + 3 = 4: batches 4 and 5 were decoded into the
    # buffers of batches 0 and 1, and no other two batches share one
    shared = [(a, b) for a in range(6) for b in range(a + 1, 6) if np.shares_memory(buffers[a], buffers[b])]
    assert shared == [(0, 4), (1, 5)]
    jgot = [b.samples.copy() for b in jio.BatchLoader(files, 2, stride=1024, prefetch=1, use_native=False)]
    assert len(jgot) == 6 and all(_same(a, b) for a, b in zip(got, jgot))


def test_batch_loader_without_stride_like_jax(tmp_path):
    # no fixed stride: no ring, each batch padded to its own longest file
    files = _loader_files(tmp_path)
    got = list(tio.BatchLoader(files, batch_size=4, pad_multiple=256))
    want = list(jio.BatchLoader(files, batch_size=4, pad_multiple=256, use_native=False))
    assert [b.samples.shape for b in got] == [(4, 768), (4, 768), (3, 1024)]
    for g, w in zip(got, want):
        for k in ("samples", "lengths", "rates", "valid"):
            assert _same(getattr(g, k), getattr(w, k)), k
    assert not any(np.shares_memory(a.samples, b.samples) for a in got for b in got if a is not b)


def test_batch_loader_pin_memory_off_the_card():
    # page-locked staging needs a card: without one the ring allocation fails loudly
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    loader = tio.BatchLoader([b""], batch_size=1, stride=128)
    with pytest.raises(RuntimeError):
        list(loader.batches(pin_memory=True))
    assert len(list(loader)) == 1  # iterating the loader never pins


def test_batch_loader_errors_like_jax():
    with pytest.raises(TIOError) as e:
        tio.BatchLoader([], batch_size=0)
    assert e.value.code.value == "CONFIG_VALIDATION_ERROR"
    assert tloader.DecodedBatch.__dataclass_fields__.keys() >= {"samples", "lengths", "rates", "valid", "paths"}
