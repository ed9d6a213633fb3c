"""The port's wire helpers, sinks and event hooks against the JAX package's.

Every wire helper must return the same bytes or string on the same input,
and every file sink must write a file byte-equal to the JAX package's sink
given the same chunks. The port's sinks also take tensors.
"""

import json

import numpy as np
import pytest
import torch

import audioflow_tpu.sinks as jsinks
import audioflow_torch.sinks as tsinks
from audioflow_torch.errors import SinkError


@pytest.fixture
def pcm():
    x = np.random.default_rng(0).uniform(-1.3, 1.3, 777).astype(np.float32)
    x[:3] = [1.0, -1.0, 0.99999]
    return x


def test_wire_helpers_equal(pcm):
    assert tsinks.pcm_f32_to_i16_bytes(pcm) == jsinks.pcm_f32_to_i16_bytes(pcm)
    msg = tsinks.encode_audio_chunk(pcm)
    assert msg == jsinks.encode_audio_chunk(pcm)
    i16 = (pcm * 1000).astype(np.int16)
    assert tsinks.encode_audio_chunk(i16) == jsinks.encode_audio_chunk(i16)
    got, want = tsinks.decode_audio_chunk(msg), jsinks.decode_audio_chunk(msg)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    raw = tsinks.pcm_f32_to_i16_bytes(pcm)
    assert np.array_equal(tsinks.i16_bytes_to_f32(raw), jsinks.i16_bytes_to_f32(raw))
    assert tsinks.configure_message("m", "en") == jsinks.configure_message("m", "en")
    text = " 【SILENCE】hello【SPEECH_CHANGE】 world "
    assert tsinks.strip_markers(text) == jsinks.strip_markers(text) == "hello world"
    with pytest.raises(ValueError):
        tsinks.decode_audio_chunk(json.dumps({"message_type": "configure"}))


def _chunks():
    rng = np.random.default_rng(1)
    return [rng.uniform(-1, 1, (2, 300)).astype(np.float32), rng.uniform(-1, 1, (1, 300)).astype(np.float32)]


@pytest.mark.parametrize(
    "make",
    [
        lambda m, p: m.NpySink(p / "out.npy"),
        lambda m, p: m.JsonlSink(p / "out.jsonl"),
        lambda m, p: m.WavSink(p / "out.wav", 16000),
        lambda m, p: m.WavSink(p / "out.wav", 16000, bits=32),
        lambda m, p: m.WireJsonlSink(p / "out.jsonl"),
    ],
    ids=["npy", "jsonl", "wav16", "wav32", "wire"],
)
def test_file_sinks_byte_equal(tmp_path, make):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ts, js = make(tsinks, tmp_path / "t"), make(jsinks, tmp_path / "j")
    for c in _chunks():
        ts.write(torch.from_numpy(c))  # the port's sinks take tensors too
        js.write(c)
    tp, jp = ts.close(), js.close()
    assert tp.name == jp.name and tp.read_bytes() == jp.read_bytes()


def test_wav_sink_single_row_is_mono(tmp_path):
    x = np.random.default_rng(2).uniform(-1, 1, (1, 500)).astype(np.float32)
    for m, d in ((tsinks, "t"), (jsinks, "j")):
        s = m.WavSink(tmp_path / d / "o.wav", 8000)
        s.write(x)
        s.close()
    assert (tmp_path / "t" / "o.wav").read_bytes() == (tmp_path / "j" / "o.wav").read_bytes()


def test_array_and_callback_sinks(pcm):
    ts, js = tsinks.ArraySink(), jsinks.ArraySink()
    assert ts.result().shape == js.result().shape == (0,)
    for c in _chunks():
        ts.write(torch.from_numpy(c))
        js.write(c)
    assert np.array_equal(ts.close(), js.close())
    seen = []
    with tsinks.CallbackSink(seen.append) as cb:
        cb.write(torch.ones(3))
    assert isinstance(seen[0], np.ndarray) and seen[0].tolist() == [1.0, 1.0, 1.0]
    assert tsinks.to_host(torch.arange(3)).tolist() == [0, 1, 2]


def test_auto_sink_picks_like_jax(tmp_path):
    for name, sr in (("a.npy", None), ("a.wav", 16000), ("a.jsonl", None), (None, None)):
        path = None if name is None else tmp_path / name
        t, j = tsinks.auto_sink(path, sr), jsinks.auto_sink(path, sr)
        assert type(t).__name__ == type(j).__name__
        t.close()
        j.close()
    for name, sr in (("a.wav", None), ("a.mp3", None)):
        with pytest.raises(SinkError) as et:
            tsinks.auto_sink(tmp_path / name, sr)
        with pytest.raises(jsinks.sinks.SinkError) as ej:
            jsinks.auto_sink(tmp_path / name, sr)
        assert et.value.code.value == ej.value.code.value


def test_event_dispatcher_like_jax():
    logs = {}
    for m in (tsinks, jsinks):
        ev = m.EventDispatcher()
        seen = []
        unsub = ev.subscribe(lambda e: seen.append((e.kind.value, e.payload)))
        ev.emit_session_state("recording", extra=1)
        ev.emit_audio_level(0.1, 0.5, True)
        ev.emit_result([1, 2], final=True, index=3)
        ev.emit_error("boom", "SINK_WRITE_FAILED", recoverable=False)
        unsub()
        ev.emit_result([0], final=False, index=4)
        ev.enabled = False
        logs[m.__name__] = seen
    assert logs["audioflow_torch.sinks"] == logs["audioflow_tpu.sinks"]
    assert len(logs["audioflow_torch.sinks"]) == 4
    assert [k.value for k in tsinks.EventKind] == [k.value for k in jsinks.EventKind]
