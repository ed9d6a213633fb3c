"""The port's transcript parsing, WebSocket client and ScribeSession: the
parser and accumulator against the JAX package's on the same messages, the
client and the session against the loopback servers of ``ws_loopback.py``
(as ``test_websocket.py`` and ``test_scribe_session.py`` drive the JAX
package's)."""

import base64
import json
import time

import numpy as np
import pytest

from audioflow_tpu.session import transcript as jtr
from audioflow_torch.errors import ErrorCode, IOError_
from audioflow_torch.session import ScribeConfig, ScribeSession
from audioflow_torch.session import transcript as ttr
from audioflow_torch.sinks.websocket import ConnectionState, Opcode, WebSocketClient, WebSocketConfig
from ws_loopback import EchoServer, ScribeServer

MESSAGES = [
    '{"message_type": "session_started", "session_id": "abc"}',
    '{"message_type": "partial_transcript", "text": "hel"}',
    '{"message_type": "partial_transcript", "text": "hello wor"}',
    '{"message_type": "committed_transcript", "text": "【SPEECH_CHANGE】hello world【SILENCE】", "confidence": 0.8}',
    '{"message_type": "committed_transcript", "text": "no confidence"}',
    '{"message_type": "word_details", "words": [{"w": "hi"}]}',
    '{"message_type": "error", "message": "quota"}',
    '{"message_type": "disconnected"}',
    '{"message_type": "something_new"}',
    "not json",
]


def test_parse_and_accumulate_match_jax():
    t_acc, j_acc = ttr.TranscriptAccumulator(), jtr.TranscriptAccumulator()
    for m in MESSAGES:
        te, je = ttr.parse_scribe_message(m), jtr.parse_scribe_message(m)
        assert te.kind.value == je.kind.value
        assert (te.text, te.confidence, te.session_id, te.words, te.raw) == (
            je.text, je.confidence, je.session_id, je.words, je.raw)
        assert te.message.split(":")[0] == je.message.split(":")[0]
        tr, jr = t_acc.feed(te), j_acc.feed(je)
        assert (tr is None) == (jr is None)
        if tr is not None:
            assert {k: v for k, v in tr.items() if k != "timestamp"} == {k: v for k, v in jr.items() if k != "timestamp"}
        assert (t_acc.partial_buffer, t_acc.session_id) == (j_acc.partial_buffer, j_acc.session_id)
    assert t_acc.session_id == "abc"


def _client(port, **kw):
    return WebSocketClient(WebSocketConfig(url=f"ws://127.0.0.1:{port}/v1/scribe", connect_timeout_s=5.0, **kw))


def test_client_handshake_auth_echo_and_pong():
    srv = EchoServer(require_key="sk-test")
    srv.start()
    c = _client(srv.port, api_key="sk-test", origin="https://example.org")
    c.connect()
    assert c.state is ConnectionState.CONNECTED
    c.send_text("hello")
    msg = c.receive(timeout=5.0)
    assert msg.opcode is Opcode.TEXT and msg.text == "ack:hello"
    c.close()
    assert c.state is ConnectionState.DISCONNECTED
    srv.join(timeout=3)
    assert "xi_api_key=sk-test" in srv.request_line and srv.headers["origin"] == "https://example.org"
    assert ("pong", b"hi") in srv.received


def test_client_401_and_unconnected_send():
    srv = EchoServer(reject_401=True)
    srv.start()
    c = _client(srv.port)
    with pytest.raises(IOError_) as ei:
        c.connect()
    assert ei.value.code is ErrorCode.AUTHENTICATION_FAILED and c.state is ConnectionState.FAILED
    with pytest.raises(IOError_):
        WebSocketClient().send_text("nope")


def test_client_send_audio_wire_shape_and_configure():
    srv = EchoServer()
    srv.start()
    c = _client(srv.port)
    c.connect()
    c.send_audio(np.array([0.5, -1.5, np.nan, 0.99999], np.float32))
    obj = json.loads(c.receive(timeout=5.0).text[4:])
    assert obj["message_type"] == "input_audio_chunk"
    assert base64.standard_b64decode(obj["audio_base_64"]) == np.array([16383, -32767, 0, 32766], "<i2").tobytes()
    c.send_init_config("scribe_v1", "en")
    cfg = json.loads(c.receive(timeout=5.0).text[4:])
    assert cfg == {"model_id": "scribe_v1", "language_code": "en", "encoding": "pcm_16000", "message_type": "configure"}
    c.close()


def test_client_retry_gives_up_and_zero_attempts_connect_once():
    for attempts in (2, 0):
        c = WebSocketClient(WebSocketConfig(url="ws://127.0.0.1:9/", connect_timeout_s=0.3,
                                            reconnect_delay_ms=10, max_reconnect_attempts=attempts))
        with pytest.raises(IOError_):
            c.connect_with_retry()
        assert c.state is ConnectionState.FAILED


def _session(port, keepalive=0.0, auto_reconnect=True):
    return ScribeSession(ScribeConfig(
        auto_reconnect=auto_reconnect, receive_poll_s=0.05,
        ws=WebSocketConfig(url=f"ws://127.0.0.1:{port}/v1/scribe", connect_timeout_s=3.0, reconnect_delay_ms=50,
                           max_reconnect_attempts=5, keepalive_interval_s=keepalive),
    ))


def test_session_duplex_partials_commit_and_keepalive():
    srv = ScribeServer([{"reply": True}])
    srv.start()
    chunk = (0.1 * np.sin(np.arange(3200) / 5.0)).astype(np.float32)
    with _session(srv.port, keepalive=0.15) as s:
        deadline = time.monotonic() + 3
        while s.session_id is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert s.session_id == "s-1"
        for _ in range(3):
            s.send_audio(chunk)
        results = s.drain(timeout=3.0)
        time.sleep(0.5)  # idle: the keepalive pings
        assert s.state is ConnectionState.CONNECTED
    assert [r["is_final"] for r in results] == [False, True]
    assert results[1]["text"] == "turn it on" and results[1]["confidence"] == pytest.approx(0.9)
    assert s.chunks_sent == 3 and len(srv.pings) >= 2
    want = np.trunc(np.clip(chunk, -1, 1) * 32767).astype(np.int16)
    for got in srv.audio[0]:
        np.testing.assert_array_equal(got, want)


def test_session_server_drop_reconnects_and_resumes():
    srv = ScribeServer([{"drop_after_chunks": 2}, {"reply": True}])
    srv.start()
    chunk = np.zeros(3200, np.float32)
    with _session(srv.port) as s:
        while s.session_id is None:
            time.sleep(0.01)
        first_sid = s.session_id
        s.send_audio(chunk)
        s.send_audio(chunk)  # the server drops the socket after this one
        results = []
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline and not any(r["is_final"] for r in results):
            s.send_audio(chunk, wait_reconnect_s=3.0)
            time.sleep(0.03)
            while (r := s.poll()) is not None:
                results.append(r)
        assert s.reconnect_count == 1 and first_sid == "s-1"
        events = []
        while (e := s.poll_event()) is not None:
            events.append(e)
        resumed = [e for e in events if e.raw.get("resumed")]
        assert len(resumed) == 1 and resumed[0].session_id == "s-1"  # the resume event keeps the first id
    assert srv.connections == 2 and srv.configures == 2
    assert [r["text"] for r in results if r["is_final"]][:1] == ["turn it on"]


def test_session_without_auto_reconnect_surfaces_error():
    srv = ScribeServer([{"drop_after_chunks": 1}])
    srv.start()
    s = _session(srv.port, auto_reconnect=False)
    s.connect()
    s.send_audio(np.zeros(3200, np.float32))
    kinds, deadline = [], time.monotonic() + 3
    while time.monotonic() < deadline:
        e = s.poll_event(timeout=0.1)
        if e is not None:
            kinds.append(e.kind)
            if e.kind is ttr.ScribeEventKind.ERROR:
                break
    s.close()
    assert ttr.ScribeEventKind.ERROR in kinds and s.reconnect_count == 0
