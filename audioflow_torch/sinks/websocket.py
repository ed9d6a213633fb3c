"""Minimal RFC 6455 WebSocket client for egress to an external ASR service.

Mirrors ``audioflow_tpu/sinks/websocket.py``, the reference's transport:
auth by the ``?xi_api_key=`` query parameter and an ``Origin`` header; a
connect timeout (30 s by default) and 401 -> AUTHENTICATION_FAILED;
``send_text`` / ``send_binary`` / ``send_audio`` (f32 -> i16 LE -> base64 ->
JSON, by :mod:`audioflow_torch.sinks.wire`) and ``send_init_config``;
``receive()`` mapping frames to typed messages, pings answered; the
connection states, Reconnecting included; ``connect_with_retry`` with the
shared exponential backoff of :mod:`audioflow_torch.errors`. Pure stdlib and
numpy: it runs on the host, and the tests drive it against a loopback
server in the same process.
"""

from __future__ import annotations

import base64
import enum
import hashlib
import secrets
import socket
import ssl
import struct
import threading
import time
import urllib.parse
from dataclasses import dataclass

import numpy as np

from ..errors import ErrorCode, IOError_
from .wire import configure_message, encode_audio_chunk

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class ConnectionState(enum.Enum):
    DISCONNECTED = "disconnected"
    CONNECTING = "connecting"
    CONNECTED = "connected"
    RECONNECTING = "reconnecting"
    FAILED = "failed"


class Opcode(enum.IntEnum):
    CONT = 0x0
    TEXT = 0x1
    BINARY = 0x2
    CLOSE = 0x8
    PING = 0x9
    PONG = 0xA


@dataclass(frozen=True)
class WsMessage:
    opcode: Opcode
    data: bytes

    @property
    def text(self) -> str:
        return self.data.decode("utf-8")


@dataclass
class WebSocketConfig:
    """Defaults mirror websocket.rs:66-90."""

    url: str = "wss://api.elevenlabs.io/v1/scribe"
    api_key: str = ""
    origin: str = "https://elevenlabs.io"
    connect_timeout_s: float = 30.0
    reconnect_delay_ms: int = 1000
    max_reconnect_attempts: int = 5
    keepalive_interval_s: float = 30.0


class WebSocketClient:
    def __init__(self, config: WebSocketConfig | None = None):
        self.config = config or WebSocketConfig()
        self.state = ConnectionState.DISCONNECTED
        self._sock: socket.socket | None = None
        self._recv_buf = b""
        # sends are frame-atomic so a receive thread's transparent pong (or a
        # keepalive ping) can never interleave bytes with send_audio
        self._send_lock = threading.Lock()

    # ------------------------------------------------------------- connect
    def connect(self) -> None:
        self.state = ConnectionState.CONNECTING
        try:
            self._handshake()
        except IOError_:
            self.state = ConnectionState.FAILED
            raise
        self.state = ConnectionState.CONNECTED

    def connect_with_retry(self) -> None:
        """Connect, retrying with exponential backoff (``reconnect_delay_ms``
        x ``max_reconnect_attempts``) by the shared RetryPolicy schedule."""
        from ..errors import RetryPolicy

        base = self.config.reconnect_delay_ms / 1000.0
        if self.config.max_reconnect_attempts < 1:
            # a non-positive attempt budget degenerates to a single plain
            # connect rather than an AssertionError from an empty loop
            self.connect()
            return
        policy = RetryPolicy(
            max_attempts=self.config.max_reconnect_attempts,
            base_delay_s=base,
            max_delay_s=max(2.0, base * 8),  # never cap below the configured delay
        )
        last: IOError_ | None = None
        for attempt in range(policy.max_attempts):
            self.state = ConnectionState.RECONNECTING
            try:
                self.connect()
                return
            except IOError_ as err:
                if err.code is ErrorCode.AUTHENTICATION_FAILED:
                    raise  # not recoverable by retrying (401)
                last = err
                if attempt + 1 < policy.max_attempts:  # no sleep after the last try
                    time.sleep(policy.delay_for(attempt))
        self.state = ConnectionState.FAILED
        assert last is not None
        raise last

    def _handshake(self) -> None:
        u = urllib.parse.urlsplit(self.config.url)
        secure = u.scheme in ("wss", "https")
        host = u.hostname or "localhost"
        port = u.port or (443 if secure else 80)
        path = u.path or "/"
        query = dict(urllib.parse.parse_qsl(u.query))
        if self.config.api_key:
            query["xi_api_key"] = self.config.api_key  # websocket.rs:156
        if query:
            path += "?" + urllib.parse.urlencode(query)
        try:
            raw = socket.create_connection((host, port), timeout=self.config.connect_timeout_s)
        except OSError as e:
            raise IOError_(
                f"connect to {host}:{port} failed: {e}", code=ErrorCode.CONNECTION_FAILED
            ) from None
        if secure:
            ctx = ssl.create_default_context()
            raw = ctx.wrap_socket(raw, server_hostname=host)
        key = base64.b64encode(secrets.token_bytes(16)).decode()
        req = (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n"
            f"Origin: {self.config.origin}\r\n"  # websocket.rs:160
            "\r\n"
        )
        raw.sendall(req.encode())
        try:
            head, remainder = self._read_http_head(raw)
            # frames may arrive coalesced with the handshake response —
            # anything past the header block is the first frame's bytes
            self._recv_buf = remainder
        except socket.timeout:
            raw.close()
            raise IOError_("websocket handshake timeout", code=ErrorCode.CONNECTION_TIMEOUT) from None
        status = head.split(b"\r\n", 1)[0]
        if b" 401" in status:
            raw.close()
            raise IOError_("authentication failed (401)", code=ErrorCode.AUTHENTICATION_FAILED)
        if b" 101" not in status:
            raw.close()
            raise IOError_(
                f"handshake rejected: {status.decode(errors='replace')}",
                code=ErrorCode.CONNECTION_FAILED,
            )
        accept_want = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        headers = {}
        for line in head.split(b"\r\n")[1:]:
            name, _, value = line.partition(b":")
            headers[name.strip().lower()] = value.strip().decode(errors="replace")
        if headers.get(b"sec-websocket-accept") != accept_want:
            raw.close()
            raise IOError_("bad Sec-WebSocket-Accept", code=ErrorCode.CONNECTION_FAILED)
        self._sock = raw

    @staticmethod
    def _read_http_head(sock: socket.socket) -> tuple[bytes, bytes]:
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                raise IOError_("connection closed during handshake", code=ErrorCode.CONNECTION_FAILED)
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        return head, rest

    # ---------------------------------------------------------------- send
    def _send_frame(self, opcode: Opcode, payload: bytes) -> None:
        if self._sock is None or self.state is not ConnectionState.CONNECTED:
            raise IOError_("not connected", code=ErrorCode.CONNECTION_FAILED)
        mask = secrets.token_bytes(4)
        n = len(payload)
        header = bytes([0x80 | opcode])
        if n < 126:
            header += bytes([0x80 | n])
        elif n < 1 << 16:
            header += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            header += bytes([0x80 | 127]) + struct.pack(">Q", n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        try:
            with self._send_lock:
                self._sock.sendall(header + mask + masked)
        except OSError as e:
            self.state = ConnectionState.FAILED
            raise IOError_(f"send failed: {e}", code=ErrorCode.CONNECTION_FAILED) from None

    def send_text(self, text: str) -> None:
        self._send_frame(Opcode.TEXT, text.encode("utf-8"))

    def send_binary(self, data: bytes) -> None:
        self._send_frame(Opcode.BINARY, data)

    def send_audio(self, samples: np.ndarray) -> None:
        """f32 -> i16 -> base64 -> input_audio_chunk JSON (websocket.rs:244-263)."""
        self.send_text(encode_audio_chunk(samples))

    def send_init_config(self, model_id: str, language_code: str) -> None:
        self.send_text(configure_message(model_id, language_code))

    def ping(self, payload: bytes = b"") -> None:
        """Keepalive ping (the behavior behind ``keepalive_interval_s``,
        websocket.rs:66-90 — declared there, implemented here)."""
        self._send_frame(Opcode.PING, payload)

    # ------------------------------------------------------------- receive
    def _read_exact(self, n: int) -> bytes:
        while len(self._recv_buf) < n:
            sock = self._sock
            if sock is None:  # closed concurrently
                self.state = ConnectionState.DISCONNECTED
                raise IOError_("connection closed", code=ErrorCode.CONNECTION_FAILED)
            try:
                chunk = sock.recv(65536)
            except socket.timeout:
                raise  # handled by receive() as CONNECTION_TIMEOUT
            except OSError as e:  # abrupt reset/close -> typed error
                self.state = ConnectionState.DISCONNECTED
                raise IOError_(
                    f"connection lost: {e}", code=ErrorCode.CONNECTION_FAILED
                ) from None
            if not chunk:
                self.state = ConnectionState.DISCONNECTED
                raise IOError_("connection closed", code=ErrorCode.CONNECTION_FAILED)
            self._recv_buf += chunk
        out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
        return out

    def receive(self, timeout: float | None = None) -> WsMessage:
        """Next data/control frame (websocket.rs:282-312 mapping). Pings are
        answered with pongs transparently."""
        sock = self._sock
        if sock is None:
            raise IOError_("not connected", code=ErrorCode.CONNECTION_FAILED)
        try:
            sock.settimeout(timeout)
        except OSError:  # closed concurrently (e.g. session shutdown race)
            self.state = ConnectionState.DISCONNECTED
            raise IOError_("connection closed", code=ErrorCode.CONNECTION_FAILED) from None
        try:
            while True:
                b0, b1 = self._read_exact(2)
                opcode = Opcode(b0 & 0x0F)
                masked = b1 & 0x80
                n = b1 & 0x7F
                if n == 126:
                    (n,) = struct.unpack(">H", self._read_exact(2))
                elif n == 127:
                    (n,) = struct.unpack(">Q", self._read_exact(8))
                mask = self._read_exact(4) if masked else b""
                payload = self._read_exact(n)
                if mask:
                    payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
                if opcode is Opcode.PING:
                    self._send_frame(Opcode.PONG, payload)
                    continue
                if opcode is Opcode.CLOSE:
                    self.state = ConnectionState.DISCONNECTED
                return WsMessage(opcode, payload)
        except socket.timeout:
            raise IOError_("receive timeout", code=ErrorCode.CONNECTION_TIMEOUT) from None

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._send_frame(Opcode.CLOSE, struct.pack(">H", 1000))
            except IOError_:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self.state = ConnectionState.DISCONNECTED
