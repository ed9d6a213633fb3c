"""Loopback WebSocket servers for the port's egress tests and ``chip_smoke.py``.

Plain stdlib and numpy, no JAX: an in-process stand-in for the ASR service
on ``127.0.0.1`` at an ephemeral port. ``EchoServer`` takes one connection,
pings first and echoes each text or binary frame prefixed with ``ack:``.
``ScribeServer`` takes connections in sequence, each scripted by a dict:
``{"reply": True}`` answers a partial transcript after the first audio chunk
and a committed one after the third; ``{"drop_after_chunks": n}`` closes the
socket after the n-th audio chunk. It records the configure messages, the
pings, and every audio chunk as the int16 samples it carried.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
import time

import numpy as np

_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

COMMITTED_TEXT = "【SPEECH_CHANGE】turn it on【SILENCE】"


def _read_exact(conn, n):
    buf = b""
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except OSError:
            return buf
        if not chunk:
            return buf
        buf += chunk
    return buf


def _len_hdr(n):
    if n < 126:
        return bytes([n])
    if n < 1 << 16:
        return bytes([126]) + struct.pack(">H", n)
    return bytes([127]) + struct.pack(">Q", n)


def _handshake(conn):
    """Reads the upgrade request; returns its request line and headers."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        data = conn.recv(4096)
        if not data:
            return None, {}
        buf += data
    lines = buf.split(b"\r\n\r\n", 1)[0].decode().split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return lines[0], headers


def _accept(conn, headers):
    key = headers["sec-websocket-key"]
    accept = base64.b64encode(hashlib.sha1((key + _MAGIC).encode()).digest()).decode()
    conn.sendall(
        (
            "HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Accept: {accept}\r\n\r\n"
        ).encode()
    )


def _read_frame(conn):
    """``(opcode, payload)`` of the next client frame, or None at the end."""
    hdr = _read_exact(conn, 2)
    if len(hdr) < 2:
        return None
    b0, b1 = hdr
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(conn, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(conn, 8))
    mask = _read_exact(conn, 4) if b1 & 0x80 else b""
    payload = _read_exact(conn, n)
    if mask:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return b0 & 0xF, payload


def _server_socket(backlog):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(backlog)
    return sock


class EchoServer(threading.Thread):
    """One connection: handshake (401 on request), a ping, then echoes."""

    def __init__(self, reject_401=False, require_key=None):
        super().__init__(daemon=True)
        self.sock = _server_socket(1)
        self.port = self.sock.getsockname()[1]
        self.reject_401 = reject_401
        self.require_key = require_key
        self.request_line = ""
        self.headers = {}
        self.received: list = []

    def run(self):
        conn, _ = self.sock.accept()
        self.request_line, self.headers = _handshake(conn)
        if self.reject_401 or (self.require_key and f"xi_api_key={self.require_key}" not in self.request_line):
            conn.sendall(b"HTTP/1.1 401 Unauthorized\r\n\r\n")
            conn.close()
            return
        _accept(conn, self.headers)
        conn.sendall(bytes([0x80 | 0x9, 2]) + b"hi")  # the client answers with a pong
        for _ in range(10):
            frame = _read_frame(conn)
            if frame is None or frame[0] == 0x8:
                break
            op, payload = frame
            if op == 0xA:
                self.received.append(("pong", payload))
                continue
            self.received.append(("text" if op == 0x1 else "bin", payload))
            reply = b"ack:" + payload
            conn.sendall(bytes([0x80 | op]) + _len_hdr(len(reply)) + reply)
        conn.close()


class ScribeServer(threading.Thread):
    """Connections in sequence, each scripted (see the module docstring)."""

    def __init__(self, script):
        super().__init__(daemon=True)
        self.sock = _server_socket(4)
        self.port = self.sock.getsockname()[1]
        self.script = script
        self.connections = 0
        self.configures = 0
        self.request_lines: list[str] = []
        self.pings: list[float] = []
        self.audio: list[list[np.ndarray]] = []  # per connection, the int16 of each chunk

    def run(self):
        for cfg in self.script:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.connections += 1
            self.audio.append([])
            self._serve(conn, cfg)

    def _serve(self, conn, cfg):
        line, headers = _handshake(conn)
        if line is None:
            conn.close()
            return
        self.request_lines.append(line)
        _accept(conn, headers)

        def send_text(obj):
            payload = json.dumps(obj).encode()
            conn.sendall(bytes([0x81]) + _len_hdr(len(payload)) + payload)

        send_text({"message_type": "session_started", "session_id": f"s-{self.connections}"})
        chunks = 0
        conn.settimeout(10.0)
        while True:
            frame = _read_frame(conn)
            if frame is None or frame[0] == 0x8:
                break
            op, payload = frame
            if op == 0x9:  # ping: record and answer
                self.pings.append(time.monotonic())
                conn.sendall(bytes([0x8A]) + _len_hdr(len(payload)) + payload)
                continue
            if op != 0x1:
                continue
            try:
                obj = json.loads(payload)
            except ValueError:
                continue
            kind = obj.get("message_type")
            if kind == "configure":
                self.configures += 1
                continue
            if kind != "input_audio_chunk":
                continue
            chunks += 1
            self.audio[-1].append(np.frombuffer(base64.standard_b64decode(obj["audio_base_64"]), "<i2").copy())
            if cfg.get("drop_after_chunks") is not None and chunks >= cfg["drop_after_chunks"]:
                conn.close()  # an abrupt drop by the server
                return
            if cfg.get("reply"):
                if chunks == 1:
                    send_text({"message_type": "partial_transcript", "text": "turn"})
                elif chunks == 3:
                    send_text({"message_type": "committed_transcript", "text": COMMITTED_TEXT, "confidence": 0.9})
        conn.close()
