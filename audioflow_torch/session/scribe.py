"""The live duplex ASR session over the WebSocket client.

Mirrors ``audioflow_tpu/session/scribe.py``:

* a **receive thread** blocks on the socket with a short timeout and queues
  typed events and TranscriptionResults, so ``poll``/``try_receive`` never
  touch the socket from the caller's thread;
* **keepalive**: after ``keepalive_interval_s`` without a send it pings, so
  idle VAD-gated streams survive proxies;
* **reconnect with session resume**: on a server drop it reconnects with the
  configured backoff, sends the configure message again, and keeps the
  ``session_id`` and the partial buffer, so the transcript stream goes on.

Threads: one receive thread (the socket's only reader), one keepalive
thread; callers send from any thread (the client's frames are send-locked).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..errors import ErrorCode, IOError_
from ..obs import get_logger
from ..sinks.websocket import ConnectionState, Opcode, WebSocketClient, WebSocketConfig
from .transcript import ScribeEvent, ScribeEventKind, TranscriptAccumulator, parse_scribe_message

_log = get_logger("scribe")


@dataclass
class ScribeConfig:
    """Session knobs (ScribeConfig analog, scribe_client.rs:27-36)."""

    model_id: str = "scribe_v1"
    language_code: str = "en"
    auto_reconnect: bool = True
    receive_poll_s: float = 0.25  # socket-block granularity of the rx thread
    ws: WebSocketConfig = field(default_factory=WebSocketConfig)


class ScribeSession:
    """Open -> send_audio -> poll/try_receive -> close, fully duplex."""

    def __init__(self, config: ScribeConfig | None = None, client: WebSocketClient | None = None):
        self.config = config or ScribeConfig()
        self.client = client or WebSocketClient(self.config.ws)
        self.accumulator = TranscriptAccumulator()
        self._events: queue.Queue[ScribeEvent] = queue.Queue()
        self._results: queue.Queue[dict] = queue.Queue()
        self._closing = threading.Event()
        self._rx: threading.Thread | None = None
        self._ka: threading.Thread | None = None
        self._last_send = time.monotonic()
        self._reconnects = 0
        self.chunks_sent = 0

    # ------------------------------------------------------------- lifecycle
    @property
    def state(self) -> ConnectionState:
        return self.client.state

    @property
    def session_id(self) -> str | None:
        return self.accumulator.session_id

    @property
    def reconnect_count(self) -> int:
        return self._reconnects

    def connect(self) -> "ScribeSession":
        """Connect (with the configured retry schedule) and start the
        receive + keepalive threads."""
        self.client.connect_with_retry()
        self.client.send_init_config(self.config.model_id, self.config.language_code)
        self._last_send = time.monotonic()
        self._closing.clear()
        self._rx = threading.Thread(target=self._receive_loop, daemon=True, name="scribe-rx")
        self._rx.start()
        ka = self.config.ws.keepalive_interval_s
        if ka and ka > 0:
            self._ka = threading.Thread(target=self._keepalive_loop, daemon=True, name="scribe-ka")
            self._ka.start()
        return self

    def __enter__(self):
        return self.connect()

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        self._closing.set()
        self.client.close()
        for t in (self._rx, self._ka):
            if t is not None and t.is_alive():
                t.join(timeout=2.0)
        self._rx = self._ka = None

    # ------------------------------------------------------------------ send
    def send_audio(self, samples: np.ndarray, wait_reconnect_s: float = 0.0) -> None:
        """f32 PCM -> i16/base64/JSON chunk (websocket.rs:244-263).

        With ``wait_reconnect_s`` > 0, a send that races a reconnect waits up
        to that long for the receive thread to restore the connection, then
        retries once.
        """
        try:
            self.client.send_audio(samples)
        except IOError_:
            if wait_reconnect_s <= 0:
                raise
            deadline = time.monotonic() + wait_reconnect_s
            while self.client.state is not ConnectionState.CONNECTED:
                if time.monotonic() > deadline or self._closing.is_set():
                    raise
                time.sleep(0.02)
            self.client.send_audio(samples)
        self._last_send = time.monotonic()
        self.chunks_sent += 1

    def send_text(self, text: str) -> None:
        self.client.send_text(text)
        self._last_send = time.monotonic()

    # ------------------------------------------------------------------ poll
    def poll(self, timeout: float | None = 0.0) -> dict | None:
        """Next TranscriptionResult dict or None (non-blocking by default).

        ``timeout`` of 0/None means non-blocking; positive waits that long.
        There is deliberately no block-forever mode (a dead session would
        hang the caller)."""
        try:
            return self._results.get(timeout=timeout) if timeout else self._results.get_nowait()
        except queue.Empty:
            return None

    def try_receive(self, timeout: float = 0.1) -> dict | None:
        """Blocking-with-timeout poll (try_receive parity, scribe_client.rs:235-245)."""
        return self.poll(timeout=timeout)

    def poll_event(self, timeout: float | None = 0.0) -> ScribeEvent | None:
        """Next raw typed event (SessionStarted/Error/Disconnected/...)."""
        try:
            return self._events.get(timeout=timeout) if timeout else self._events.get_nowait()
        except queue.Empty:
            return None

    def drain(self, timeout: float, until_final: bool = True) -> list[dict]:
        """Collect results until a final transcript or the deadline."""
        out: list[dict] = []
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            r = self.poll(timeout=min(0.1, max(1e-3, deadline - time.monotonic())))
            if r is None:
                continue
            out.append(r)
            if until_final and r["is_final"]:
                break
        return out

    # --------------------------------------------------------------- threads
    def _receive_loop(self) -> None:
        while not self._closing.is_set():
            try:
                msg = self.client.receive(timeout=self.config.receive_poll_s)
            except IOError_ as err:
                if err.code is ErrorCode.CONNECTION_TIMEOUT:
                    continue  # idle socket; keep polling
                if self._closing.is_set():
                    return
                if not self._reconnect():
                    return
                continue
            if msg.opcode is Opcode.TEXT:
                event = parse_scribe_message(msg.text)
                self._events.put(event)
                result = self.accumulator.feed(event)
                if result is not None:
                    self._results.put(result)
                continue
            if msg.opcode is Opcode.CLOSE:
                if self._closing.is_set():
                    return
                self._events.put(ScribeEvent(ScribeEventKind.DISCONNECTED))
                if not self._reconnect():
                    return
            # PONG and binary frames are ignored (pings are answered inside
            # WebSocketClient.receive)

    def _reconnect(self) -> bool:
        """Reconnect + re-configure, preserving session_id/partial buffer.
        Returns False when giving up (auto_reconnect off or retries spent)."""
        if self._closing.is_set():
            return False
        if not self.config.auto_reconnect:
            self._events.put(
                ScribeEvent(ScribeEventKind.ERROR, message="connection lost (auto_reconnect off)")
            )
            return False
        sid = self.accumulator.session_id
        _log.info("scribe reconnecting (resume session_id=%s)", sid)
        try:
            self.client.close()
            self.client.connect_with_retry()
            if self._closing.is_set():
                # close() ran while we were inside the retry backoff: don't
                # resurrect the session it just tore down (zombie rx thread
                # holding a fresh socket past close)
                self.client.close()
                return False
            self.client.send_init_config(self.config.model_id, self.config.language_code)
        except IOError_ as err:
            self._events.put(ScribeEvent(ScribeEventKind.ERROR, message=f"reconnect failed: {err}"))
            return False
        self._last_send = time.monotonic()
        self._reconnects += 1
        self._events.put(
            ScribeEvent(ScribeEventKind.SESSION_STARTED, session_id=sid,
                        raw={"resumed": True, "reconnects": self._reconnects})
        )
        return True

    def _keepalive_loop(self) -> None:
        interval = self.config.ws.keepalive_interval_s
        tick = max(0.05, min(1.0, interval / 4.0))
        while not self._closing.wait(tick):
            if self.client.state is not ConnectionState.CONNECTED:
                continue
            if time.monotonic() - self._last_send >= interval:
                try:
                    self.client.ping()
                    self._last_send = time.monotonic()
                except IOError_:
                    pass  # the receive loop owns reconnect handling
