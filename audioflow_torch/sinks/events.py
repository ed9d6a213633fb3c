"""Observer hooks on graph/session execution.

The rebuild of the reference's app->frontend event bus
(modules/events/mod.rs:73-243): typed events, listener registration, a global
enable flag, and named emit helpers (recording/connection/level/result/error).
Here listeners are plain callables — progress bars, metric collectors, log
forwarders — instead of Tauri webview windows.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Callable


class EventKind(enum.Enum):
    SESSION_STATE = "session_state"  # recording/connection state changes
    AUDIO_LEVEL = "audio_level"  # rms/peak/is_speech telemetry (events:182-185)
    CHUNK_DONE = "chunk_done"  # per-chunk progress
    RESULT = "result"  # partial/committed outputs
    ERROR = "error"  # with recoverable flag (events:188-194)
    STATS = "stats"


@dataclass(frozen=True)
class Event:
    kind: EventKind
    payload: dict = field(default_factory=dict)


Listener = Callable[[Event], None]


class EventDispatcher:
    """Thread-safe fan-out with an enable flag (modules/events:104-118)."""

    def __init__(self, enabled: bool = True):
        self._listeners: list[Listener] = []
        self._lock = threading.Lock()
        self.enabled = enabled

    def subscribe(self, fn: Listener) -> Callable[[], None]:
        with self._lock:
            self._listeners.append(fn)

        def unsubscribe():
            with self._lock:
                if fn in self._listeners:
                    self._listeners.remove(fn)

        return unsubscribe

    def emit(self, kind: EventKind, **payload: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            listeners = list(self._listeners)
        ev = Event(kind, payload)
        for fn in listeners:
            fn(ev)

    # named helpers (modules/events:155-194 parity)
    def emit_session_state(self, state: str, **extra):
        self.emit(EventKind.SESSION_STATE, state=state, **extra)

    def emit_audio_level(self, rms: float, peak: float, is_speech: bool | None = None):
        self.emit(EventKind.AUDIO_LEVEL, rms=rms, peak=peak, is_speech=is_speech)

    def emit_result(self, data, final: bool, index: int):
        self.emit(EventKind.RESULT, data=data, final=final, index=index)

    def emit_error(self, message: str, code: str, recoverable: bool):
        self.emit(EventKind.ERROR, message=message, code=code, recoverable=recoverable)
