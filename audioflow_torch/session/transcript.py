"""Scribe-protocol transcript parsing.

Mirrors ``audioflow_tpu/session/transcript.py``: the service's JSON messages
parsed into typed events by ``message_type``; the partial buffer that a
committed transcript replaces and clears; ``TranscriptionResult``-shaped
dicts with the 【SPEECH_CHANGE】/【SILENCE】 markers stripped.
"""

from __future__ import annotations

import enum
import json
import time
from dataclasses import dataclass, field

from ..sinks.wire import strip_markers


class ScribeEventKind(enum.Enum):
    SESSION_STARTED = "session_started"
    PARTIAL_TRANSCRIPT = "partial_transcript"
    COMMITTED_TRANSCRIPT = "committed_transcript"
    WORD_DETAILS = "word_details"
    ERROR = "error"
    DISCONNECTED = "disconnected"
    UNKNOWN = "unknown"


@dataclass(frozen=True)
class ScribeEvent:
    kind: ScribeEventKind
    text: str = ""
    confidence: float | None = None
    session_id: str | None = None
    words: tuple = ()
    message: str = ""
    raw: dict = field(default_factory=dict)


def parse_scribe_message(payload: str) -> ScribeEvent:
    """JSON message -> typed event by ``message_type`` (scribe_client.rs:259-344)."""
    try:
        obj = json.loads(payload)
    except json.JSONDecodeError as e:
        return ScribeEvent(ScribeEventKind.ERROR, message=f"invalid JSON: {e}")
    mt = obj.get("message_type", "")
    if mt == "session_started":
        return ScribeEvent(
            ScribeEventKind.SESSION_STARTED, session_id=obj.get("session_id"), raw=obj
        )
    if mt == "partial_transcript":
        return ScribeEvent(ScribeEventKind.PARTIAL_TRANSCRIPT, text=obj.get("text", ""), raw=obj)
    if mt == "committed_transcript":
        return ScribeEvent(
            ScribeEventKind.COMMITTED_TRANSCRIPT,
            text=obj.get("text", ""),
            confidence=obj.get("confidence"),
            raw=obj,
        )
    if mt == "word_details":
        return ScribeEvent(
            ScribeEventKind.WORD_DETAILS, words=tuple(obj.get("words", ())), raw=obj
        )
    if mt == "error":
        return ScribeEvent(ScribeEventKind.ERROR, message=obj.get("message", ""), raw=obj)
    if mt == "disconnected":
        return ScribeEvent(ScribeEventKind.DISCONNECTED, raw=obj)
    return ScribeEvent(ScribeEventKind.UNKNOWN, raw=obj)


class TranscriptAccumulator:
    """Partial-buffer semantics: partials accumulate into a buffer that a
    committed transcript replaces-and-clears (scribe_client.rs:113-118,
    286-308)."""

    def __init__(self):
        self.partial_buffer = ""
        self.session_id: str | None = None

    def feed(self, event: ScribeEvent) -> dict | None:
        """Returns a TranscriptionResult-shaped dict when text is available."""
        if event.kind is ScribeEventKind.SESSION_STARTED:
            self.session_id = event.session_id
            return None
        if event.kind is ScribeEventKind.PARTIAL_TRANSCRIPT:
            self.partial_buffer = event.text
            return self._result(event.text, None, is_final=False)
        if event.kind is ScribeEventKind.COMMITTED_TRANSCRIPT:
            self.partial_buffer = ""  # cleared on commit
            return self._result(event.text, event.confidence, is_final=True)
        return None

    @staticmethod
    def _result(text: str, confidence: float | None, is_final: bool) -> dict:
        return {
            "text": strip_markers(text),
            "confidence": confidence if confidence is not None else 1.0,
            "timestamp": time.time(),
            "is_final": is_final,
        }
