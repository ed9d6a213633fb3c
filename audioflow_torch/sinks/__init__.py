"""Egress of the port: sinks, the wire codec, event hooks.

Mirrors ``audioflow_tpu/sinks``: file and array sinks, the wire codec, the
event hooks, and the WebSocket client of the dictation egress.
"""

from .events import Event, EventDispatcher, EventKind
from .sinks import (
    ArraySink,
    CallbackSink,
    JsonlSink,
    NpySink,
    Sink,
    WavSink,
    WireJsonlSink,
    auto_sink,
    to_host,
)
from .websocket import ConnectionState, Opcode, WebSocketClient, WebSocketConfig, WsMessage
from .wire import (
    configure_message,
    decode_audio_chunk,
    encode_audio_chunk,
    i16_bytes_to_f32,
    pcm_f32_to_i16_bytes,
    strip_markers,
)

__all__ = [
    "ArraySink",
    "CallbackSink",
    "ConnectionState",
    "Event",
    "EventDispatcher",
    "EventKind",
    "JsonlSink",
    "NpySink",
    "Opcode",
    "Sink",
    "WavSink",
    "WebSocketClient",
    "WebSocketConfig",
    "WireJsonlSink",
    "WsMessage",
    "auto_sink",
    "configure_message",
    "decode_audio_chunk",
    "encode_audio_chunk",
    "i16_bytes_to_f32",
    "pcm_f32_to_i16_bytes",
    "strip_markers",
    "to_host",
]
