"""Egress of the port: sinks, the wire codec, event hooks.

Mirrors ``audioflow_tpu/sinks`` without its websocket client, which comes
with the streaming session.
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
    "Event",
    "EventDispatcher",
    "EventKind",
    "JsonlSink",
    "NpySink",
    "Sink",
    "WavSink",
    "WireJsonlSink",
    "auto_sink",
    "configure_message",
    "decode_audio_chunk",
    "encode_audio_chunk",
    "i16_bytes_to_f32",
    "pcm_f32_to_i16_bytes",
    "strip_markers",
    "to_host",
]
