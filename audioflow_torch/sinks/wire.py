"""Wire codec: byte/JSON parity with the reference's network egress.

Exact shapes preserved (SURVEY §7.4):
* audio chunk: f32 -> clamp(-1,1)*32767 -> i16 (trunc) -> little-endian bytes
  -> base64 STANDARD -> ``{"audio_base_64": ..., "message_type":
  "input_audio_chunk"}`` (websocket.rs:244-263);
* configure: ``{"model_id", "language_code", "encoding": "pcm_16000",
  "message_type": "configure"}`` (websocket.rs:266-279);
* transcript post-processing strips 【SPEECH_CHANGE】/【SILENCE】 markers and
  trims (commands.rs:286-292).
"""

from __future__ import annotations

import base64
import json

import numpy as np

MARKERS = ("【SPEECH_CHANGE】", "【SILENCE】")


def pcm_f32_to_i16_bytes(samples: np.ndarray) -> bytes:
    """clamp * 32767, trunc toward zero (Rust `as i16`), little-endian; NaN
    as 0, as ``ops.quantize_i16``."""
    x = np.nan_to_num(np.asarray(samples, dtype=np.float32), nan=0.0)
    q = np.trunc(np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    return q.tobytes()


def i16_bytes_to_f32(data: bytes) -> np.ndarray:
    return np.frombuffer(data, "<i2").astype(np.float32) / 32768.0


def encode_audio_chunk(samples: np.ndarray) -> str:
    """One wire message for a PCM chunk (websocket.rs:244-263 parity)."""
    if np.asarray(samples).dtype == np.int16:
        payload = np.asarray(samples).astype("<i2").tobytes()
    else:
        payload = pcm_f32_to_i16_bytes(samples)
    b64 = base64.standard_b64encode(payload).decode("ascii")
    return json.dumps(
        {"audio_base_64": b64, "message_type": "input_audio_chunk"}, separators=(",", ":")
    )


def decode_audio_chunk(message: str) -> np.ndarray:
    obj = json.loads(message)
    if obj.get("message_type") != "input_audio_chunk":
        raise ValueError(f"not an audio chunk: {obj.get('message_type')!r}")
    return i16_bytes_to_f32(base64.standard_b64decode(obj["audio_base_64"]))


def configure_message(model_id: str, language_code: str, encoding: str = "pcm_16000") -> str:
    """Session init message (websocket.rs:266-279 parity)."""
    return json.dumps(
        {
            "model_id": model_id,
            "language_code": language_code,
            "encoding": encoding,
            "message_type": "configure",
        },
        separators=(",", ":"),
    )


def strip_markers(text: str) -> str:
    """Remove 【SPEECH_CHANGE】/【SILENCE】 and trim (commands.rs:286-292)."""
    for m in MARKERS:
        text = text.replace(m, "")
    return text.strip()
