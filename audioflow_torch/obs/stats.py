"""Persisted usage stats: the stats.json analog (lifecycle/mod.rs:207-256).

Reference fields launch_count / total_recording_time / transcription_count /
last_used map to launch_count / total_audio_seconds / run_count / last_used.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
from pathlib import Path


def default_stats_path() -> Path:
    base = os.environ.get("XDG_DATA_HOME") or os.path.join(
        os.path.expanduser("~"), ".local", "share"
    )
    return Path(base) / "audioflow-tpu" / "stats.json"


class StatsFile:
    FIELDS = ("launch_count", "total_audio_seconds", "run_count", "last_used")

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path) if path else default_stats_path()
        self.data = {"launch_count": 0, "total_audio_seconds": 0.0, "run_count": 0, "last_used": None}
        self._load()

    def _load(self) -> None:
        try:
            loaded = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return  # missing/corrupt -> fresh stats (lifecycle behavior)
        for k in self.FIELDS:
            if k in loaded:
                self.data[k] = loaded[k]

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.data, indent=2))

    def record_launch(self) -> None:
        self.data["launch_count"] += 1
        self._touch()

    def record_run(self, audio_seconds: float) -> None:
        self.data["run_count"] += 1
        self.data["total_audio_seconds"] += float(audio_seconds)
        self._touch()

    def _touch(self) -> None:
        self.data["last_used"] = _dt.datetime.now(_dt.timezone.utc).isoformat()
