"""Structured logging setup (tracing + tauri-plugin-log analog, lib.rs:42-53:
stdout plus an optional file)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"


def setup_logging(level: str = "info", file_path: str | None = None) -> None:
    root = logging.getLogger("audioflow")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(sh)
    if file_path:
        fh = logging.FileHandler(file_path)
        fh.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(fh)


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"audioflow.{name}" if name else "audioflow")
