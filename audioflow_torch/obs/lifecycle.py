"""App lifecycle: directories, cleanup tasks, launch bookkeeping.

Rebuild of the reference's LifecycleManager/ResourceManager
(lifecycle/mod.rs:59-205): XDG-style app dirs with ensure_dirs, registered
cleanup callbacks run at exit (LIFO), and start/exit state with callbacks.
"""

from __future__ import annotations

import enum
import os
from pathlib import Path
from typing import Callable

from .logging import get_logger
from .stats import StatsFile

_log = get_logger("lifecycle")


class AppPhase(enum.Enum):
    CREATED = "created"
    STARTED = "started"
    EXITING = "exiting"
    EXITED = "exited"


class AppDirs:
    """config/data/log directories (lifecycle/mod.rs:120-165)."""

    def __init__(self, app_name: str = "audioflow-tpu"):
        home = os.path.expanduser("~")
        self.config = Path(os.environ.get("XDG_CONFIG_HOME") or f"{home}/.config") / app_name
        self.data = Path(os.environ.get("XDG_DATA_HOME") or f"{home}/.local/share") / app_name
        self.logs = self.data / "logs"

    def ensure_dirs(self) -> "AppDirs":
        for d in (self.config, self.data, self.logs):
            d.mkdir(parents=True, exist_ok=True)
        return self


class LifecycleManager:
    def __init__(self, dirs: AppDirs | None = None, stats: StatsFile | None = None):
        self.dirs = dirs or AppDirs()
        self.stats = stats
        self.phase = AppPhase.CREATED
        self._cleanup: list[tuple[str, Callable[[], None]]] = []
        self._on_phase: list[Callable[[AppPhase], None]] = []

    def on_phase_change(self, fn: Callable[[AppPhase], None]) -> None:
        self._on_phase.append(fn)

    def _set_phase(self, phase: AppPhase) -> None:
        self.phase = phase
        for fn in list(self._on_phase):
            fn(phase)

    def start(self) -> "LifecycleManager":
        self.dirs.ensure_dirs()
        if self.stats is None:
            self.stats = StatsFile(self.dirs.data / "stats.json")
        self.stats.record_launch()
        self.stats.save()
        self._set_phase(AppPhase.STARTED)
        return self

    def register_cleanup(self, name: str, fn: Callable[[], None]) -> None:
        """Registered tasks run LIFO at exit (lifecycle/mod.rs:167-205)."""
        self._cleanup.append((name, fn))

    def exit(self) -> None:
        if self.phase is AppPhase.EXITED:
            return
        self._set_phase(AppPhase.EXITING)
        for name, fn in reversed(self._cleanup):
            try:
                fn()
            except Exception as e:  # cleanup must never abort shutdown
                _log.error("cleanup task %r failed: %s", name, e)
        if self.stats is not None:
            self.stats.save()
        self._set_phase(AppPhase.EXITED)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.exit()
        return False
