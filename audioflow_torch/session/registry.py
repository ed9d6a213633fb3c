"""Global session registry: the live sessions, and the two aggregate flags
(any stream running, any session connected) the reference's app state keeps.

Mirrors ``audioflow_tpu/session/registry.py``.
"""

from __future__ import annotations

import threading
import weakref


class SessionRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._sessions: "weakref.WeakSet" = weakref.WeakSet()

    def register(self, session) -> None:
        with self._lock:
            self._sessions.add(session)

    def unregister(self, session) -> None:
        with self._lock:
            self._sessions.discard(session)

    def live_sessions(self) -> list:
        from . import SessionState

        with self._lock:
            return [s for s in self._sessions if s.state is SessionState.OPEN]

    @property
    def is_running(self) -> bool:
        """Any open session streaming (is_recording analog)."""
        return bool(self.live_sessions())

    @property
    def is_connected(self) -> bool:
        """Any open session at all (is_connected analog)."""
        return self.is_running


REGISTRY = SessionRegistry()
