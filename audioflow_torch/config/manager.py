"""ConfigManager: hot-swappable config snapshot with TOML persistence.

Python rendering of the reference's ArcSwap pattern (manager.rs:96-148):
``current()`` returns an immutable-by-convention snapshot; ``update(fn)`` is
the closure-based read-modify-write; ``load``/``save`` round-trip TOML at
``~/.config/audioflow-tpu/config.toml`` by default (manager.rs:113-136), the
JAX package's file, so one config serves both packages.
"""

from __future__ import annotations

import copy
import os
import threading
from pathlib import Path
from typing import Callable

from ..errors import ConfigError, ErrorCode
from .schema import UserConfig
from .toml_io import dumps_toml, loads_toml


def default_config_path() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME") or os.path.join(os.path.expanduser("~"), ".config")
    return Path(base) / "audioflow-tpu" / "config.toml"


class ConfigManager:
    def __init__(self, path: str | os.PathLike | None = None, config: UserConfig | None = None):
        self.path = Path(path) if path else default_config_path()
        self._lock = threading.Lock()
        self._config = config or UserConfig()

    def current(self) -> UserConfig:
        """Snapshot (deep copy so callers can't mutate shared state)."""
        with self._lock:
            return copy.deepcopy(self._config)

    def update(self, fn: Callable[[UserConfig], None]) -> UserConfig:
        """Read-modify-write under the lock (manager.rs:142-147 parity)."""
        with self._lock:
            cfg = copy.deepcopy(self._config)
            fn(cfg)
            self._config = cfg
            return copy.deepcopy(cfg)

    def replace(self, cfg: UserConfig) -> None:
        with self._lock:
            self._config = copy.deepcopy(cfg)

    def load(self) -> UserConfig:
        """Load from disk; missing file keeps defaults (manager.rs behavior)."""
        try:
            text = self.path.read_text()
        except FileNotFoundError:
            return self.current()
        except OSError as e:
            raise ConfigError(f"cannot read {self.path}: {e}", code=ErrorCode.CONFIG_NOT_FOUND)
        try:
            data = loads_toml(text)
        except Exception as e:
            raise ConfigError(
                f"invalid TOML in {self.path}: {e}", code=ErrorCode.CONFIG_PARSE_ERROR
            ) from None
        cfg = UserConfig.from_dict(data)
        self.replace(cfg)
        return cfg

    def save(self) -> None:
        cfg = self.current()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(dumps_toml(cfg.to_dict()))
