"""Credential storage for external sinks.

The reference shells out to the macOS Keychain (secure_storage.rs:36-107);
the cluster analog is env vars and a mode-0600 secrets file. Same trait
shape: store / retrieve / delete (secure_storage.rs:18-33), with the
ElevenLabs-named convenience preserved as a default account name.
"""

from __future__ import annotations

import json
import os
import stat
from pathlib import Path
from typing import Protocol

from ..errors import ConfigError, ErrorCode

DEFAULT_ACCOUNT = "elevenlabs"  # secure_storage.rs:139-170 parity


class ApiKeyStorage(Protocol):
    def store(self, account: str, key: str) -> None: ...
    def retrieve(self, account: str) -> str: ...
    def delete(self, account: str) -> None: ...


class EnvKeyStorage:
    """Read-only storage backed by environment variables.

    Account "elevenlabs" maps to AUDIOFLOW_API_KEY_ELEVENLABS, falling back
    to AUDIOFLOW_API_KEY.
    """

    prefix = "AUDIOFLOW_API_KEY"

    def _names(self, account: str) -> list[str]:
        return [f"{self.prefix}_{account.upper().replace('-', '_')}", self.prefix]

    def store(self, account: str, key: str) -> None:
        os.environ[self._names(account)[0]] = key

    def retrieve(self, account: str) -> str:
        for name in self._names(account):
            val = os.environ.get(name)
            if val:
                return val
        raise ConfigError(
            f"no API key in env for {account!r} (set {self._names(account)[0]})",
            code=ErrorCode.SECRET_NOT_FOUND,
        )

    def delete(self, account: str) -> None:
        os.environ.pop(self._names(account)[0], None)


class FileKeyStorage:
    """JSON secrets file with 0600 permissions (the Keychain-file analog)."""

    def __init__(self, path: str | os.PathLike | None = None):
        if path is None:
            base = os.environ.get("XDG_CONFIG_HOME") or os.path.join(
                os.path.expanduser("~"), ".config"
            )
            path = Path(base) / "audioflow-tpu" / "secrets.json"
        self.path = Path(path)

    def _read(self) -> dict:
        try:
            return json.loads(self.path.read_text())
        except FileNotFoundError:
            return {}
        except (OSError, json.JSONDecodeError) as e:
            raise ConfigError(f"bad secrets file: {e}", code=ErrorCode.CONFIG_PARSE_ERROR)

    def _write(self, data: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(data))
        self.path.chmod(stat.S_IRUSR | stat.S_IWUSR)

    def store(self, account: str, key: str) -> None:
        data = self._read()
        data[account] = key  # -U upsert semantics (secure_storage.rs:61-66)
        self._write(data)

    def retrieve(self, account: str) -> str:
        data = self._read()
        if account not in data:
            raise ConfigError(
                f"no stored key for {account!r}", code=ErrorCode.SECRET_NOT_FOUND
            )
        return data[account]

    def delete(self, account: str) -> None:
        data = self._read()
        # missing key is not an error (error-code-44 tolerance, secure_storage.rs:96-104)
        data.pop(account, None)
        self._write(data)


def default_key_storage() -> ApiKeyStorage:
    """Env first (cluster practice); file storage is opt-in."""
    return EnvKeyStorage()
