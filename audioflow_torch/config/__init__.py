"""Typed configuration tree with TOML persistence, secret storage and graph
specs.

Mirrors ``audioflow_tpu/config``: `ConfigManager` keeps a hot-swappable
snapshot with ``update(closure)`` read-modify-write; `UserConfig` is a
dataclass tree persisted as TOML, with the same keys and defaults; secrets
come from env vars or a 0600 file. Graphs serialize through the port's node
registry, forks through ``fork_to_spec``/``fork_from_spec``.
"""

from .manager import ConfigManager, default_config_path
from .schema import (
    ApiConfig,
    AudioConfig,
    GraphSpec,
    ObsConfig,
    SessionConfig,
    UserConfig,
    fork_from_spec,
    fork_to_spec,
    graph_from_spec,
    graph_to_spec,
)
from .secrets import ApiKeyStorage, EnvKeyStorage, FileKeyStorage, default_key_storage
from .toml_io import dumps_toml, loads_toml

__all__ = [
    "ApiConfig",
    "AudioConfig",
    "ConfigManager",
    "GraphSpec",
    "ObsConfig",
    "SessionConfig",
    "UserConfig",
    "ApiKeyStorage",
    "EnvKeyStorage",
    "FileKeyStorage",
    "default_key_storage",
    "default_config_path",
    "dumps_toml",
    "loads_toml",
    "fork_from_spec",
    "fork_to_spec",
    "graph_from_spec",
    "graph_to_spec",
]
