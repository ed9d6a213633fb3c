"""Config schema: the dataclass tree persisted to TOML, and graph specs.

Mirrors ``audioflow_tpu/config/schema.py``: the same sections, TOML keys
and defaults, and the same ``GraphSpec`` JSON. :func:`graph_from_spec`
builds the port's nodes from the port's ``node_registry``, so a spec written
by the JAX package's ``graph_to_spec`` loads here into a graph that computes
the same thing. A node type the port does not have yet raises
:class:`ConfigError` naming it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from ..errors import ConfigError, ErrorCode
from ..graph import Graph, node_registry
from ..ops.biquad import Biquad


@dataclass
class ApiConfig:
    """External-service sink settings (ScribeConfig analog, scribe_client.rs:27-36)."""

    api_key_env: str = "AUDIOFLOW_API_KEY"
    model_id: str = "scribe_v1"
    language_code: str = "en"
    endpoint: str = ""
    connect_timeout_s: float = 30.0  # websocket.rs:165-167 parity
    reconnect_delay_ms: int = 1000  # websocket.rs:72-76 parity
    max_reconnect_attempts: int = 5


@dataclass
class AudioConfig:
    """Ingest + kernel defaults (AudioConfig analog, capture.rs:71-80)."""

    sample_rate: int = 48000
    target_rate: int = 16000
    channels: int = 1
    chunk_ms: int = 20  # reference capture cadence
    resample_mode: str = "kaiser"
    n_fft: int = 1024
    hop: int = 256
    n_mels: int = 128
    window: str = "hann"
    # named VAD sensitivity preset (get/set_vad_level parity,
    # commands.rs:482-511); see ops.vad.VAD_LEVELS for the thresholds
    vad_level: str = "balanced"


@dataclass
class SessionConfig:
    chunk_in: int = 4800  # streaming push granularity (input samples)
    emit_partials: bool = True
    snapshot_dir: str = ""


@dataclass
class ObsConfig:
    log_level: str = "info"
    stats_path: str = ""  # empty -> default app dir
    profile_dir: str = ""
    enable_events: bool = True


@dataclass
class UserConfig:
    api: ApiConfig = field(default_factory=ApiConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    session: SessionConfig = field(default_factory=SessionConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "UserConfig":
        def build(dc_type, d):
            if not isinstance(d, dict):
                raise ConfigError(
                    f"expected table for {dc_type.__name__}, got {type(d).__name__}",
                    code=ErrorCode.CONFIG_PARSE_ERROR,
                )
            names = {f.name: f for f in dataclasses.fields(dc_type)}
            unknown = set(d) - set(names)
            if unknown:
                raise ConfigError(
                    f"unknown keys in {dc_type.__name__}: {sorted(unknown)}",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            return dc_type(**d)

        kwargs: dict[str, Any] = {}
        sections = {"api": ApiConfig, "audio": AudioConfig, "session": SessionConfig, "obs": ObsConfig}
        unknown = set(data) - set(sections)
        if unknown:
            raise ConfigError(
                f"unknown config sections: {sorted(unknown)}",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        for key, typ in sections.items():
            if key in data:
                kwargs[key] = build(typ, data[key])
        return cls(**kwargs)


# --------------------------------------------------------------------------
# graph (de)serialization through the node registry
# --------------------------------------------------------------------------

@dataclass
class GraphSpec:
    """Declarative graph: list of {type: NodeClassName, **fields}."""

    nodes: list[dict]
    input_rate: int | None = None
    name: str = "graph"


def _encode_field(v):
    from ..graph.nodes import Node

    if isinstance(v, Biquad):
        return {"__biquad__": dataclasses.asdict(v)}
    if isinstance(v, Node):  # nested nodes (Mix branches)
        d = {"type": type(v).__name__}
        for f in dataclasses.fields(v):
            d[f.name] = _encode_field(getattr(v, f.name))
        return {"__node__": d}
    if isinstance(v, tuple):
        return [_encode_field(x) for x in v]
    return v


def _decode_field(v):
    if isinstance(v, dict) and "__biquad__" in v:
        return Biquad(**v["__biquad__"])
    if isinstance(v, dict) and "__node__" in v:
        nd = dict(v["__node__"])
        tname = nd.pop("type", None)
        registry = node_registry()
        if tname not in registry:
            raise ConfigError(
                f"nested node type {tname!r} is not in the port's registry (unknown, "
                "or not ported yet)", code=ErrorCode.CONFIG_VALIDATION_ERROR
            )
        return registry[tname](**{k: _decode_field(x) for k, x in nd.items()})
    if isinstance(v, list):
        return tuple(_decode_field(x) for x in v)
    return v


def graph_to_spec(g: Graph) -> GraphSpec:
    nodes = []
    for node in g.nodes:
        d = {"type": type(node).__name__}
        for f in dataclasses.fields(node):
            d[f.name] = _encode_field(getattr(node, f.name))
        nodes.append(d)
    return GraphSpec(nodes, g.input_rate, g.name)


def graph_from_spec(spec: GraphSpec | dict) -> Graph:
    if isinstance(spec, dict):
        spec = GraphSpec(**spec)
    registry = node_registry()
    nodes = []
    for nd in spec.nodes:
        nd = dict(nd)
        tname = nd.pop("type", None)
        if tname not in registry:
            raise ConfigError(
                f"node type {tname!r} is not in the port's registry (unknown, or not "
                f"ported yet); known: {sorted(registry)}",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        cls = registry[tname]
        try:
            nodes.append(cls(**{k: _decode_field(v) for k, v in nd.items()}))
        except TypeError as e:
            raise ConfigError(
                f"bad fields for node {tname}: {e}", code=ErrorCode.CONFIG_VALIDATION_ERROR
            ) from None
    return Graph(tuple(nodes), input_rate=spec.input_rate, name=spec.name)


def fork_to_spec(f) -> dict:
    """A :class:`~audioflow_torch.graph.Fork` as a JSON-ready dict:
    ``{"name", "trunk": GraphSpec dict, "branches": {name: GraphSpec dict}}``."""
    return {
        "name": f.name,
        "trunk": dataclasses.asdict(graph_to_spec(f.trunk)),
        "branches": {k: dataclasses.asdict(graph_to_spec(g)) for k, g in f.branches},
    }


def fork_from_spec(spec: dict):
    """The Fork of :func:`fork_to_spec`'s dict (the JAX package's too)."""
    from ..graph import Fork

    missing = {"trunk", "branches"} - set(spec)
    if missing:
        raise ConfigError(
            f"fork spec missing sections: {sorted(missing)}", code=ErrorCode.CONFIG_VALIDATION_ERROR
        )
    trunk = graph_from_spec(spec["trunk"])
    branches = tuple((k, graph_from_spec(v)) for k, v in spec["branches"].items())
    return Fork(trunk, branches, name=spec.get("name", "fork"))
