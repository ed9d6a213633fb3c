"""Flow-graph layer: nodes, offline chains and streaming."""

from .graph import Graph, chain
from .nodes import (
    GriffinLim,
    LogMelSpec,
    MelProject,
    Node,
    PitchShift,
    Resample,
    Spectrogram,
    TimeStretch,
    node_registry,
    register_node,
)

__all__ = [
    "Graph", "GriffinLim", "LogMelSpec", "MelProject", "Node", "PitchShift", "Resample", "Spectrogram",
    "TimeStretch", "chain", "node_registry", "register_node",
]
