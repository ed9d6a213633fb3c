"""Flow-graph layer: nodes, offline chains and streaming."""

from .graph import Graph, chain
from .nodes import (
    GriffinLim,
    LogMelSpec,
    MelProject,
    Node,
    PitchShift,
    Pyin,
    Resample,
    Spectrogram,
    TimeStretch,
    Yin,
    node_registry,
    register_node,
)

__all__ = [
    "Graph", "GriffinLim", "LogMelSpec", "MelProject", "Node", "PitchShift", "Pyin", "Resample", "Spectrogram",
    "TimeStretch", "Yin", "chain", "node_registry", "register_node",
]
