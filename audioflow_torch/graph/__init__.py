"""Flow-graph layer: nodes, offline chains and streaming."""

from .graph import Graph, chain
from .nodes import (
    Agc,
    BiquadChain,
    Cmvn,
    Compressor,
    Gain,
    GriffinLim,
    Istft,
    Limiter,
    LogMelSpec,
    Magnitude,
    MelProject,
    Mfcc,
    Node,
    NoiseGate,
    PeakNormalize,
    PhaseVocoderStretch,
    PitchShift,
    Power,
    Preemphasis,
    Pyin,
    Resample,
    RmsNormalize,
    Spectrogram,
    Stft,
    TimeStretch,
    ToMono,
    Yin,
    node_registry,
    register_node,
)

__all__ = [
    "Agc", "BiquadChain", "Cmvn", "Compressor", "Gain", "Graph", "GriffinLim", "Istft", "Limiter", "LogMelSpec",
    "Magnitude", "MelProject", "Mfcc", "Node", "NoiseGate", "PeakNormalize", "PhaseVocoderStretch",
    "PitchShift", "Power", "Preemphasis",
    "Pyin", "Resample", "RmsNormalize", "Spectrogram", "Stft", "TimeStretch", "ToMono", "Yin", "chain",
    "node_registry", "register_node",
]
