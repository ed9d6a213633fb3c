"""Standard pipeline constructors, mirroring ``audioflow_tpu/models/pipelines.py``.

Each returns a :class:`~audioflow_torch.graph.Graph`.
"""

from __future__ import annotations

from ..graph import Graph, LogMelSpec, MelProject, Resample, Spectrogram, chain


def stft_magnitude_graph(
    sample_rate: int = 16000, n_fft: int = 1024, hop: int = 256, center: bool = True
) -> Graph:
    """Benchmark config 1: mono PCM -> STFT magnitude spectrogram, the
    analysis half of the Griffin-Lim round trip
    ``chain(Spectrogram(power=False), GriffinLim(...))``."""
    return chain(
        Spectrogram(n_fft, hop, center=center, power=False),
        input_rate=sample_rate,
        name="stft_magnitude",
    )


def log_mel_frontend(
    input_rate: int = 44100,
    target_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 128,
    resample_mode: str = "kaiser",
    eq: tuple | None = None,
    center: bool = False,
    fused: bool = True,
) -> Graph:
    """The flagship frontend: polyphase resample -> STFT -> power -> 128-bin
    log-mel.

    ``fused=True`` (the default here) runs the STFT, power, mel and log as
    one :class:`~audioflow_torch.graph.LogMelSpec` node, that is, through the
    hand-written CUDA kernel. The JAX package defaults to ``False`` on the
    strength of a TPU measurement that does not carry over. ``fused=False``
    gives the Spectrogram + MelProject pair in plain torch; both forms
    compute the same function. ``eq`` (a BiquadChain) is not ported yet.
    """
    if eq:
        raise NotImplementedError("eq needs BiquadChain, which the port does not have yet")
    nodes: list = []
    if input_rate != target_rate:
        nodes.append(Resample(input_rate, target_rate, resample_mode))
    if fused:
        nodes.append(LogMelSpec(n_fft, hop, n_mels, center=center))
    else:
        nodes += [Spectrogram(n_fft, hop, center=center, power=True), MelProject(n_mels=n_mels)]
    return Graph(tuple(nodes), input_rate=input_rate, name="log_mel_frontend")
