"""Standard pipeline constructors."""

from .pipelines import (
    eq_bands_default,
    eq_chain_graph,
    kaldi_fbank_frontend,
    log_mel_frontend,
    master_chain_graph,
    stft_magnitude_graph,
    vad_graph,
    wire_egress_graph,
)

__all__ = [
    "eq_bands_default", "eq_chain_graph", "kaldi_fbank_frontend", "log_mel_frontend", "master_chain_graph",
    "stft_magnitude_graph", "vad_graph", "wire_egress_graph",
]
