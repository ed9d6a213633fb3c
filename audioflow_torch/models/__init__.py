"""Standard pipeline constructors and the trainable feature frontend."""

from .pipelines import (
    beat_graph,
    cqt_frontend,
    delta_fbank_frontend,
    denoise_master_chain,
    eq_bands_default,
    eq_chain_graph,
    kaldi_fbank_frontend,
    kws_frontend,
    log_mel_frontend,
    master_chain_graph,
    onset_frontend,
    stft_magnitude_graph,
    vad_graph,
    wire_egress_graph,
)
from .trainable import TrainableFrontend, make_train_step

__all__ = [
    "eq_bands_default", "eq_chain_graph", "kaldi_fbank_frontend", "log_mel_frontend", "master_chain_graph",
    "stft_magnitude_graph", "vad_graph", "wire_egress_graph", "delta_fbank_frontend", "denoise_master_chain",
    "kws_frontend", "beat_graph", "cqt_frontend", "onset_frontend", "TrainableFrontend", "make_train_step",
]
