"""Standard pipeline constructors."""

from .pipelines import log_mel_frontend, stft_magnitude_graph

__all__ = ["log_mel_frontend", "stft_magnitude_graph"]
