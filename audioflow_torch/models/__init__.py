"""Standard pipeline constructors."""

from .pipelines import log_mel_frontend

__all__ = ["log_mel_frontend"]
