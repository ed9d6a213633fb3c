"""Error types of the PyTorch port: the subset of ``audioflow_tpu.errors``
that the ported graph raises, with the same names and code strings.

Standard library only, so that importing it loads neither JAX nor torch.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.Enum):
    """Stable, machine-readable error codes (same strings as the JAX package)."""

    DEVICE_NOT_FOUND = "DEVICE_NOT_FOUND"
    KERNEL_COMPILATION_FAILED = "KERNEL_COMPILATION_FAILED"
    RESAMPLING_FAILED = "RESAMPLING_FAILED"
    SHAPE_MISMATCH = "SHAPE_MISMATCH"
    CONFIG_VALIDATION_ERROR = "CONFIG_VALIDATION_ERROR"
    INTERNAL = "INTERNAL"


class AudioFlowError(Exception):
    """Umbrella error; every subclass carries an :class:`ErrorCode`."""

    default_code = ErrorCode.INTERNAL

    def __init__(self, message: str, *, code: ErrorCode | None = None) -> None:
        super().__init__(message)
        self.message = message
        self.code = code or self.default_code

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.code.value}: {self.message!r})"


class AudioError(AudioFlowError):
    """DSP / kernel / device-compute errors."""

    default_code = ErrorCode.RESAMPLING_FAILED


class ConfigError(AudioFlowError):
    """Configuration errors."""

    default_code = ErrorCode.CONFIG_VALIDATION_ERROR
