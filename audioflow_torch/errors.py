"""Error types of the PyTorch port: the whole surface of
``audioflow_tpu.errors``, with the same names, code strings, recovery
strategies and recoverability.

An ``AudioFlowError`` umbrella over the subsystems' errors (DSP and device,
host I/O, sinks, config, sessions), each carrying a machine-readable
:class:`ErrorCode` and a suggested :class:`RecoveryStrategy`, plus the
exponential-backoff :class:`RetryPolicy` that :func:`with_retry` applies to
recoverable errors.

Standard library only, so that importing it loads neither JAX nor torch.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Callable, TypeVar


class ErrorCode(enum.Enum):
    """Stable, machine-readable error codes (same strings as the JAX package)."""

    # audio / DSP domain
    DEVICE_NOT_FOUND = "DEVICE_NOT_FOUND"
    DEVICE_UNAVAILABLE = "DEVICE_UNAVAILABLE"
    UNSUPPORTED_FORMAT = "UNSUPPORTED_FORMAT"
    RESAMPLING_FAILED = "RESAMPLING_FAILED"
    KERNEL_COMPILATION_FAILED = "KERNEL_COMPILATION_FAILED"
    SHAPE_MISMATCH = "SHAPE_MISMATCH"
    BUFFER_OVERFLOW = "BUFFER_OVERFLOW"
    # host I/O domain
    DECODE_FAILED = "DECODE_FAILED"
    FILE_NOT_FOUND = "FILE_NOT_FOUND"
    TRANSFER_FAILED = "TRANSFER_FAILED"
    CONNECTION_FAILED = "CONNECTION_FAILED"
    CONNECTION_TIMEOUT = "CONNECTION_TIMEOUT"
    AUTHENTICATION_FAILED = "AUTHENTICATION_FAILED"
    # sink / egress domain
    SINK_WRITE_FAILED = "SINK_WRITE_FAILED"
    ENCODING_FAILED = "ENCODING_FAILED"
    # config domain
    CONFIG_NOT_FOUND = "CONFIG_NOT_FOUND"
    CONFIG_PARSE_ERROR = "CONFIG_PARSE_ERROR"
    CONFIG_VALIDATION_ERROR = "CONFIG_VALIDATION_ERROR"
    SECRET_NOT_FOUND = "SECRET_NOT_FOUND"
    # session domain
    SESSION_CLOSED = "SESSION_CLOSED"
    SESSION_STATE_INVALID = "SESSION_STATE_INVALID"
    INTERNAL = "INTERNAL"


class RecoveryStrategy(enum.Enum):
    """What a caller should do about an error."""

    RETRY_IMMEDIATE = "retry_immediate"
    RETRY_WITH_BACKOFF = "retry_with_backoff"
    FALLBACK = "fallback"
    USER_ACTION = "user_action"
    FATAL = "fatal"


class AudioFlowError(Exception):
    """Umbrella error; every subclass carries an :class:`ErrorCode` and a
    suggested :class:`RecoveryStrategy`."""

    default_code = ErrorCode.INTERNAL
    default_strategy = RecoveryStrategy.FATAL

    def __init__(
        self,
        message: str,
        *,
        code: ErrorCode | None = None,
        strategy: RecoveryStrategy | None = None,
    ) -> None:
        super().__init__(message)
        self.message = message
        self.code = code or self.default_code
        self.strategy = strategy or self.default_strategy

    @property
    def is_recoverable(self) -> bool:
        """Only transient errors, those worth retrying, are recoverable."""
        return self.strategy in (
            RecoveryStrategy.RETRY_IMMEDIATE,
            RecoveryStrategy.RETRY_WITH_BACKOFF,
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.code.value}: {self.message!r})"


class AudioError(AudioFlowError):
    """DSP / kernel / device-compute errors."""

    default_code = ErrorCode.RESAMPLING_FAILED
    default_strategy = RecoveryStrategy.USER_ACTION


class IOError_(AudioFlowError):
    """Host I/O errors: decode, file access, host-to-device transfer
    (transient, retried with backoff)."""

    default_code = ErrorCode.DECODE_FAILED
    default_strategy = RecoveryStrategy.RETRY_WITH_BACKOFF


class SinkError(AudioFlowError):
    """Egress errors."""

    default_code = ErrorCode.SINK_WRITE_FAILED
    default_strategy = RecoveryStrategy.FALLBACK


class ConfigError(AudioFlowError):
    """Configuration errors."""

    default_code = ErrorCode.CONFIG_VALIDATION_ERROR
    default_strategy = RecoveryStrategy.USER_ACTION


class SessionError(AudioFlowError):
    """Streaming-session lifecycle errors."""

    default_code = ErrorCode.SESSION_STATE_INVALID
    default_strategy = RecoveryStrategy.USER_ACTION


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential-backoff retry policy for host-side I/O."""

    max_attempts: int = 5
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0

    def delay_for(self, attempt: int) -> float:
        return min(self.base_delay_s * self.multiplier**attempt, self.max_delay_s)


_T = TypeVar("_T")


def with_retry(
    fn: Callable[[], _T],
    policy: RetryPolicy = RetryPolicy(),
    *,
    sleep: Callable[[float], None] = time.sleep,
) -> _T:
    """Run ``fn``, retrying recoverable :class:`AudioFlowError` with backoff."""
    last: AudioFlowError | None = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except AudioFlowError as err:
            if not err.is_recoverable:
                raise
            last = err
            if err.strategy is RecoveryStrategy.RETRY_WITH_BACKOFF:
                sleep(policy.delay_for(attempt))
    assert last is not None
    raise last
