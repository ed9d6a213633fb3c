"""Flow-graph nodes: frozen dataclasses wrapping the port's ops.

Each node mirrors its namesake in ``audioflow_tpu/graph/nodes.py``, with two
execution modes:

* ``apply(x)`` — offline whole-array transform;
* ``init_carry(...)`` / ``step(carry, chunk)`` — streaming with O(1) carried
  state (resampler history, the spectrogram's hop-aligned overlap). Carries
  are tensors, converted to and from the JAX package's checkpoint pytree by
  :mod:`audioflow_torch.convert`.

Data domains: "samples" (PCM [..., T]), "frames" (spectral [..., T, F]),
"any". The graph validates domain adjacency at construction.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..errors import AudioError, ErrorCode
from ..ops.griffinlim import griffin_lim
from ..ops.kernels.melspec import mel_spectrogram
from ..ops.mel import apply_mel, cached_filterbank, log_mel
from ..ops.phase_vocoder import pitch_shift, time_stretch
from ..ops.pitch import pyin, yin_voicing
from ..ops.resample import (
    make_stream_plan,
    resample,
    resample_stream_init,
    resample_stream_step,
    stream_chunk_multiple,
)
from ..ops.stft import dft_banks, pad_center, padded_window, spectrogram
from ..utils.cache import on_device

_REGISTRY: dict[str, type] = {}


def register_node(cls):
    """Register a node class for config (de)serialization by name."""
    _REGISTRY[cls.__name__] = cls
    return cls


def node_registry() -> dict[str, type]:
    return dict(_REGISTRY)


@dataclass(frozen=True)
class Node:
    """Base node. Subclasses override the class attrs + methods they need."""

    domain_in = "samples"
    domain_out = "samples"
    streamable = True

    # --- rate/meta propagation -------------------------------------------
    def rate_out(self, rate_in: int | None) -> int | None:
        return rate_in

    def bind(self, rate_in: int | None) -> "Node":
        """Resolve rate-dependent defaults (sample_rate=None) at graph build."""
        if rate_in is not None and getattr(self, "sample_rate", "x") is None:
            return dataclasses.replace(self, sample_rate=rate_in)
        return self

    # --- offline ----------------------------------------------------------
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # --- streaming ---------------------------------------------------------
    def chunk_multiple(self) -> int:
        """Streaming chunks entering this node must be a multiple of this."""
        return 1

    def validate_chunk(self, n_in: int) -> None:
        m = self.chunk_multiple()
        if n_in % m:
            raise AudioError(
                f"{type(self).__name__}: chunk {n_in} not a multiple of {m}",
                code=ErrorCode.SHAPE_MISMATCH,
            )

    def out_len(self, n_in: int) -> int:
        return n_in

    def latency(self, n_in: int) -> int:
        """Streaming latency in *output* units for chunk size n_in."""
        return 0

    def init_carry(self, lead_shape: tuple, n_in: int, dtype=torch.float32, device=None):
        return None

    def step(self, carry, chunk):
        return carry, self.apply(chunk)


@register_node
@dataclass(frozen=True)
class Resample(Node):
    """Rational resampler (polyphase banded matmul)."""

    input_rate: int = 48000
    output_rate: int = 16000
    mode: str = "kaiser"

    def rate_out(self, rate_in):
        return self.output_rate

    def bind(self, rate_in):
        if rate_in is not None and rate_in != self.input_rate:
            raise AudioError(
                f"Resample node expects input rate {self.input_rate}, graph carries {rate_in}",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        return self

    @property
    def _identity(self) -> bool:
        return self.input_rate == self.output_rate

    def apply(self, x):
        return resample(x, self.input_rate, self.output_rate, self.mode)

    def _stream_plan(self, n_in):
        return make_stream_plan(self.input_rate, self.output_rate, self.mode, chunk_in=n_in)

    def chunk_multiple(self):
        if self._identity:
            return 1
        return stream_chunk_multiple(self.input_rate, self.output_rate)

    def out_len(self, n_in):
        return n_in if self._identity else self._stream_plan(n_in).n_out_chunk

    def latency(self, n_in):
        return 0 if self._identity else self._stream_plan(n_in).latency_out

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        if self._identity:
            return None
        return resample_stream_init(self._stream_plan(n_in), lead_shape, dtype, device)

    def step(self, carry, chunk):
        if self._identity:
            return carry, chunk
        return resample_stream_step(self._stream_plan(chunk.shape[-1]), carry, chunk)


@dataclass(frozen=True)
class _Framed(Node):
    """Streaming shared by the framing nodes: center=False frames of a
    hop-aligned overlap carry (``Spectrogram``/``LogMelSpec``/``Yin`` in the
    JAX package), so streamed frames are exactly the offline ones."""

    domain_out = "frames"

    def chunk_multiple(self):
        return self.hop

    @property
    def streamable(self):  # center-padding needs the whole signal
        return not self.center

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.center:
            raise AudioError(
                f"{type(self).__name__}: streaming requires center=False "
                "(center-padding needs the whole signal)",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def out_len(self, n_in):
        return n_in // self.hop

    @property
    def _frame_length(self) -> int:
        return self.n_fft

    @property
    def _carry_len(self) -> int:
        # hop-aligned history (>= frame - hop): 768 samples at n_fft 1024, hop 256
        return (-(-self._frame_length // self.hop) - 1) * self.hop

    def latency(self, n_in):
        return self._carry_len // self.hop

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return torch.zeros((*lead_shape, self._carry_len), dtype=dtype, device=device)

    def _frames(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, carry, chunk):
        buf = torch.cat([carry, chunk], dim=-1)
        out = self._frames(buf)
        return buf[..., buf.shape[-1] - self._carry_len :], out


@register_node
@dataclass(frozen=True)
class Spectrogram(_Framed):
    """Power/magnitude spectrogram: windowed real DFT as two fp32 matmuls."""

    n_fft: int = 1024
    hop: int = 256
    window: str = "hann"
    center: bool = True
    power: bool = True
    impl: str = "matmul"
    win_length: int | None = None
    precision: str | None = None  # accepted for parity; computes in fp32

    def _spec(self, x, center):
        return spectrogram(
            x, self.n_fft, self.hop, self.window, self.win_length,
            center=center, power=self.power, impl=self.impl,
            precision=self.precision,
        )

    def apply(self, x):
        return self._spec(x, self.center)

    def _frames(self, x):
        return self._spec(x, False)


@register_node
@dataclass(frozen=True)
class LogMelSpec(_Framed):
    """Fused log-mel spectrogram through the hand-written CUDA kernel
    (``ops.kernels.melspec``): the same function as Spectrogram + MelProject.
    Streaming semantics identical to Spectrogram (hop-aligned overlap carry)."""

    n_fft: int = 1024
    hop: int = 256
    n_mels: int = 128
    window: str = "hann"
    win_length: int | None = None
    center: bool = False
    f_min: float = 0.0
    f_max: float | None = None
    htk: bool = False
    norm: str | None = "slaney"
    log: str | None = "ln"
    floor: float = 1e-10
    sample_rate: int | None = None
    dft_precision: str | None = None  # accepted for parity; computes in fp32
    fb_precision: str = "highest"  # accepted for parity; computes in fp32

    def _fb(self):
        if self.sample_rate is None:
            raise AudioError("LogMelSpec.sample_rate unresolved; set input_rate on the graph")
        return cached_filterbank(
            self.n_fft // 2 + 1, self.n_mels, self.sample_rate,
            self.f_min, self.f_max, self.htk, self.norm,
        )

    def _frames(self, x):
        cosb, sinb = dft_banks(self.n_fft, self.window, self.win_length, x.device)
        w = on_device(padded_window(self.n_fft, self.window, self.win_length), x.device)
        fb = on_device(self._fb(), x.device)
        return mel_spectrogram(x.contiguous(), cosb, sinb, w, fb, self.hop, self.log, self.floor)

    def apply(self, x):
        return self._frames(pad_center(x, self.n_fft) if self.center else x)


@register_node
@dataclass(frozen=True)
class MelProject(Node):
    """power/magnitude frames -> (log-)mel features; one fp32 matmul."""

    n_mels: int = 128
    sample_rate: int | None = None
    f_min: float = 0.0
    f_max: float | None = None
    htk: bool = False
    norm: str | None = "slaney"
    log: str | None = "ln"  # None -> linear mel
    floor: float = 1e-10

    domain_in = "frames"
    domain_out = "frames"

    def _fb(self, n_freqs):
        if self.sample_rate is None:
            raise AudioError("MelProject.sample_rate unresolved; set input_rate on the graph")
        return cached_filterbank(
            n_freqs, self.n_mels, self.sample_rate, self.f_min, self.f_max, self.htk, self.norm
        )

    def apply(self, x):
        fb = on_device(self._fb(x.shape[-1]), x.device)
        if self.log is None:
            return apply_mel(x, fb)
        return log_mel(x, fb, self.floor, self.log)


@register_node
@dataclass(frozen=True)
class TimeStretch(Node):
    """Phase-vocoder time stretch (offline; changes duration). On the card
    it runs the fused CUDA kernel where ``time_stretch`` supports the rate."""

    rate: float = 1.0
    n_fft: int = 1024
    hop: int = 256
    streamable = False

    def apply(self, x):
        return time_stretch(x, self.rate, self.n_fft, self.hop)


@register_node
@dataclass(frozen=True)
class PitchShift(Node):
    """Pitch shift by ``semitones`` (offline): time stretch, then resample."""

    semitones: float = 0.0
    sample_rate: int | None = None
    n_fft: int = 1024
    hop: int = 256
    streamable = False

    def apply(self, x):
        return pitch_shift(x, self.semitones, self.sample_rate, self.n_fft, self.hop)


@register_node
@dataclass(frozen=True)
class GriffinLim(Node):
    """Magnitude frames -> waveform by fast Griffin-Lim (``ops.griffin_lim``).
    Whole-signal and iterative, so offline only. On the card ``impl="auto"``
    runs the fused CUDA kernel, one launch per iteration."""

    n_fft: int = 1024
    hop: int = 256
    window: str = "hann"
    n_iter: int = 32
    momentum: float = 0.99
    center: bool = True
    impl: str = "auto"
    streamable = False

    domain_in = "frames"
    domain_out = "samples"

    def apply(self, x):
        return griffin_lim(
            x, self.n_fft, self.hop, self.window, self.n_iter, self.momentum,
            center=self.center, impl=self.impl,
        )

    def out_len(self, n_in):
        return n_in * self.hop


@register_node
@dataclass(frozen=True)
class Yin(_Framed):
    """YIN pitch tracker: samples -> per-frame ``[f0_hz, aperiodicity]``
    ``[..., F, 2]`` (``ops.yin_voicing``). Streamable when center=False, with
    the framing nodes' hop-aligned overlap carry, so streamed == offline
    exactly."""

    fmin: float = 65.0
    fmax: float = 2093.0
    frame_length: int = 2048
    hop: int = 256
    threshold: float = 0.1
    center: bool = True
    sample_rate: int | None = None
    impl: str = "auto"
    precision: str | None = None

    @property
    def _frame_length(self) -> int:
        return self.frame_length

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Yin.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def _track(self, x, center):
        f0, ap = yin_voicing(
            x, self._rate(), self.fmin, self.fmax, self.frame_length, self.hop,
            self.threshold, center, self.impl, self.precision,
        )
        return torch.stack([f0, ap], dim=-1)

    def apply(self, x):
        return self._track(x, self.center)

    def _frames(self, x):
        return self._track(x, False)


@register_node
@dataclass(frozen=True)
class Pyin(Node):
    """pYIN probabilistic pitch tracker: samples -> per-frame ``[f0_hz,
    voiced_flag, voiced_prob]`` stacked ``[..., F, 3]`` (``ops.pyin``;
    voiced_flag is 0.0/1.0). The Viterbi decode spans the whole sequence, so
    the node is offline only. On the card its forward pass is the CUDA
    kernel, one launch per call."""

    fmin: float = 65.0
    fmax: float = 2093.0
    frame_length: int = 2048
    hop: int = 256
    center: bool = True
    resolution: float = 0.1
    switch_prob: float = 0.01
    sample_rate: int | None = None
    impl: str = "auto"
    precision: str | None = None
    streamable = False

    domain_out = "frames"

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Pyin.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def apply(self, x):
        f0, voiced, vprob = pyin(
            x, self._rate(), self.fmin, self.fmax, self.frame_length, self.hop, self.center,
            resolution=self.resolution, switch_prob=self.switch_prob, impl=self.impl,
            precision=self.precision,
        )
        return torch.stack([f0, voiced.to(f0.dtype), vprob], dim=-1)

    def out_len(self, n_in):
        if self.center:
            n_in = n_in + 2 * (self.frame_length // 2)
        return (n_in - self.frame_length) // self.hop + 1
