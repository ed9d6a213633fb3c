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
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import AudioError, ErrorCode
from ..ops import cqt_mod as cqt_ops
from ..ops import decompose, dynamics, effects, features, fir, loudness, rhythm
from ..ops import vad as _vad
from ..ops.biquad import Biquad, iir_apply, make_iir_plan
from ..ops.framing import frame, overlap_add
from ..ops.griffinlim import griffin_lim
from ..ops.kernels.melspec import mel_spectrogram
from ..ops.mel import apply_mel, cached_filterbank, log_mel, mfcc
from ..ops.phase_vocoder import (
    cumulative_phasor,
    increment_phasors,
    phase_vocoder,
    pitch_shift,
    time_stretch,
)
from ..ops.pitch import make_online_pyin_plan, online_pyin_init, online_pyin_step, pyin, pyin_online, yin_voicing
from ..ops.quantize import quantize_i16, quantize_i16_round
from ..ops.resample import (
    make_stream_plan,
    resample,
    resample_stream_init,
    resample_stream_step,
    stream_chunk_multiple,
)
from ..ops.stft import (
    dft_banks,
    frames_from_spec,
    istft,
    magnitude,
    pad_center,
    padded_window,
    power,
    spectrogram,
    stft,
)
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

    trace_name = "node.Node"  # the span of its step in Graph.stream_step (obs.trace)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls.trace_name = f"node.{cls.__name__}"

    domain_in = "samples"
    domain_out = "samples"
    streamable = True
    # When True, Graph.stream_step passes step(carry, chunk, first_index=i)
    # where i is the chunk-relative index of the stream's first real (offline
    # position 0) sample: negative once passed, >= chunk length before it
    # arrives. For nodes whose edge convention is position-dependent and so
    # not a zero-input fixpoint (Preemphasis' Kaldi y[0] = x[0] - k*x[0]).
    wants_first_index = False
    # When True, Graph.stream_step does NOT zero this node's upstream-warmup
    # input region (Graph._warmups). False is right for recursive and
    # accumulating nodes (biquad, limiter): offline they start from zero
    # state at sample 0, so the preroll must look like zeros. Istft opts out:
    # its WOLA bookkeeping counts every incoming frame and is exact for any
    # prefix, but wrong for zeroed frames.
    warmup_passthrough = False

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
class ToMono(Node):
    """Interleaved multi-channel -> mono mean."""

    channels: int = 2

    def apply(self, x):
        return dynamics.to_mono(x, self.channels)

    def chunk_multiple(self):
        return self.channels

    def out_len(self, n_in):
        return n_in // self.channels


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


@register_node
@dataclass(frozen=True)
class BiquadChain(Node):
    """Cascade of biquads (BASELINE config 3's EQ chain); the carry is the
    cascade's state ``[..., order]``."""

    biquads: tuple[Biquad, ...] = ()
    block: int = 128

    def __post_init__(self):
        if not self.biquads:
            raise AudioError("empty biquad chain", code=ErrorCode.CONFIG_VALIDATION_ERROR)

    @property
    def _plan(self):
        return make_iir_plan(tuple(self.biquads), self.block)

    def apply(self, x):
        y, _ = iir_apply(x, self._plan)
        return y

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return torch.zeros((*lead_shape, self._plan.order), dtype=dtype, device=device)

    def step(self, carry, chunk):
        y, s = iir_apply(chunk, self._plan, zi=carry)
        return s, y


@register_node
@dataclass(frozen=True)
class Gain(Node):
    db: float = 0.0

    def apply(self, x):
        return dynamics.gain_db(x, self.db)


@register_node
@dataclass(frozen=True)
class PeakNormalize(Node):
    """Whole-signal op: offline only."""

    target_peak: float = 1.0
    streamable = False

    def apply(self, x):
        return dynamics.peak_normalize(x, self.target_peak)


@register_node
@dataclass(frozen=True)
class RmsNormalize(Node):
    target_db: float = -20.0
    streamable = False

    def apply(self, x):
        return dynamics.rms_normalize(x, self.target_db)


@dataclass(frozen=True)
class _Envelope(Node):
    """Streaming shared by the peak-envelope nodes (``Limiter``,
    ``Compressor``, ``NoiseGate``): the envelope's last value is the carry,
    decayed into the next chunk as ``carry * r ** (1..t)``, so streamed
    equals offline."""

    def _coeff(self) -> float:
        if self.sample_rate is None:
            raise AudioError(f"{type(self).__name__}.sample_rate unresolved; set input_rate on the graph")
        return float(np.exp(-1.0 / (self.release_ms * 1e-3 * self.sample_rate)))

    def _gain(self, env: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, x):
        return x * self._gain(dynamics.envelope_peak_release(x.abs(), self._coeff()))

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return torch.zeros(lead_shape, dtype=dtype, device=device)

    def step(self, carry, chunk):
        r = self._coeff()
        env = dynamics.envelope_peak_release(chunk.abs(), r)
        t = chunk.shape[-1]
        decay = carry[..., None] * torch.pow(r, torch.arange(1, t + 1, dtype=chunk.dtype, device=chunk.device))
        env = torch.maximum(env, decay)
        return env[..., -1], chunk * self._gain(env)


@register_node
@dataclass(frozen=True)
class Limiter(_Envelope):
    """Peak limiter; envelope carry makes streaming exact."""

    threshold_db: float = -1.0
    release_ms: float = 50.0
    sample_rate: int | None = None

    def _gain(self, env):
        return dynamics.limiter_gain(env, self.threshold_db)


@register_node
@dataclass(frozen=True)
class Compressor(_Envelope):
    """Downward compressor (threshold/ratio/knee); envelope carry makes
    streaming exact, same machinery as :class:`Limiter`."""

    threshold_db: float = -20.0
    ratio: float = 4.0
    release_ms: float = 100.0
    knee_db: float = 0.0
    sample_rate: int | None = None

    def _gain(self, env):
        return dynamics.compressor_gain(env, self.threshold_db, self.ratio, self.knee_db)


@register_node
@dataclass(frozen=True)
class NoiseGate(_Envelope):
    """Hard downward gate below ``threshold_db`` (attenuates by ``floor_db``);
    same exact-streaming envelope carry as :class:`Limiter`."""

    threshold_db: float = -60.0
    release_ms: float = 100.0
    floor_db: float = -80.0
    sample_rate: int | None = None

    def _gain(self, env):
        return dynamics.gate_gain(env, self.threshold_db, self.floor_db)


@register_node
@dataclass(frozen=True)
class Agc(Node):
    """Automatic gain control (slow leveler, ``ops.dynamics.agc``). The
    gain-dB carry makes streamed == offline exactly when chunks are block
    multiples (``chunk_multiple`` enforces it)."""

    target_db: float = -20.0
    block: int = 1024
    max_gain_db: float = 30.0
    up_db_per_s: float = 6.0
    down_db_per_s: float = 60.0
    floor_db: float = -55.0
    sample_rate: int | None = None

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Agc.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def _agc(self, x, gain0=None):
        return dynamics.agc(
            x, self.target_db, self.block, self.max_gain_db,
            self.up_db_per_s, self.down_db_per_s, self._rate(), self.floor_db, gain0=gain0,
        )

    def apply(self, x):
        return self._agc(x)[0]

    def chunk_multiple(self):
        return self.block

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return torch.zeros(lead_shape, dtype=dtype, device=device)

    def step(self, carry, chunk):
        y, g = self._agc(chunk, carry)
        return g, y


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
class Stft(_Framed):
    """samples -> complex frames ``[..., F, n_fft//2+1]`` (``ops.stft``, its
    default ``impl="fft"``). Streaming keeps the framing nodes' hop-aligned
    overlap carry: the stream equals the offline center=False STFT of the
    zero-prehistory signal, with cdiv(n_fft, hop) - 1 frames of latency."""

    n_fft: int = 1024
    hop: int = 256
    window: str = "hann"
    center: bool = True

    def apply(self, x):
        return stft(x, self.n_fft, self.hop, window=self.window, center=self.center)

    def _frames(self, x):
        return stft(x, self.n_fft, self.hop, window=self.window, center=False)


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
class Magnitude(Node):
    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return magnitude(x)


@register_node
@dataclass(frozen=True)
class Power(Node):
    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return power(x)


@register_node
@dataclass(frozen=True)
class Mfcc(Node):
    n_mfcc: int = 13
    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return mfcc(x, self.n_mfcc)


def _resolve_vad_level(node) -> None:
    """Resolve a named VAD sensitivity preset into ``threshold_db`` (a
    frozen dataclass, so by ``object.__setattr__``). Unknown names raise."""
    if not node.level:
        return
    levels = _vad.VAD_LEVELS
    if node.level not in levels:
        raise AudioError(
            f"unknown VAD level {node.level!r}; known: {sorted(levels)}",
            code=ErrorCode.CONFIG_VALIDATION_ERROR,
        )
    object.__setattr__(node, "threshold_db", levels[node.level].threshold_db)


def _vad_frames(x: torch.Tensor, frame_len: int) -> torch.Tensor:
    n = x.shape[-1] // frame_len
    return x[..., : n * frame_len].reshape(*x.shape[:-1], n, frame_len)


@register_node
@dataclass(frozen=True)
class Vad(Node):
    """Energy VAD over fixed frames; emits int32 states (0/1/2) per frame.

    ``level`` names a sensitivity preset ("aggressive", "balanced",
    "relaxed"; :data:`audioflow_torch.ops.vad.VAD_LEVELS`) that overrides
    ``threshold_db``; the empty string keeps ``threshold_db``. The carry is
    the :class:`~audioflow_torch.ops.vad.VadCarry` of the stream.
    """

    frame_len: int = 320  # 20 ms at 16 kHz, the reference capture cadence
    threshold_db: float = -50.0
    smoothing_factor: float = 0.3
    silence_timeout_frames: int = 15
    min_speech_frames: int = 3
    level: str = ""

    domain_out = "frames"

    def __post_init__(self):
        _resolve_vad_level(self)

    def _cfg(self):
        return _vad.VadConfig(
            self.threshold_db, self.smoothing_factor, self.silence_timeout_frames, self.min_speech_frames
        )

    def apply(self, x):
        return _vad.vad_scan(_vad_frames(x, self.frame_len), self._cfg())[1]

    def chunk_multiple(self):
        return self.frame_len

    def out_len(self, n_in):
        return n_in // self.frame_len

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return _vad.vad_init(lead_shape, dtype, device)

    def step(self, carry, chunk):
        return _vad.vad_scan(_vad_frames(chunk, self.frame_len), self._cfg(), carry)


@register_node
@dataclass(frozen=True)
class QuantizeI16(Node):
    """Wire-parity f32 -> i16."""

    rounding: str = "trunc"  # "trunc" (reference parity) or "round"
    domain_in = "any"
    domain_out = "any"

    def apply(self, x):
        if self.rounding == "trunc":
            return quantize_i16(x)
        return quantize_i16_round(x)


@register_node
@dataclass(frozen=True)
class VadGate(Node):
    """Mute non-speech audio: only speech goes to the ASR service. Frames
    whose VAD state is Speech (or Ending, with ``keep_ending``) pass;
    silence is zeroed. Emits samples, where :class:`Vad` emits states."""

    frame_len: int = 320
    threshold_db: float = -50.0
    smoothing_factor: float = 0.3
    silence_timeout_frames: int = 15
    min_speech_frames: int = 3
    keep_ending: bool = True
    level: str = ""  # named preset, as Vad.level

    def __post_init__(self):
        _resolve_vad_level(self)

    def _cfg(self):
        return _vad.VadConfig(
            self.threshold_db, self.smoothing_factor, self.silence_timeout_frames, self.min_speech_frames
        )

    def chunk_multiple(self):
        return self.frame_len

    def _gate(self, x, states):
        keep = states == _vad.SPEECH
        if self.keep_ending:
            keep = keep | (states == _vad.ENDING)
        n = states.shape[-1]
        frames = x[..., : n * self.frame_len].reshape(*x.shape[:-1], n, self.frame_len)
        gated = frames * keep[..., None].to(x.dtype)
        return gated.reshape(*x.shape[:-1], n * self.frame_len)

    def apply(self, x):
        _, states = _vad.vad_scan(_vad_frames(x, self.frame_len), self._cfg())
        return self._gate(x, states)

    def out_len(self, n_in):
        return n_in // self.frame_len * self.frame_len

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return _vad.vad_init(lead_shape, dtype, device)

    def step(self, carry, chunk):
        carry, states = _vad.vad_scan(_vad_frames(chunk, self.frame_len), self._cfg(), carry)
        return carry, self._gate(chunk, states)


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
class PhaseVocoderStretch(Node):
    """Streaming phase-vocoder time stretch: complex frames -> complex frames.

    ``rate = rate_num/rate_den`` (> 1 speeds up). Streaming carries the
    previous analysis frames (for fractional interpolation across chunk
    boundaries) and the accumulated synthesis phasor, so chunk outputs are
    phase-continuous. Unlike the other nodes, the streamed output is NOT
    bit-equal to the offline :func:`ops.phase_vocoder` — phase accumulation
    starts from the zero-prehistory preroll rather than the first real frame
    (a constant per-bin phase rotation; magnitudes match and resynthesis is
    click-free), as in the JAX package. Compose as Stft(center=False) ->
    PhaseVocoderStretch -> Istft(center=False) for streaming tempo change.
    """

    rate_num: int = 5
    rate_den: int = 4
    hop: int = 256
    n_fft: int = 1024

    domain_in = "frames"
    domain_out = "frames"
    # phase accumulation is seeded from the incoming stream's first frames;
    # zeroed warmup frames would re-seed it from a degenerate zero-magnitude
    # frame instead of the preroll
    warmup_passthrough = True

    def __post_init__(self):
        if self.rate_num <= 0 or self.rate_den <= 0:
            raise AudioError("rate must be positive", code=ErrorCode.CONFIG_VALIDATION_ERROR)
        g = math.gcd(self.rate_num, self.rate_den)
        object.__setattr__(self, "rate_num", self.rate_num // g)
        object.__setattr__(self, "rate_den", self.rate_den // g)

    def apply(self, x):
        return phase_vocoder(x, self.rate_num / self.rate_den, self.hop, self.n_fft)

    # --- streaming geometry: m input frames -> m*den/num output frames
    def chunk_multiple(self):
        return self.rate_num

    def out_len(self, n_in):
        return n_in * self.rate_den // self.rate_num

    def latency(self, n_in):
        # one-frame interpolation lookahead, expressed in output frames
        return -(-self.rate_den // self.rate_num)

    @property
    def _history(self) -> int:
        """Carried analysis frames: enough that delayed outputs never read
        before the buffer start (s_rel >= 0 for the first output)."""
        p, q = self.rate_num, self.rate_den
        n0 = -(-q // p)
        return max(1, -(-(n0 * p) // q))

    def _plan(self, m):
        """Static gather plan: buffer = [h history frames] + m new frames;
        output u (local) is global j = k*mo + u - n0, analyzing
        s_rel = (u - n0)*p/q + h relative to the buffer start."""
        p, q = self.rate_num, self.rate_den
        mo = m * q // p
        n0 = -(-q // p)
        h = self._history
        u = np.arange(mo)
        s_rel = (u - n0) * p / q + h
        lo = np.floor(s_rel).astype(np.int64)
        frac = (s_rel - lo).astype(np.float32)
        if lo.min() < 0 or lo.max() + 1 > m + h - 1:
            # an out-of-range gather would smear time; fail loudly instead
            raise AudioError(
                f"phase-vocoder plan out of bounds: lo in [{lo.min()}, {lo.max()}], "
                f"buffer m+h = {m + h}",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        return mo, lo, lo + 1, frac

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        n_bins = self.n_fft // 2 + 1
        return (
            torch.zeros((*lead_shape, self._history, n_bins), dtype=torch.complex64, device=device),
            # accumulated phase phasor
            torch.ones((*lead_shape, n_bins), dtype=torch.complex64, device=device),
        )

    def step(self, carry, spec):
        # the offline vocoder's phasor math: exp(i*increment) ==
        # s_hi*conj(s_lo)/(|s_hi||s_lo|), accumulated as a cumulative complex
        # product — no trig on the hot path
        prev, acc = carry
        mo, lo, hi, frac = self._plan(spec.shape[-2])
        buf = torch.cat([prev, spec], dim=-2)  # [.., h+m, bins]
        mag_in = buf.abs()
        lo_t = torch.from_numpy(lo).to(buf.device)
        hi_t = torch.from_numpy(hi).to(buf.device)
        s_lo, s_hi = buf[..., lo_t, :], buf[..., hi_t, :]
        m_lo, m_hi = mag_in[..., lo_t, :], mag_in[..., hi_t, :]
        fr = torch.from_numpy(frac).to(buf.device)[:, None]
        mag = (1.0 - fr) * m_lo + fr * m_hi
        u = increment_phasors(s_lo, s_hi, m_lo, m_hi)  # [.., mo, bins]
        z = acc[..., None, :] * cumulative_phasor(u, axis=-2)
        out = mag * z
        # renormalize the carried phasor so |acc| cannot drift over
        # arbitrarily long streams (each chunk multiplies ~mo unit values)
        last = z[..., -1, :]
        last_mag = last.abs()
        ok = last_mag > 0
        last = torch.where(ok, last / torch.where(ok, last_mag, 1.0), torch.ones_like(last))
        return (buf[..., -self._history :, :], last), out


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


@register_node
@dataclass(frozen=True)
class Preemphasis(Node):
    """ASR-standard first-order high-pass (y[n] = x[n] - k*x[n-1]).

    Streaming carries the previous chunk's last sample, so streamed ==
    offline. The Kaldi edge convention (y[0] = x[0] - k*x[0]: the first
    sample is its own predecessor) depends on position, so unlike every
    zero-prehistory recurrence it is NOT a fixpoint of zero input:
    downstream of a latency-bearing node, the graph's warmup zeroing alone
    would make the first real sample read prev=0. The node therefore opts
    into ``wants_first_index``, and the graph passes the offline position of
    sample 0 (``Graph._warmups``), so the edge convention lands on the right
    sample whatever the upstream latency.
    """

    coeff: float = 0.97
    wants_first_index = True

    def apply(self, x):
        return dynamics.preemphasis(x, self.coeff)

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        # (previous sample, started flag); the flag serves direct step()
        # callers: inside a Graph, first_index supersedes it
        return (
            torch.zeros((*lead_shape, 1), dtype=dtype, device=device),
            torch.zeros((*lead_shape, 1), dtype=torch.bool, device=device),
        )

    def step(self, carry, chunk, first_index=None):
        prev_sample, started = carry
        if first_index is None:
            prev0 = torch.where(started, prev_sample, chunk[..., :1])
            prev = torch.cat([prev0, chunk[..., :-1]], dim=-1)
        else:
            prev = torch.cat([prev_sample, chunk[..., :-1]], dim=-1)
            if 0 <= first_index < chunk.shape[-1]:
                prev = prev.clone()
                prev[..., first_index] = chunk[..., first_index]
        new_carry = (chunk[..., -1:], torch.ones_like(started))
        return new_carry, chunk - self.coeff * prev


@register_node
@dataclass(frozen=True)
class Cmvn(Node):
    """Per-utterance cepstral mean/variance normalization (offline only)."""

    norm_var: bool = False
    streamable = False
    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return dynamics.cmvn(x, self.norm_var)


@register_node
@dataclass(frozen=True)
class Istft(Node):
    """Inverse STFT (WOLA): complex frames -> samples.

    Streaming (requires center=False): a frame only contributes to samples at
    or after its start, so emitting hop samples per frame is causally
    complete with ZERO latency; the carry holds the pending overlap-add tail
    plus the matching window-square tail, making the emitted stream exactly
    the offline ISTFT prefix (the final n_fft - hop tail stays unflushed).
    """

    n_fft: int = 1024
    hop: int = 256
    window: str = "hann"
    center: bool = True
    impl: str = "matmul"
    domain_in = "frames"
    domain_out = "samples"
    # the WOLA identity reconstruction is exact for ANY incoming frame
    # stream; the wsum carry counts every frame, so zeroed warmup frames
    # would corrupt the normalisation: consume the upstream preroll instead
    warmup_passthrough = True

    @property
    def streamable(self):  # center-padding needs the whole signal
        return not self.center

    def apply(self, x):
        return istft(x, self.n_fft, self.hop, window=self.window, center=self.center, impl=self.impl)

    # streaming: the chunk unit is FRAMES in, hop*frames samples out
    def validate_chunk(self, n_in):
        if self.center:
            raise AudioError(
                "Istft: streaming requires center=False",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def out_len(self, n_in):
        return n_in * self.hop

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        tail = self.n_fft - self.hop
        return (
            torch.zeros((*lead_shape, tail), dtype=torch.float32, device=device),
            torch.zeros((tail,), dtype=torch.float32, device=device),
        )

    def step(self, carry, spec):
        ola_tail, wsum_tail = carry
        w = on_device(padded_window(self.n_fft, self.window), spec.device)
        m = spec.shape[-2]
        frames = frames_from_spec(spec, self.n_fft, self.impl)
        y = overlap_add(frames * w, self.hop)
        ws = overlap_add((w * w).expand(m, self.n_fft), self.hop)
        tail = self.n_fft - self.hop
        y = torch.cat([y[..., :tail] + ola_tail, y[..., tail:]], dim=-1)
        ws = torch.cat([ws[:tail] + wsum_tail, ws[tail:]])
        emit = y[..., : m * self.hop] / torch.clamp_min(ws[: m * self.hop], 1e-11)
        return (y[..., m * self.hop :], ws[m * self.hop :]), emit


_MIX_COMBINES = ("sum", "mean", "product", "max", "min")


@register_node
@dataclass(frozen=True)
class Mix(Node):
    """Multi-branch combine: each branch sub-chain runs on the same input and
    the outputs merge elementwise (dry/wet, multiband, a level meter beside
    a gate).

    ``branches`` is a tuple of node tuples; all end in one domain with the
    same output length and rate. ``weights`` scales each branch before the
    combine; None leaves them unweighted.

    Streaming: each branch keeps its own graph state; branches with less
    latency are delayed (zero-filled pending buffers) to the slowest, so the
    streamed mix equals the offline mix shifted by one whole-unit latency.
    """

    branches: tuple = ()
    combine: str = "sum"
    weights: tuple | None = None

    domain_in = "samples"
    domain_out = "samples"

    def __post_init__(self):
        if len(self.branches) < 2:
            raise AudioError("Mix needs at least 2 branches", code=ErrorCode.CONFIG_VALIDATION_ERROR)
        if self.combine not in _MIX_COMBINES:
            raise AudioError(
                f"unknown combine {self.combine!r}; known: {_MIX_COMBINES}",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        if self.weights is not None and len(self.weights) != len(self.branches):
            raise AudioError(
                f"weights ({len(self.weights)}) != branches ({len(self.branches)})",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        object.__setattr__(self, "branches", tuple(tuple(b) for b in self.branches))

    # --- graph construction -----------------------------------------------
    def _graphs(self):
        gs = getattr(self, "_bound_graphs", None)
        return self._build(None) if gs is None else gs

    def _build(self, rate):
        from .graph import Graph

        gs = tuple(Graph(b, input_rate=rate, name=f"mix_branch_{i}") for i, b in enumerate(self.branches))
        d0 = gs[0].nodes[-1].domain_out
        for g in gs[1:]:
            if g.nodes[-1].domain_out != d0:
                raise AudioError(
                    f"Mix branches end in different domains: {[g.nodes[-1].domain_out for g in gs]}",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            if g.output_rate != gs[0].output_rate:
                raise AudioError(
                    f"Mix branches end at different rates: {[g.output_rate for g in gs]}",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
        m = self.chunk_multiple_of(gs)
        lens = {g.chunk_lens(m)[-1] for g in gs}
        if len(lens) != 1:
            raise AudioError(
                f"Mix branches disagree on output length for chunk {m}: {lens}",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        object.__setattr__(self, "_bound_graphs", gs)
        object.__setattr__(self, "domain_out", d0)
        return gs

    def bind(self, rate_in):
        new = dataclasses.replace(self)
        new._build(rate_in)
        return new

    def rate_out(self, rate_in):
        return self._graphs()[0].output_rate

    @property
    def streamable(self):
        return all(g.streamable for g in self._graphs())

    # --- offline ------------------------------------------------------------
    def _merge(self, outs):
        if self.weights is not None:
            outs = [w * o for w, o in zip(self.weights, outs)]
        y = outs[0]
        if self.combine in ("sum", "mean"):
            for o in outs[1:]:
                y = y + o
            return y / len(outs) if self.combine == "mean" else y
        if self.combine == "product":
            for o in outs[1:]:
                y = y * o
            return y
        fn = torch.maximum if self.combine == "max" else torch.minimum
        for o in outs[1:]:
            y = fn(y, o)
        return y

    def apply(self, x):
        return self._merge([g.chain(x) for g in self._graphs()])

    # --- streaming ----------------------------------------------------------
    @staticmethod
    def chunk_multiple_of(gs):
        m = 1
        for g in gs:
            m = math.lcm(m, g.chunk_granularity())
        return m

    def chunk_multiple(self):
        return self.chunk_multiple_of(self._graphs())

    def out_len(self, n_in):
        return self._graphs()[0].chunk_lens(n_in)[-1]

    def latency(self, n_in):
        return max(g.stream_latency(n_in) for g in self._graphs())

    def _stream_axis(self):
        return -2 if self.domain_out == "frames" else -1

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        lat = self.latency(n_in)
        states, pads = [], []
        for g in self._graphs():
            states.append(g.init_state(n_in, lead_shape, dtype, device))
            need = lat - g.stream_latency(n_in)
            if need == 0:
                pads.append(None)
                continue
            spec = g.stream_step(
                g.init_state(n_in, lead_shape, dtype, "meta"),
                torch.empty((*lead_shape, n_in), dtype=dtype, device="meta"),
            )[1]
            shape = list(spec.shape)
            shape[self._stream_axis() % len(shape)] = need
            pads.append(torch.zeros(shape, dtype=spec.dtype, device=device))
        return tuple(states), tuple(pads)

    def step(self, carry, chunk):
        states, pads = carry
        new_states, new_pads, outs = [], [], []
        for g, st, pend in zip(self._graphs(), states, pads):
            st, y = g.stream_step(st, chunk)
            if pend is not None:
                axis = self._stream_axis() % y.ndim
                n_out = y.shape[axis]
                buf = torch.cat([pend, y], dim=axis)
                y = buf.narrow(axis, 0, n_out)
                pend = buf.narrow(axis, n_out, buf.shape[axis] - n_out)
            new_states.append(st)
            new_pads.append(pend)
            outs.append(y)
        return (tuple(new_states), tuple(new_pads)), self._merge(outs)


# --- mastering, effects and feature families ---------------------------------


@register_node
@dataclass(frozen=True)
class Fir(Node):
    """Causal FIR filter (``ops/fir.py``): designed windowed-sinc
    (kind/num_taps/cutoff) or explicit ``taps``. The prehistory carry makes
    streaming exact with zero latency; long kernels go through FFT fast
    convolution."""

    kind: str = "lowpass"
    num_taps: int = 101
    cutoff: tuple = (4000.0,)
    window: str = "hamming"
    taps: tuple | None = None  # explicit taps override the design
    sample_rate: int | None = None

    def _h(self, device) -> torch.Tensor:
        if self.taps is not None:
            return torch.tensor(self.taps, dtype=torch.float32, device=device)
        if self.sample_rate is None:
            raise AudioError("Fir.sample_rate unresolved; set input_rate on the graph")
        cut = self.cutoff if len(self.cutoff) > 1 else self.cutoff[0]
        return on_device(fir.cached_design(self.num_taps, cut, self.sample_rate, self.kind, self.window), device)

    def apply(self, x):
        return fir.fir_apply(x, self._h(x.device))[0]

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        k = len(self.taps) if self.taps is not None else self.num_taps
        return torch.zeros((*lead_shape, k - 1), dtype=dtype, device=device)

    def step(self, carry, chunk):
        y, zf = fir.fir_apply(chunk, self._h(chunk.device), zi=carry)
        return zf, y


@register_node
@dataclass(frozen=True)
class LoudnessNormalize(Node):
    """EBU R128 loudness normalization: a pure gain to ``target_lufs``
    integrated loudness (the BS.1770-4 gated meter), optionally capped at a
    true-peak ceiling. Per-utterance two-pass: offline only, like
    :class:`Cmvn`."""

    target_lufs: float = -23.0
    max_true_peak_db: float | None = -1.0
    sample_rate: int | None = None
    streamable = False

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError("LoudnessNormalize.sample_rate unresolved; set input_rate on the graph")
        return loudness.normalize_loudness(x, self.sample_rate, self.target_lufs, self.max_true_peak_db)


@register_node
@dataclass(frozen=True)
class Hpss(Node):
    """Harmonic/percussive separation (``ops/decompose.py``); emits the
    chosen component. The median filters span the whole time axis: offline
    only."""

    component: str = "harmonic"  # or "percussive"
    n_fft: int = 1024
    hop: int = 256
    kernel_time: int = 17
    kernel_freq: int = 17
    margin: float = 1.0
    streamable = False

    def __post_init__(self):
        if self.component not in ("harmonic", "percussive"):
            raise AudioError(
                f"Hpss.component must be 'harmonic' or 'percussive', got {self.component!r}",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def apply(self, x):
        y_h, y_p = decompose.hpss(
            x, self.n_fft, self.hop, kernel_time=self.kernel_time, kernel_freq=self.kernel_freq, margin=self.margin
        )
        return y_h if self.component == "harmonic" else y_p


@register_node
@dataclass(frozen=True)
class SpectralGate(Node):
    """Stationary-noise spectral gating denoiser (``ops/decompose.py``). The
    noise profile comes from the signal's own quietest frames, a
    whole-signal statistic: offline only."""

    n_fft: int = 1024
    hop: int = 256
    n_std: float = 1.5
    prop_decrease: float = 1.0
    quantile: float = 0.1
    streamable = False

    def apply(self, x):
        return decompose.spectral_gate(
            x, self.n_fft, self.hop, n_std=self.n_std, prop_decrease=self.prop_decrease, quantile=self.quantile
        )


def _n_fft(frames: torch.Tensor) -> int:
    return 2 * (frames.shape[-1] - 1)


@register_node
@dataclass(frozen=True)
class SpectralFeatures(Node):
    """Magnitude frames -> stacked spectral descriptors
    ``[..., F, len(features)]`` (``ops/features.py``). Feed from
    ``Spectrogram(power=False)``. Stateless per frame except "flux", which
    compares with the previous frame: streaming it needs ``n_bins`` (to
    size the previous-frame carry), and ``wants_first_index`` makes the
    stream's offline frame 0 flux against itself, as offline."""

    features: tuple = ("centroid", "bandwidth", "rolloff", "flatness")
    sample_rate: int | None = None
    n_bins: int | None = None

    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    @property
    def streamable(self):
        return "flux" not in self.features or self.n_bins is not None

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("SpectralFeatures.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def apply(self, x):
        return features.spectral_features(x, self._rate(), _n_fft(x), tuple(self.features))

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if "flux" in self.features and self.n_bins is None:
            raise AudioError(
                "SpectralFeatures: streaming 'flux' needs n_bins (the spectrogram bin count) to size the "
                "prev-frame carry",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        if "flux" not in self.features:
            return None
        return torch.zeros((*lead_shape, 1, self.n_bins), dtype=dtype, device=device)

    def step(self, carry, chunk, first_index=None):
        if carry is None:  # no flux: stateless per frame
            return None, self.apply(chunk)
        cols = []
        for name in self.features:
            if name == "flux":
                f = features.spectral_flux(chunk, prev=carry)
                if first_index is not None and 0 <= first_index < chunk.shape[-2]:
                    f = f.clone()
                    f[..., first_index] = 0.0
                cols.append(f)
            else:
                cols.append(features.spectral_features(chunk, self._rate(), _n_fft(chunk), (name,))[..., 0])
        return chunk[..., -1:, :], torch.stack(cols, dim=-1)


@register_node
@dataclass(frozen=True)
class Chroma(Node):
    """Power frames -> chromagram ``[..., F, n_chroma]`` (pitch classes,
    ``ops/features.py::chroma``, C = index 0). Stateless per frame (the
    ``norm`` max is within the frame). Feed from
    ``Spectrogram(power=True)``."""

    n_chroma: int = 12
    norm: bool = True
    tuning: float = 0.0
    sample_rate: int | None = None

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError("Chroma.sample_rate unresolved; set input_rate on the graph")
        return features.chroma(x, self.sample_rate, _n_fft(x), self.n_chroma, self.norm, self.tuning)


@register_node
@dataclass(frozen=True)
class SpectralContrast(Node):
    """Magnitude frames -> octave-band spectral contrast
    ``[..., F, n_bands + 1]`` in dB (``ops/features.py``). Stateless per
    frame. Feed from ``Spectrogram(power=False)``."""

    n_bands: int = 6
    fmin: float = 200.0
    quantile: float = 0.02
    sample_rate: int | None = None

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError("SpectralContrast.sample_rate unresolved; set input_rate on the graph")
        return features.spectral_contrast(x, self.sample_rate, _n_fft(x), self.n_bands, self.fmin, self.quantile)


@register_node
@dataclass(frozen=True)
class Tonnetz(Node):
    """Chroma frames -> 6-D tonal centroids ``[..., F, 6]``
    (``ops/features.py::tonnetz``). Stateless per frame. Feed from
    :class:`Chroma`."""

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        return features.tonnetz(x)


@register_node
@dataclass(frozen=True)
class Cqt(Node):
    """samples -> constant-Q frames ``[..., F, n_bins]`` (``ops/cqt.py``).
    Streaming (center=False, a magnitude or power output) keeps a carry of
    ``F0 - hop`` samples, ``F0`` the lowest octave's frame span, so the
    streamed frames are exactly the offline ones at ``(F0 - hop) / hop``
    frames of latency."""

    hop: int = 256
    n_bins: int = 84
    fmin: float = cqt_ops.FMIN_C1
    bins_per_octave: int = 12
    window: str = "hann"
    filter_scale: float = 1.0
    center: bool = True
    output: str = "magnitude"
    impl: str = "split"
    precision: str | None = None
    sample_rate: int | None = None

    domain_out = "frames"

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Cqt.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def _cqt(self, x, center):
        return cqt_ops.cqt(
            x, self._rate(), self.hop, self.n_bins, self.fmin, self.bins_per_octave, self.window,
            self.filter_scale, center=center, output=self.output, impl=self.impl, precision=self.precision,
        )

    def apply(self, x):
        return self._cqt(x, self.center)

    def chunk_multiple(self):
        return self.hop

    @property
    def streamable(self):  # center-padding needs the whole signal
        return not self.center and self.output != "complex"

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.center:
            raise AudioError("Cqt: streaming requires center=False", code=ErrorCode.CONFIG_VALIDATION_ERROR)

    def out_len(self, n_in):
        return n_in // self.hop

    @property
    def _carry_len(self) -> int:
        # the frame span F0 is a hop multiple by construction
        f0 = cqt_ops.cqt_window_length(
            self._rate(), self.hop, self.n_bins, self.fmin, self.bins_per_octave, self.filter_scale
        )
        return f0 - self.hop

    def latency(self, n_in):
        return self._carry_len // self.hop

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return torch.zeros((*lead_shape, self._carry_len), dtype=dtype, device=device)

    def step(self, carry, chunk):
        buf = torch.cat([carry, chunk], dim=-1)
        return buf[..., buf.shape[-1] - self._carry_len :], self._cqt(buf, False)


@register_node
@dataclass(frozen=True)
class Icqt(Node):
    """Complex constant-Q coefficients ``[..., F, n_bins]`` (a
    ``Cqt(output="complex")`` at the SAME parameters) -> waveform
    (``ops/cqt.py::icqt``; ``method="auto"`` picks the painless dual for fine
    hops and the hybrid inverse past the painless cliff, which reconstructs
    tonal content only there). Offline only: the dual support spans ``nd/2``
    samples each side."""

    hop: int = 256
    n_bins: int = 84
    fmin: float = cqt_ops.FMIN_C1
    bins_per_octave: int = 12
    window: str = "hann"
    filter_scale: float = 1.0
    center: bool = True
    method: str = "auto"
    precision: str | None = None
    sample_rate: int | None = None
    streamable = False

    domain_in = "frames"
    domain_out = "samples"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError("Icqt.sample_rate unresolved; set input_rate on the graph")
        return cqt_ops.icqt(
            x, self.sample_rate, self.hop, self.n_bins, self.fmin, self.bins_per_octave, self.window,
            self.filter_scale, center=self.center, precision=self.precision, method=self.method,
        )

    def out_len(self, n_in):
        return (n_in - 1) * self.hop


@register_node
@dataclass(frozen=True)
class CqtRoundTripMultirate(Node):
    """samples -> multirate CQT -> its inverse -> samples in one node
    (``ops/cqt.py::cqt_multirate`` + ``icqt_multirate``, the broadband
    invertible variant). The per-octave coefficients stay inside the node:
    their octaves have different frame rates. Offline only."""

    hop: int = 256
    n_bins: int = 84
    fmin: float = cqt_ops.FMIN_C1
    bins_per_octave: int = 12
    window: str = "hann"
    filter_scale: float = 1.0
    precision: str | None = None
    sample_rate: int | None = None
    streamable = False

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError("CqtRoundTripMultirate.sample_rate unresolved; set input_rate on the graph")
        c = cqt_ops.cqt_multirate(
            x, self.sample_rate, self.hop, self.n_bins, self.fmin, self.bins_per_octave, self.window,
            self.filter_scale, precision=self.precision,
        )
        return cqt_ops.icqt_multirate(c, length=x.shape[-1], precision=self.precision)


@register_node
@dataclass(frozen=True)
class OnsetStrength(Node):
    """Mel power frames -> onset envelope ``[..., F, 1]``
    (``ops/rhythm.py::onset_strength``). Streaming carries the last ``lag``
    frames (``n_bins`` sizes the carry); the offline zeros at frames < lag
    come back through ``wants_first_index``."""

    lag: int = 1
    n_bins: int | None = None

    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    @property
    def streamable(self):
        return self.n_bins is not None

    def apply(self, x):
        return rhythm.onset_strength(x, self.lag)[..., None]

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.n_bins is None:
            raise AudioError(
                "OnsetStrength: streaming needs n_bins (the mel band count) to size the prev-frames carry",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return torch.zeros((*lead_shape, self.lag, self.n_bins), dtype=dtype, device=device)

    def step(self, carry, chunk, first_index=None):
        buf = torch.cat([carry, chunk], dim=-2)
        env = rhythm.onset_strength(buf, self.lag)[..., self.lag :, None]
        if first_index is not None:
            # offline frames < lag are zero (nothing to difference against)
            pos = torch.arange(chunk.shape[-2], device=chunk.device)[:, None]
            env = torch.where(pos < first_index + self.lag, 0.0, env)
        return buf[..., buf.shape[-2] - self.lag :, :], env


@register_node
@dataclass(frozen=True)
class Tempo(Node):
    """Onset envelope frames ``[..., F, 1]`` -> global tempo ``[..., 1, 1]``
    in BPM (``ops/rhythm.py::tempo``). Offline only."""

    hop: int = 256
    start_bpm: float = 120.0
    std_bpm: float = 1.0
    max_tempo: float = 320.0
    ac_size: float = 8.0
    sample_rate: int | None = None
    streamable = False

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError("Tempo.sample_rate unresolved; set input_rate on the graph")
        bpm = rhythm.tempo(
            x[..., 0], self.sample_rate, self.hop, self.start_bpm, self.std_bpm, self.max_tempo, self.ac_size
        )
        return bpm[..., None, None]

    def out_len(self, n_in):
        return 1


@register_node
@dataclass(frozen=True)
class BeatTrack(Node):
    """Onset envelope frames ``[..., F, 1]`` -> beat mask ``[..., F, 1]``
    (1.0 at beat frames; ``ops/rhythm.py::beat_track``, the Ellis DP).
    Offline only."""

    hop: int = 256
    tightness: float = 100.0
    max_period: int = 256
    start_bpm: float = 120.0
    sample_rate: int | None = None
    streamable = False

    domain_in = "frames"
    domain_out = "frames"

    def apply(self, x):
        if self.sample_rate is None:
            raise AudioError("BeatTrack.sample_rate unresolved; set input_rate on the graph")
        mask, _ = rhythm.beat_track(
            x[..., 0], self.sample_rate, self.hop, tightness=self.tightness, max_period=self.max_period,
            start_bpm=self.start_bpm,
        )
        return mask.to(x.dtype)[..., None]


@register_node
@dataclass(frozen=True)
class OnlineBeats(Node):
    """Onset envelope frames ``[..., F, 1]`` -> ``[..., F, 2]`` of (beat
    mask, BPM track) from the causal tracker
    (``ops/rhythm.py::online_beat_track``), the streaming counterpart of
    :class:`BeatTrack`. The carry is the tracker's dict; the latency is
    ``post`` frames, and streamed equals offline at that shift."""

    hop: int = 256
    start_bpm: float = 120.0
    std_bpm: float = 1.0
    max_tempo: float = 320.0
    max_lag: int = 256
    ac_seconds: float = 8.0
    pre: int = 3
    post: int = 3
    delta: float = 0.07
    warmup_seconds: float = 2.0
    sample_rate: int | None = None

    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    def _plan(self):
        if self.sample_rate is None:
            raise AudioError("OnlineBeats.sample_rate unresolved; set input_rate on the graph")
        return rhythm.make_online_beat_plan(
            self.sample_rate, self.hop, self.start_bpm, self.std_bpm, self.max_tempo, self.max_lag,
            self.ac_seconds, self.pre, self.post, self.delta, self.warmup_seconds,
        )

    def apply(self, x):
        self._plan()  # names an unresolved sample rate
        beat, bpm = rhythm.online_beat_track(
            x[..., 0], self.sample_rate, self.hop, start_bpm=self.start_bpm, std_bpm=self.std_bpm,
            max_tempo=self.max_tempo, max_lag=self.max_lag, ac_seconds=self.ac_seconds, pre=self.pre,
            post=self.post, delta=self.delta, warmup_seconds=self.warmup_seconds,
        )
        return torch.stack([beat.to(x.dtype), bpm.to(x.dtype)], dim=-1)

    def latency(self, n_in):
        return self.post

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return rhythm.online_beat_init(self._plan(), lead_shape, dtype, device)

    def step(self, carry, chunk, first_index=None):
        carry, (beat, bpm) = rhythm.online_beat_step(
            self._plan(), carry, chunk[..., 0], 0 if first_index is None else first_index
        )
        return carry, torch.stack([beat.to(chunk.dtype), bpm.to(chunk.dtype)], dim=-1)


@register_node
@dataclass(frozen=True)
class OnlinePyin(Node):
    """Streaming pYIN: samples -> per-frame ``[f0_hz, voiced_flag,
    voiced_prob]`` ``[..., F, 3]`` by fixed-lag Viterbi smoothing
    (``ops/pitch.py::online_pyin_step``), the causal counterpart of
    :class:`Pyin`. The carry is the hop-aligned frame overlap and the
    tracker's state; the latency is the overlap's frames plus ``lag``, and
    streamed equals offline at that whole-unit shift."""

    fmin: float = 65.0
    fmax: float = 2093.0
    frame_length: int = 2048
    hop: int = 256
    lag: int = 25
    resolution: float = 0.1
    n_thresholds: int = 100
    sample_rate: int | None = None
    impl: str = "auto"
    precision: str | None = None

    domain_out = "frames"

    def _plan(self):
        if self.sample_rate is None:
            raise AudioError("OnlinePyin.sample_rate unresolved; set input_rate on the graph")
        return make_online_pyin_plan(
            self.sample_rate, self.fmin, self.fmax, self.frame_length, self.hop, self.lag,
            n_thresholds=self.n_thresholds, resolution=self.resolution, impl=self.impl, precision=self.precision,
        )

    @staticmethod
    def _stack(out, dtype):
        f0, vf, vp = out
        return torch.stack([f0.to(dtype), vf.to(dtype), vp.to(dtype)], dim=-1)

    def apply(self, x):
        plan = self._plan()
        out = self._stack(pyin_online(
            x, plan.sample_rate, self.fmin, self.fmax, self.frame_length, self.hop, self.lag,
            n_thresholds=self.n_thresholds, resolution=self.resolution, impl=self.impl, precision=self.precision,
        ), x.dtype)
        # realign: the emission at frame t decodes frame t - lag, and the
        # offline form reports at the decoded frame; the last `lag` frames
        # repeat the final decode (the streamed signal ends before them)
        tail = out[..., -1:, :].expand(*out.shape[:-2], self.lag, out.shape[-1])
        return torch.cat([out[..., self.lag :, :], tail], dim=-2)

    def chunk_multiple(self):
        return self.hop

    def out_len(self, n_in):
        return n_in // self.hop

    @property
    def _carry_len(self) -> int:
        return (-(-self.frame_length // self.hop) - 1) * self.hop

    def latency(self, n_in):
        return self._carry_len // self.hop + self.lag

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return {
            "buf": torch.zeros((*lead_shape, self._carry_len), dtype=dtype, device=device),
            "state": online_pyin_init(self._plan(), lead_shape, dtype, device),
        }

    def step(self, carry, chunk):
        buf = torch.cat([carry["buf"], chunk], dim=-1)
        state, out = online_pyin_step(
            self._plan(), carry["state"], frame(buf, self.frame_length, self.hop),
            skip_first=self._carry_len // self.hop,
        )
        return {"buf": buf[..., buf.shape[-1] - self._carry_len :], "state": state}, self._stack(out, chunk.dtype)


@register_node
@dataclass(frozen=True)
class Pcen(Node):
    """Per-channel energy normalization of mel or linear energies (frames
    domain). The offline warm start (M[0] = E[0]) depends on position, so
    streaming uses ``wants_first_index`` to reseed M at the stream's offline
    frame 0, as Preemphasis does for its edge. Streaming needs ``n_bins``
    (the feature width) to size the M carry; without it the node is offline
    only."""

    smooth: float = 0.025
    alpha: float = 0.98
    delta: float = 2.0
    r: float = 0.5
    eps: float = 1e-6
    n_bins: int | None = None
    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    @property
    def streamable(self):
        return self.n_bins is not None

    def apply(self, x):
        return features.pcen(x, self.smooth, self.alpha, self.delta, self.r, self.eps)

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if self.n_bins is None:
            raise AudioError(
                "Pcen: streaming needs n_bins (the feature width) to size the smoother carry",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return torch.zeros((*lead_shape, self.n_bins), dtype=dtype, device=device)

    def step(self, carry, chunk, first_index=None):
        m, m_last = features.pcen_smoother(chunk, self.smooth, m_prev=carry, first_index=first_index)
        return m_last, features.pcen_output(chunk, m, self.alpha, self.delta, self.r, self.eps)


@register_node
@dataclass(frozen=True)
class Deltas(Node):
    """Regression deltas appended to features: [static, d, dd, ...] along
    the feature axis (``ops/features.py::add_deltas``).

    Streaming (orders=(1,) with ``n_bins`` set): the regression window reads
    width//2 future frames, so the node declares that latency and carries
    the last width-1 raw frames; the offline edge replication at the
    stream's frame 0 comes from clipping window indices at the
    ``wants_first_index`` position. Higher orders replicate the intermediate
    delta sequence's edges offline, which has no constant-latency streaming
    form: offline only."""

    width: int = 9
    orders: tuple = (1, 2)
    n_bins: int | None = None
    domain_in = "frames"
    domain_out = "frames"
    wants_first_index = True

    @property
    def streamable(self):
        return tuple(self.orders) == (1,) and self.n_bins is not None

    def apply(self, x):
        return features.add_deltas(x, self.width, tuple(self.orders))

    def validate_chunk(self, n_in):
        super().validate_chunk(n_in)
        if not self.streamable:
            raise AudioError(
                "Deltas: streaming needs orders=(1,) and n_bins set (higher orders edge-replicate the "
                "intermediate delta sequence, which has no constant-latency streaming form)",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def latency(self, n_in):
        return self.width // 2

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return torch.zeros((*lead_shape, self.width - 1, self.n_bins), dtype=dtype, device=device)

    def step(self, carry, chunk, first_index=None):
        w = self.width
        buf = torch.cat([carry, chunk], dim=-2)  # [.., w-1+m, nb]
        m = chunk.shape[-2]
        # window j reads buf[j .. j+w-1]
        idx = torch.arange(m, device=chunk.device)[:, None] + torch.arange(w, device=chunk.device)[None, :]
        if first_index is not None:
            # offline edge replication: frames before the stream's frame 0
            # (buf position first_index + w - 1) read that frame instead
            idx = torch.clamp_min(idx, first_index + w - 1)
        idx = torch.clamp_max(idx, buf.shape[-2] - 1)
        win = buf.index_select(-2, idx.reshape(-1)).reshape(*buf.shape[:-2], m, w, buf.shape[-1])
        taps = features.delta_taps(w, chunk.device, chunk.dtype)
        d1 = (win * taps[:, None]).sum(dim=-2)
        static = win[..., w // 2, :]  # the center frame, latency-aligned
        return buf[..., m:, :], torch.cat([static, d1], dim=-1)


@register_node
@dataclass(frozen=True)
class Delay(Node):
    """Feedback delay / echo (``ops/effects.py::feedback_delay``): a host loop
    over D-sample blocks. Streaming carries the last D samples of input and
    wet line, so streamed equals offline exactly at any chunk size."""

    delay_s: float = 0.25
    feedback: float = 0.4
    mix: float = 0.5
    sample_rate: int | None = None

    def _d(self):
        if self.sample_rate is None:
            raise AudioError("Delay.sample_rate unresolved; set input_rate on the graph")
        d = int(round(self.delay_s * self.sample_rate))
        if d < 1:
            raise AudioError(
                f"Delay: delay_s {self.delay_s} is under one sample at {self.sample_rate} Hz",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        return d

    def apply(self, x):
        return effects.feedback_delay(x, self._d(), self.feedback, self.mix)[0]

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        d = self._d()
        return (
            torch.zeros((*lead_shape, d), dtype=dtype, device=device),
            torch.zeros((*lead_shape, d), dtype=dtype, device=device),
        )

    def step(self, carry, chunk):
        y, carry = effects.feedback_delay(chunk, self._d(), self.feedback, self.mix, carry)
        return carry, y


@register_node
@dataclass(frozen=True)
class Tremolo(Node):
    """Amplitude LFO (``ops/effects.py::tremolo``). The gain depends on the
    absolute sample position, so the node takes ``first_index`` and streamed
    chunks reproduce the offline LFO phase exactly."""

    rate_hz: float = 5.0
    depth: float = 0.5
    phase: float = 0.0
    sample_rate: int | None = None
    wants_first_index = True

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError("Tremolo.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def apply(self, x):
        return effects.tremolo(x, self._rate(), self.rate_hz, self.depth, self.phase)

    def step(self, carry, chunk, first_index=None):
        t0 = 0 if first_index is None else -first_index
        return carry, effects.tremolo(chunk, self._rate(), self.rate_hz, self.depth, self.phase, t0)


@dataclass(frozen=True)
class _ModTapNode(Node):
    """Shared by the LFO-modulated delays: the carry is the last Dmax input
    samples (zeros offline), the absolute position comes from
    ``first_index``.

    The interpolation weights are computed from a chunk-local index origin,
    so streamed output agrees with offline to fp32 rounding of the read
    position (about 1e-3 absolute on unit-scale audio), not bit for bit: the
    JAX package's one documented exception to its streamed-equals-offline
    rule."""

    sample_rate: int | None = None
    wants_first_index = True

    def _rate(self):
        if self.sample_rate is None:
            raise AudioError(f"{type(self).__name__}.sample_rate unresolved; set input_rate on the graph")
        return self.sample_rate

    def _dmax(self):
        return effects.history_len(self._rate(), self._base(), self.depth_s)

    def _base(self):
        return 0.0

    def _apply_tap(self, x, t0, history):
        raise NotImplementedError

    def apply(self, x):
        return self._apply_tap(x, 0, None)

    def init_carry(self, lead_shape, n_in, dtype=torch.float32, device=None):
        return torch.zeros((*lead_shape, self._dmax()), dtype=dtype, device=device)

    def step(self, carry, chunk, first_index=None):
        t0 = 0 if first_index is None else -first_index
        y = self._apply_tap(chunk, t0, carry)
        return torch.cat([carry, chunk], dim=-1)[..., -self._dmax() :], y


@register_node
@dataclass(frozen=True)
class Vibrato(_ModTapNode):
    """Pitch LFO (``ops/effects.py::vibrato``)."""

    rate_hz: float = 5.0
    depth_s: float = 0.002
    phase: float = 0.0

    def _apply_tap(self, x, t0, history):
        return effects.vibrato(x, self._rate(), self.rate_hz, self.depth_s, self.phase, t0, history)


@register_node
@dataclass(frozen=True)
class Chorus(_ModTapNode):
    """Multi-voice ensemble (``ops/effects.py::chorus``)."""

    rate_hz: float = 0.8
    depth_s: float = 0.003
    base_delay_s: float = 0.02
    voices: int = 3
    mix: float = 0.5

    def _base(self):
        return self.base_delay_s

    def _apply_tap(self, x, t0, history):
        return effects.chorus(
            x, self._rate(), self.rate_hz, self.depth_s, self.base_delay_s, self.voices, self.mix, t0, history
        )


@register_node
@dataclass(frozen=True)
class Flanger(_ModTapNode):
    """Swept comb (``ops/effects.py::flanger``)."""

    rate_hz: float = 0.25
    depth_s: float = 0.002
    base_delay_s: float = 0.001
    mix: float = 0.5

    def _base(self):
        return self.base_delay_s

    def _apply_tap(self, x, t0, history):
        return effects.flanger(
            x, self._rate(), self.rate_hz, self.depth_s, self.base_delay_s, self.mix, t0, history
        )
