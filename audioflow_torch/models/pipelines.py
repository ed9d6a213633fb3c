"""Standard pipeline constructors, mirroring ``audioflow_tpu/models/pipelines.py``.

Each returns a :class:`~audioflow_torch.graph.Graph`.
"""

from __future__ import annotations

from ..graph import (
    BeatTrack,
    BiquadChain,
    Cmvn,
    Compressor,
    Cqt,
    Deltas,
    Graph,
    Limiter,
    LogMelSpec,
    LoudnessNormalize,
    MelProject,
    OnsetStrength,
    Pcen,
    Preemphasis,
    QuantizeI16,
    Resample,
    SpectralGate,
    Spectrogram,
    Vad,
    chain,
)
from ..ops import biquad as bq
from ..ops.cqt import FMIN_C1


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
    """The flagship frontend (benchmark configs 2 and 5): polyphase
    resample -> (optional EQ) -> STFT -> power -> 128-bin log-mel.

    ``eq`` is a tuple of :class:`~audioflow_torch.ops.biquad.Biquad` run as
    a :class:`~audioflow_torch.graph.BiquadChain` after the resampler.
    ``fused=True`` (the default here) runs the STFT, power, mel and log as
    one :class:`~audioflow_torch.graph.LogMelSpec` node, that is, through the
    hand-written CUDA kernel. The JAX package defaults to ``False`` on the
    strength of a TPU measurement that does not carry over. ``fused=False``
    gives the Spectrogram + MelProject pair in plain torch; both forms
    compute the same function.
    """
    nodes: list = []
    if input_rate != target_rate:
        nodes.append(Resample(input_rate, target_rate, resample_mode))
    if eq:
        nodes.append(BiquadChain(tuple(eq)))
    if fused:
        nodes.append(LogMelSpec(n_fft, hop, n_mels, center=center))
    else:
        nodes += [Spectrogram(n_fft, hop, center=center, power=True), MelProject(n_mels=n_mels)]
    return Graph(tuple(nodes), input_rate=input_rate, name="log_mel_frontend")


def eq_bands_default(sample_rate: float) -> tuple:
    """High-pass + 5-band parametric EQ (benchmark config 3's chain)."""
    return (
        bq.highpass(60.0, sample_rate),
        bq.peaking(150.0, sample_rate, 2.0, 1.0),
        bq.peaking(400.0, sample_rate, -3.0, 1.2),
        bq.peaking(1000.0, sample_rate, 2.5, 0.9),
        bq.peaking(3000.0, sample_rate, -2.0, 1.4),
        bq.peaking(8000.0, sample_rate, 1.5, 1.0),
    )


def eq_chain_graph(sample_rate: int = 16000, bands: tuple | None = None) -> Graph:
    return chain(
        BiquadChain(bands or eq_bands_default(sample_rate)),
        input_rate=sample_rate,
        name="eq_chain",
    )


def master_chain_graph(
    sample_rate: int = 16000,
    bands: tuple | None = None,
    limiter_db: float = -1.0,
    release_ms: float = 50.0,
) -> Graph:
    """Benchmark config 3: high-pass + 5-band parametric EQ + limiter."""
    return chain(
        BiquadChain(bands or eq_bands_default(sample_rate)),
        Limiter(limiter_db, release_ms),
        input_rate=sample_rate,
        name="master_chain",
    )


def kaldi_fbank_frontend(
    sample_rate: int = 16000,
    frame_ms: float = 25.0,
    hop_ms: float = 10.0,
    n_mels: int = 80,
    preemph: float = 0.97,
    window: str = "povey",
    cmvn: bool = True,
    norm_var: bool = False,
) -> Graph:
    """Kaldi-style filterbank frontend: pre-emphasis -> povey-window STFT ->
    power -> HTK-mel log-fbank -> CMVN. The standard ASR feature family."""
    win = int(sample_rate * frame_ms / 1000)
    hop = int(sample_rate * hop_ms / 1000)
    n_fft = 1 << (win - 1).bit_length()  # next pow2
    nodes: list = [
        Preemphasis(preemph),
        Spectrogram(n_fft, hop, window=window, center=False, power=True, win_length=win),
        MelProject(n_mels=n_mels, htk=True, norm=None, f_min=20.0, log="ln"),
    ]
    if cmvn:
        nodes.append(Cmvn(norm_var=norm_var))
    return Graph(tuple(nodes), input_rate=sample_rate, name="kaldi_fbank")


def kws_frontend(
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 40,
    smooth: float = 0.025,
) -> Graph:
    """Keyword-spotting frontend: mel energies -> PCEN (Wang et al. 2017,
    the trained-AGC alternative to log compression). Fully streamable: the
    PCEN smoother carries M across chunks with the warm-start reseed."""
    return Graph(
        (
            Spectrogram(n_fft, hop, center=False, power=True),
            MelProject(n_mels=n_mels, log=None),
            Pcen(smooth=smooth, n_bins=n_mels),
        ),
        input_rate=sample_rate,
        name="kws_frontend",
    )


def delta_fbank_frontend(sample_rate: int = 16000, n_mels: int = 24, width: int = 9) -> Graph:
    """Streaming ASR features: log-mel fbank + order-1 regression deltas
    ([static, d] layout, width//2 frames of declared latency)."""
    return Graph(
        (
            Spectrogram(1024, 256, center=False, power=True),
            MelProject(n_mels=n_mels),
            Deltas(width=width, orders=(1,), n_bins=n_mels),
        ),
        input_rate=sample_rate,
        name="delta_fbank",
    )


def denoise_master_chain(sample_rate: int = 16000, target_lufs: float = -16.0, eq: tuple | None = None) -> Graph:
    """Offline voice-mastering chain: spectral-gate denoise -> EQ ->
    compressor -> loudness normalize to ``target_lufs`` (the podcast and
    voice-over convention) under the R128 true-peak ceiling."""
    return Graph(
        (
            SpectralGate(1024, 256, n_std=1.5, prop_decrease=0.9),
            BiquadChain(tuple(eq) if eq else eq_bands_default(float(sample_rate))),
            Compressor(threshold_db=-22.0, ratio=3.0, knee_db=6.0),
            LoudnessNormalize(target_lufs=target_lufs, max_true_peak_db=-1.0),
        ),
        input_rate=sample_rate,
        name="denoise_master",
    )


def vad_graph(
    sample_rate: int = 16000,
    frame_ms: int = 20,
    threshold_db: float = -50.0,
    smoothing_factor: float = 0.3,
    level: str = "",
) -> Graph:
    """The dictation front path's feature: frame-wise VAD states. ``level``
    names a sensitivity preset, overriding ``threshold_db``."""
    frame_len = sample_rate * frame_ms // 1000
    return chain(
        Vad(frame_len, threshold_db, smoothing_factor, level=level),
        input_rate=sample_rate,
        name="vad",
    )


def cqt_frontend(
    sample_rate: int = 16000,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float | None = None,
    bins_per_octave: int = 12,
) -> Graph:
    """Constant-Q analysis frontend: samples -> CQT magnitude (streamable)."""
    return chain(
        Cqt(hop=hop, n_bins=n_bins, fmin=FMIN_C1 if fmin is None else fmin, bins_per_octave=bins_per_octave,
            center=False),
        input_rate=sample_rate,
        name="cqt_frontend",
    )


def onset_frontend(
    sample_rate: int = 16000, n_fft: int = 1024, hop: int = 256, n_mels: int = 64, lag: int = 1
) -> Graph:
    """Onset-strength envelope frontend (streamable): spectrogram -> linear
    mel power -> rectified dB flux."""
    return Graph(
        (
            Spectrogram(n_fft, hop, center=False, power=True),
            MelProject(n_mels=n_mels, log=None),  # onset wants linear power
            OnsetStrength(lag=lag, n_bins=n_mels),
        ),
        input_rate=sample_rate,
        name="onset_frontend",
    )


def beat_graph(
    sample_rate: int = 16000, n_fft: int = 1024, hop: int = 256, n_mels: int = 64, start_bpm: float = 120.0
) -> Graph:
    """Beat-tracking graph (offline): onset frontend -> Ellis DP beat mask
    (1.0 at beat frames)."""
    return Graph(
        (
            Spectrogram(n_fft, hop, center=False, power=True),
            MelProject(n_mels=n_mels, log=None),
            OnsetStrength(n_bins=n_mels),
            BeatTrack(hop=hop, start_bpm=start_bpm),
        ),
        input_rate=sample_rate,
        name="beat_graph",
    )


def wire_egress_graph(input_rate: int = 48000, target_rate: int = 16000) -> Graph:
    """The device side of the dictation path: capture rate -> 16 kHz resample
    (cubic, the reference's mode) -> i16, the samples the wire codec base64s."""
    return chain(
        Resample(input_rate, target_rate, "cubic"),
        QuantizeI16(),
        input_rate=input_rate,
        name="wire_egress",
    )
