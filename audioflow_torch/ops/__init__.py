"""Signal ops of the port: plain torch on tensors, fp32 matmuls."""

from . import augment, biquad, decompose, dynamics, effects, features, fir, loudness, quantize, rhythm, ring, segment, vad
from . import cqt as cqt_mod
from . import lpc as lpc_mod
from ._mm import get_default_matmul_precision, set_default_matmul_precision
from .augment import freq_mask, spec_augment, time_mask
from .biquad import (
    Biquad,
    allpass,
    bandpass,
    biquad_chain,
    high_shelf,
    highpass,
    iir_apply,
    low_shelf,
    lowpass,
    make_iir_plan,
    notch,
    peaking,
)
from .dynamics import (
    agc,
    cmvn,
    compressor,
    compressor_gain,
    deemphasis,
    energy_to_dbfs,
    gain_db,
    gate_gain,
    limiter,
    mean_square_energy,
    noise_gate,
    peak_normalize,
    preemphasis,
    rms_normalize,
    split_silence,
    to_mono,
    trim_silence,
)
from .cqt import (
    FMIN_C1,
    MultirateCqt,
    chroma_cqt,
    cqt,
    cqt_frequencies,
    cqt_lengths,
    cqt_multirate,
    cqt_window_length,
    icqt,
    icqt_max_hop,
    icqt_multirate,
    multirate_hops,
)
from .effects import chorus, feedback_delay, flanger, tremolo, vibrato
from .decompose import hpss, hpss_mask, median_filter, nmf, nmf_separate, noise_profile, spectral_gate
from .features import (
    add_deltas,
    chroma,
    chroma_filterbank,
    contrast_bands,
    delta,
    fft_frequencies,
    frame_rms,
    pcen,
    pcen_smoother,
    spectral_bandwidth,
    spectral_centroid,
    spectral_contrast,
    spectral_features,
    spectral_flatness,
    spectral_flux,
    spectral_rolloff,
    stack_memory,
    tonnetz,
    tonnetz_basis,
    zero_crossing_rate,
)
from .fir import convolve, fir_apply, fir_design
from .framing import frame, num_frames, overlap_add
from .griffinlim import griffin_lim
from .lpc import lpc, lpc_from_autocorr, lpc_residual_energy
from .loudness import (
    integrated_loudness,
    k_weight,
    k_weighting,
    loudness_range,
    momentary_loudness,
    normalize_loudness,
    shortterm_loudness,
    true_peak,
)
from .mel import (
    apply_mel,
    dct_matrix,
    hz_to_mel,
    log_mel,
    log_mel_fused,
    mel_filterbank,
    mel_to_audio,
    mel_to_hz,
    mel_to_stft,
    mfcc,
    mfcc_to_audio,
    mfcc_to_log_mel,
)
from .phase_vocoder import phase_vocoder, pitch_shift, time_stretch
from .quantize import dequantize_i16, quantize_i16, quantize_i16_round
from .pitch import (
    ACF_PRECISION_DEFAULT,
    OnlinePyinPlan,
    cmnd_frames,
    make_online_pyin_plan,
    online_pyin_init,
    online_pyin_step,
    piptrack,
    pyin,
    pyin_frames,
    pyin_online,
    yin,
    yin_frames,
    yin_voicing,
)
from .resample import ResamplePlan, make_plan, resample, resample_apply
from .rhythm import (
    autocorrelate,
    beat_track,
    make_online_beat_plan,
    online_beat_init,
    online_beat_step,
    online_beat_track,
    onset_strength,
    peak_pick,
    tempo,
    tempo_frequencies,
    tempogram,
)
from .ring import Ring, ring_available, ring_clear, ring_free, ring_init, ring_read, ring_write
from .segment import cross_similarity, novelty_curve, recurrence_matrix, segment_boundaries, self_similarity
from .sequence import dtw, max_plus_band, max_plus_band_argmax, transition_local, viterbi
from .stft import istft, magnitude, power, spectrogram, stft
from .vad import VAD_LEVELS, VadCarry, VadConfig, is_speaking, vad_init, vad_scan, vad_step
from .windows import get_window

__all__ = [
    "Biquad", "Ring", "VAD_LEVELS", "VadCarry", "VadConfig", "dequantize_i16", "is_speaking", "quantize",
    "quantize_i16", "quantize_i16_round", "ring", "ring_available", "ring_clear", "ring_free", "ring_init",
    "ring_read", "ring_write", "vad", "vad_init", "vad_scan", "vad_step", "agc", "allpass", "apply_mel", "bandpass", "biquad", "biquad_chain", "cmnd_frames", "cmvn",
    "compressor", "compressor_gain", "dct_matrix", "deemphasis", "dynamics", "energy_to_dbfs", "frame",
    "gain_db", "gate_gain", "get_window", "griffin_lim", "high_shelf", "highpass", "hz_to_mel", "iir_apply",
    "istft", "limiter", "log_mel", "low_shelf", "lowpass", "magnitude", "make_iir_plan", "max_plus_band",
    "max_plus_band_argmax", "mean_square_energy", "mel_filterbank", "mel_to_audio", "mel_to_hz", "mel_to_stft",
    "mfcc", "mfcc_to_audio", "mfcc_to_log_mel", "noise_gate", "notch", "num_frames", "overlap_add", "peak_normalize",
    "peaking", "phase_vocoder", "pitch_shift", "power", "preemphasis", "pyin", "pyin_frames", "resample",
    "rms_normalize", "spectrogram", "split_silence", "stft", "time_stretch", "to_mono", "transition_local",
    "trim_silence", "yin", "yin_frames", "yin_voicing",
    # mastering, effects and features
    "add_deltas", "chorus", "chroma", "chroma_filterbank", "contrast_bands", "convolve", "decompose", "delta",
    "effects", "features", "feedback_delay", "fft_frequencies", "fir", "fir_apply", "fir_design", "flanger",
    "frame_rms", "hpss", "hpss_mask", "integrated_loudness", "k_weight", "k_weighting", "loudness",
    "loudness_range", "median_filter", "momentary_loudness", "nmf", "nmf_separate", "noise_profile",
    "normalize_loudness", "pcen", "pcen_smoother", "shortterm_loudness", "spectral_bandwidth", "spectral_centroid",
    "spectral_contrast", "spectral_features", "spectral_flatness", "spectral_flux", "spectral_gate",
    "spectral_rolloff", "stack_memory", "tonnetz", "tonnetz_basis", "tremolo", "true_peak", "vibrato",
    "zero_crossing_rate",
    # the CQT and rhythm families, and the reference's remaining names
    "ACF_PRECISION_DEFAULT", "FMIN_C1", "MultirateCqt", "ResamplePlan", "autocorrelate", "beat_track", "chroma_cqt",
    "cqt", "cqt_frequencies", "cqt_lengths", "cqt_mod", "cqt_multirate", "cqt_window_length",
    "get_default_matmul_precision", "icqt", "icqt_max_hop", "icqt_multirate", "log_mel_fused", "make_online_beat_plan",
    "make_plan", "multirate_hops", "online_beat_init", "online_beat_step", "online_beat_track", "onset_strength",
    "peak_pick", "resample_apply", "rhythm", "set_default_matmul_precision", "tempo", "tempo_frequencies", "tempogram",
    # sequence decoding, LPC, structure and the streaming and spectral-peak pitch trackers
    "OnlinePyinPlan", "cross_similarity", "dtw", "lpc", "lpc_from_autocorr", "lpc_mod", "lpc_residual_energy",
    "make_online_pyin_plan", "novelty_curve", "online_pyin_init", "online_pyin_step", "piptrack", "pyin_online",
    "recurrence_matrix", "segment", "segment_boundaries", "self_similarity", "viterbi",
    # SpecAugment
    "augment", "freq_mask", "spec_augment", "time_mask",
]
