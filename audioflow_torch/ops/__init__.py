"""Signal ops of the port: plain torch on tensors, fp32 matmuls."""

from .framing import frame, num_frames, overlap_add
from .griffinlim import griffin_lim
from .mel import (
    apply_mel,
    dct_matrix,
    hz_to_mel,
    log_mel,
    mel_filterbank,
    mel_to_audio,
    mel_to_hz,
    mel_to_stft,
    mfcc,
    mfcc_to_audio,
    mfcc_to_log_mel,
)
from .phase_vocoder import phase_vocoder, pitch_shift, time_stretch
from .pitch import cmnd_frames, pyin, pyin_frames, yin, yin_frames, yin_voicing
from .resample import resample
from .sequence import max_plus_band, max_plus_band_argmax, transition_local
from .stft import istft, magnitude, power, spectrogram, stft
from .windows import get_window

__all__ = [
    "apply_mel", "cmnd_frames", "dct_matrix", "frame", "get_window", "griffin_lim", "hz_to_mel", "istft",
    "log_mel", "magnitude", "max_plus_band", "max_plus_band_argmax", "mel_filterbank", "mel_to_audio",
    "mel_to_hz", "mel_to_stft", "mfcc", "mfcc_to_audio", "mfcc_to_log_mel", "num_frames", "overlap_add",
    "phase_vocoder", "pitch_shift", "power", "pyin", "pyin_frames", "resample", "spectrogram", "stft",
    "time_stretch", "transition_local", "yin", "yin_frames", "yin_voicing",
]
