"""Signal ops of the port: plain torch on tensors, fp32 matmuls."""

from .framing import frame, num_frames, overlap_add
from .mel import apply_mel, hz_to_mel, log_mel, mel_filterbank, mel_to_hz
from .phase_vocoder import phase_vocoder, pitch_shift, time_stretch
from .resample import resample
from .stft import istft, magnitude, power, spectrogram, stft
from .windows import get_window

__all__ = [
    "apply_mel", "frame", "get_window", "hz_to_mel", "istft", "log_mel", "magnitude",
    "mel_filterbank", "mel_to_hz", "num_frames", "overlap_add", "phase_vocoder",
    "pitch_shift", "power", "resample", "spectrogram", "stft", "time_stretch",
]
