"""Signal ops of the port: plain torch on tensors, fp32 matmuls."""

from .framing import frame, num_frames
from .mel import apply_mel, hz_to_mel, log_mel, mel_filterbank, mel_to_hz
from .resample import resample
from .stft import spectrogram
from .windows import get_window

__all__ = [
    "apply_mel", "frame", "get_window", "hz_to_mel", "log_mel", "mel_filterbank",
    "mel_to_hz", "num_frames", "resample", "spectrogram",
]
