"""Example: extract log-mel features from a directory of WAVs, pipelined,
through the PyTorch port (the counterpart of ``examples/batch_features.py``).

Runs on the card unless ``--device cpu`` is given.

    python examples/batch_features_torch.py /path/to/wavs '*.wav' out_features.npy [--device cpu]
"""

import argparse
from pathlib import Path

from audioflow_torch.io import BatchLoader
from audioflow_torch.models import log_mel_frontend
from audioflow_torch.runner import run_batches
from audioflow_torch.sinks import NpySink


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("wav_dir")
    p.add_argument("pattern", nargs="?", default="*.wav")
    p.add_argument("out", nargs="?", default="features.npy")
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    files = sorted(Path(args.wav_dir).glob(args.pattern))
    if not files:
        raise SystemExit(f"no files matching {args.pattern} under {args.wav_dir}")
    graph = log_mel_frontend(input_rate=44100, target_rate=16000, n_mels=128)
    sink = NpySink(args.out)
    metrics = run_batches(graph, BatchLoader(files, batch_size=64), sinks=[sink], expect_rate=44100,
                          device=args.device)
    sink.close()
    print(
        f"{metrics.files} files ({metrics.failed_files} failed lanes), "
        f"{metrics.audio_seconds:.1f} audio-s at {metrics.realtime_factor:.0f}x realtime -> {args.out}"
    )


if __name__ == "__main__":
    main()
