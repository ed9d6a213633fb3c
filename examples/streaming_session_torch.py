"""Example: dictation-style streaming with VAD gating and wire egress,
through the PyTorch port (the counterpart of ``examples/streaming_session.py``).

Feeds microphone-sized PCM pushes through a session, writes
reference-parity wire messages (base64 i16 chunks) to JSONL, snapshots
mid-stream (``<out>.ckpt.npz`` beside the output), and resumes. Runs on the
card unless ``--device cpu`` is given.

    python examples/streaming_session_torch.py input.wav out.jsonl [--device cpu]
"""

import argparse

import numpy as np

from audioflow_torch.graph import QuantizeI16, Resample, VadGate, chain
from audioflow_torch.io import read_wav
from audioflow_torch.session import StreamSession
from audioflow_torch.sinks import EventDispatcher, WireJsonlSink


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("wav_path")
    p.add_argument("out_jsonl", nargs="?", default="wire.jsonl")
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    pcm, rate = read_wav(args.wav_path)
    if pcm.ndim == 2:
        pcm = pcm.mean(axis=1).astype(np.float32)
    graph = chain(
        VadGate(frame_len=rate * 20 // 1000),  # 20 ms VAD frames
        Resample(rate, 16000, "cubic"),  # reference rubato-parity mode
        QuantizeI16(),
        input_rate=rate,
    )
    events = EventDispatcher()
    events.subscribe(
        lambda e: e.kind.value == "audio_level"
        and print(f"  level rms={e.payload['rms']:.3f} peak={e.payload['peak']:.3f}")
    )
    session = StreamSession(graph, sinks=[WireJsonlSink(args.out_jsonl)], events=events, device=args.device)
    with session:
        # push in mic-callback-sized bites; the session accumulates
        step = rate // 50
        starts = list(range(0, len(pcm), step))
        half = len(starts) // 2
        for i in starts[:half]:
            session.push(pcm[i : i + step])
        session.snapshot(args.out_jsonl + ".ckpt")  # resumable mid-stream
        for i in starts[half:]:
            session.push(pcm[i : i + step])
        final = session.flush()
        print("final chunk index:", final.index if final else "(none)")
    print(f"wire messages -> {args.out_jsonl}")


if __name__ == "__main__":
    main()
