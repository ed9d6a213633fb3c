"""Device-time breakdown of the port's paths on one CUDA card.

    python -m audioflow_torch.profiling [logmel] [pvoc] [pitch] [griffinlim]

Each path runs in two variants at the JAX benchmark's sizes
(``audioflow_tpu/bench.py``): through the hand-written kernel and through
plain torch. For each variant it prints one JSON line: the untraced run's
time (CUDA events, after a warm-up run), the traced run's wall time, the
device's busy time under the trace (the sum of kernel self times, one
stream), the idle shares, and the kernels by device time with their calls.
Without a card it exits non-zero and prints no result.

* ``logmel``: ``log_mel_frontend(44100, 16000, 1024, 256, 128)`` streamed
  over 512 x 10 s in 14,112-sample chunks, fused (melspec kernel) vs the
  Spectrogram + MelProject graph;
* ``pvoc``: ``time_stretch(x, 1.25)`` on 64 x 10 s at 16 kHz,
  ``impl="pallas"`` (timestretch kernel) vs ``"matmul"``;
* ``pitch``: ``pitch_shift(x, 12.0)`` on the same batch, both impls;
* ``griffinlim``: ``griffin_lim(mag, n_iter=8)`` on the magnitude
  ``[64, 626, 513]`` of the same batch (n_fft 1024, hop 256), ``impl="auto"``
  (griffinlim kernel, one launch per iteration) vs ``"matmul"``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


def tone_batch(batch: int, seconds: float, rate: int, seed: int = 0) -> np.ndarray:
    """A copy of ``audioflow_tpu/bench.py::_tone_batch``: random tones plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate), dtype=np.float32) / rate
    freqs = rng.uniform(80, 4000, batch).astype(np.float32)
    x = 0.3 * np.sin(2 * np.pi * freqs[:, None] * t[None, :])
    x += 0.05 * rng.standard_normal((batch, t.size)).astype(np.float32)
    return x.astype(np.float32)


def _paths(dev):
    """name -> (audio seconds, {variant: fn}), built lazily per path."""
    from .models import log_mel_frontend
    from .ops import griffin_lim, pitch_shift, stft, time_stretch

    def logmel():
        chunk = 14112
        x = torch.from_numpy(tone_batch(512, 10.0, 44100)[:, : 31 * chunk]).to(dev)
        graphs = {v: log_mel_frontend(44100, 16000, 1024, 256, 128, fused=v == "kernel")
                  for v in ("kernel", "plain")}
        return 512 * x.shape[-1] / 44100, {v: (lambda g=g: g.scan_stream(x, chunk)) for v, g in graphs.items()}

    def stretch(fn):
        x = torch.from_numpy(tone_batch(64, 10.0, 16000)).to(dev)
        return 640.0, {"kernel": lambda: fn(x, "pallas"), "plain": lambda: fn(x, "matmul")}

    def griffinlim():
        x = torch.from_numpy(tone_batch(64, 10.0, 16000)).to(dev)
        mag = stft(x, 1024, 256).abs()
        t = x.shape[-1]
        return 640.0, {"kernel": lambda: griffin_lim(mag, n_iter=8, length=t),
                       "plain": lambda: griffin_lim(mag, n_iter=8, length=t, impl="matmul")}

    return {
        "logmel": logmel,
        "pvoc": lambda: stretch(lambda x, impl: time_stretch(x, 1.25, impl=impl)),
        "pitch": lambda: stretch(lambda x, impl: pitch_shift(x, 12.0, impl=impl)),
        "griffinlim": griffinlim,
    }


def profile(fn) -> dict:
    """One untraced and one traced run of ``fn`` after a warm-up run."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    untraced_ms = start.elapsed_time(end)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    return {
        "untraced_ms": untraced_ms, "traced_ms": traced_ms, "busy_ms": busy,
        "idle_traced": 1 - busy / traced_ms, "idle_untraced": 1 - busy / untraced_ms,
        "kernels": [{"name": n[:90], "ms": ms, "calls": c, "share": ms / busy} for n, ms, c in kernels[:12]],
    }


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profiling: no CUDA card visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    paths = _paths(dev)
    for name in argv or list(paths):
        audio_s, variants = paths[name]()
        for variant, fn in variants.items():
            row = profile(fn)
            row = {"path": name, "variant": variant, "card": card, "audio_s": audio_s,
                   "audio_s_per_s": audio_s / row["untraced_ms"] * 1e3, **row}
            print(json.dumps(row))
        del variants
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
