"""Device-time breakdown of the port's paths on one CUDA card.

    python -m audioflow_torch.profiling [logmel] [pvoc] [pitch] [griffinlim] [pyin] [master] [streaming] [cqtroundtrip]

Each path runs in two or three variants at the JAX benchmark's sizes
(``audioflow_tpu/bench.py``, ``BENCHMARKS.md``): through the hand-written
kernel and through plain torch. For each variant it prints one JSON line:
the untraced run's time (CUDA events, after a warm-up run), the traced
run's wall time, the device's busy time under the trace (the sum of kernel
self times, one stream), the idle shares, the device launches, and the
kernels by device time with their calls. Without a card it exits non-zero
and prints no result.

* ``logmel``: ``log_mel_frontend(44100, 16000, 1024, 256, 128)`` streamed
  over 512 x 10 s in 14,112-sample chunks, fused (melspec kernel) vs the
  Spectrogram + MelProject graph;
* ``pvoc``: ``time_stretch(x, 1.25)`` on 64 x 10 s at 16 kHz,
  ``impl="pallas"`` (timestretch kernel) vs ``"matmul"`` (the DFT banks)
  and ``"fft"`` (the same path through cuFFT, variant ``cufft``);
* ``pitch``: ``pitch_shift(x, 12.0)`` on the same batch, all three impls;
* ``griffinlim``: ``griffin_lim(mag, n_iter=8)`` on the magnitude
  ``[64, 626, 513]`` of the same batch (n_fft 1024, hop 256), ``impl="auto"``
  (griffinlim kernel, one launch per iteration) vs ``"matmul"``;
* ``pyin``: ``pyin(x)`` with its defaults (65-2093 Hz, frame 2048, hop 256,
  0.1 semitone bins, 100 thresholds) on 64 x 10 s of the vibrato batch
  (:func:`vibrato_batch`), ``viterbi_impl="auto"`` (viterbi kernel, one
  launch) vs ``"xla"`` (the plain per-frame scan). Both variants share the
  candidate stage, plain torch with thousands of small launches;
* ``master``: BASELINE config 3, ``master_chain_graph(16000).compile()``
  (high-pass + 5-band EQ + limiter, plain torch) on 64 x 10 s at 16 kHz,
  ``chunked`` (the entry point: past 65,536 samples it streams 16,384-sample
  chunks) vs ``whole`` (``compile(chunked=False)``, one call per node);
* ``streaming``: BASELINE config 5,
  ``log_mel_frontend(44100, 16000, 1024, 256, 128, eq=eq_bands_default(16000))``
  streamed over 256 x 10 s in 14,112-sample chunks (melspec kernel) vs the
  JAX benchmark's composition ``Resample -> BiquadChain -> Spectrogram ->
  MelProject`` (plain torch);
* ``cqtroundtrip``: the CQT round trip of ``audioflow run -g cqtroundtrip``
  on a batch of 32 x 10 s at 44.1 kHz (84 bins from C1, hop 256; no
  kernel): ``hybrid`` (``cqt(output="complex")`` then ``icqt``, the hybrid
  inverse) and its stages ``forward`` (the CQT), ``dual_conv`` (the
  inverse's dual-branch conv) and ``sin_estimates`` (its sinusoid
  estimates), and ``multirate`` (``cqt(multirate=True)`` then ``icqt``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


def tone_batch(batch: int, seconds: float, rate: int, seed: int = 0) -> np.ndarray:
    """The bench's input (``audioflow_tpu/bench.py::_tone_batch``): random tones plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate), dtype=np.float32) / rate
    freqs = rng.uniform(80, 4000, batch).astype(np.float32)
    x = 0.3 * np.sin(2 * np.pi * freqs[:, None] * t[None, :])
    x += 0.05 * rng.standard_normal((batch, t.size)).astype(np.float32)
    return x.astype(np.float32)


def vibrato_batch(batch: int = 64, seconds: float = 10.0, rate: int = 16000, seed: int = 0) -> np.ndarray:
    """A copy of the JAX package's pYIN benchmark input
    (``scripts/chip_r5_pyin2.py:31-47``): one row of a 110 Hz tone swept by
    +-80 Hz at 0.3 Hz plus noise, repeated ``batch`` times."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    x = (0.4 * np.sin(2 * np.pi * (110 + 80 * np.sin(2 * np.pi * 0.3 * t)) * t)
         + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    return np.broadcast_to(x, (batch, x.shape[0])).copy()


def _paths(dev):
    """name -> (audio seconds, {variant: fn}), built lazily per path."""
    from .graph import BiquadChain, MelProject, Resample, Spectrogram, chain
    from .models import eq_bands_default, log_mel_frontend, master_chain_graph
    from .ops import griffin_lim, pitch_shift, pyin, stft, time_stretch

    def logmel():
        chunk = 14112
        x = torch.from_numpy(tone_batch(512, 10.0, 44100)[:, : 31 * chunk]).to(dev)
        graphs = {v: log_mel_frontend(44100, 16000, 1024, 256, 128, fused=v == "kernel")
                  for v in ("kernel", "plain")}
        return 512 * x.shape[-1] / 44100, {v: (lambda g=g: g.scan_stream(x, chunk)) for v, g in graphs.items()}

    def stretch(fn):
        x = torch.from_numpy(tone_batch(64, 10.0, 16000)).to(dev)
        return 640.0, {"kernel": lambda: fn(x, "pallas"), "plain": lambda: fn(x, "matmul"),
                       "cufft": lambda: fn(x, "fft")}

    def griffinlim():
        x = torch.from_numpy(tone_batch(64, 10.0, 16000)).to(dev)
        mag = stft(x, 1024, 256).abs()
        t = x.shape[-1]
        return 640.0, {"kernel": lambda: griffin_lim(mag, n_iter=8, length=t),
                       "plain": lambda: griffin_lim(mag, n_iter=8, length=t, impl="matmul")}

    def pyin_path():
        x = torch.from_numpy(vibrato_batch()).to(dev)
        return 640.0, {"kernel": lambda: pyin(x, 16000), "scan": lambda: pyin(x, 16000, viterbi_impl="xla")}

    def master():
        x = torch.from_numpy(tone_batch(64, 10.0, 16000)).to(dev)
        chunked, whole = master_chain_graph(16000).compile(), master_chain_graph(16000).compile(chunked=False)
        return 640.0, {"chunked": lambda: chunked(x), "whole": lambda: whole(x)}

    def streaming():
        chunk = 14112
        x = torch.from_numpy(tone_batch(256, 10.0, 44100)[:, : 31 * chunk]).to(dev)
        eq = eq_bands_default(16000.0)
        graphs = {
            "kernel": log_mel_frontend(44100, 16000, 1024, 256, 128, eq=eq),
            "plain": chain(Resample(44100, 16000, "kaiser"), BiquadChain(eq), Spectrogram(1024, 256, center=False),
                           MelProject(n_mels=128), input_rate=44100),
        }
        return 256 * x.shape[-1] / 44100, {v: (lambda g=g: g.scan_stream(x, chunk)) for v, g in graphs.items()}

    def cqtroundtrip():
        from .ops import cqt, cqt_mod, icqt

        x = torch.from_numpy(tone_batch(32, 10.0, 44100)).to(dev)
        x = torch.nn.functional.pad(x, (0, -x.shape[-1] % 1024))
        t = x.shape[-1]
        c = cqt(x, 44100, output="complex")
        dz = cqt_mod._hybrid_design(44100, 256, 84, cqt_mod.FMIN_C1, 12, "hann", 1.0)
        ri = torch.cat([c.real[..., : dz["k_dual"]], c.imag[..., : dz["k_dual"]]], dim=-1)
        return 32 * t / 44100, {
            "hybrid": lambda: icqt(cqt(x, 44100, output="complex"), 44100, length=t),
            "forward": lambda: cqt(x, 44100, output="complex"),
            "dual_conv": lambda: cqt_mod._feature_conv(ri, dz["kern"]),
            "sin_estimates": lambda: cqt_mod._sin_estimates(c.real, c.imag, dz, 44100, 256),
            "multirate": lambda: icqt(cqt(x, 44100, multirate=True, output="complex")),
        }

    return {
        "logmel": logmel,
        "pvoc": lambda: stretch(lambda x, impl: time_stretch(x, 1.25, impl=impl)),
        "pitch": lambda: stretch(lambda x, impl: pitch_shift(x, 12.0, impl=impl)),
        "griffinlim": griffinlim,
        "pyin": pyin_path,
        "master": master,
        "streaming": streaming,
        "cqtroundtrip": cqtroundtrip,
    }


def count_flops(fn) -> float:
    """The floating-point operations of one call of ``fn`` that
    ``torch.utils.flop_counter.FlopCounterMode`` counts: matmuls and
    convolutions (elementwise work, FFTs and a hand-written kernel's work
    are not seen)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def aten_ops(fn) -> int:
    """The aten ops that one call of ``fn`` runs, views and reshapes left
    out, counted exactly by a dispatch mode on any device: the count of its
    launches that the profiler's traces, which drop events on the H100, do
    not give reliably."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func is not torch.ops.aten._unsafe_view.default:
                self.n += 1
            return func(*args, **(kwargs or {}))

    with CountOps() as ops:
        fn()
    return ops.n


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
        "launches": sum(k[2] for k in kernels),
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
