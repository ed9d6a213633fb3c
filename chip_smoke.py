"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's main path, the log-mel frontend
``log_mel_frontend(44100, 16000, 1024, 256, 128, center=False)`` streamed in
14,112-sample chunks over a 512 x 10 s tone batch, through the hand-written
CUDA kernel, and checks it. Phases, each printing its own line:

1. device: the ``nvidia-smi`` name and power-limit line;
2. build: the kernels built from ``audioflow_torch/csrc`` and the seconds taken;
3. kernel vs plain: each kernel against its plain torch version at the main
   path's step shape, with the tolerance stated below;
4. slice: the streamed frontend's shape, finiteness, launch count, and
   agreement with the plain two-node graph (Spectrogram + MelProject);
5. timing: the slice, kernel path and plain path, in audio-seconds per
   second, timed with CUDA events.

Then one JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``. There is no CPU path: without a card, or
without the package beside it, it exits non-zero and prints no result.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 512
RATE = 44100
SECONDS = 10.0
# kernel vs plain version on white noise: both fp32 with TF32 off, the sums
# taken in another order; 1e-4 in log-mel space (ln)
KERNEL_TOL = 1e-4
# whole slice vs the plain graph on the tone batch, from frame stream_latency
# on: the log turns the rounding of low-power mel bins (tens of dB below the
# tone) into larger absolute steps; the JAX package's own kernel-vs-XLA gate
# in log-mel space is 5e-3 (validate.py, melspec_pallas_vs_xla_logmel)
SLICE_TOL = 1e-3


def tone_batch(batch: int, seconds: float, rate: int, seed: int = 0) -> np.ndarray:
    """A copy of ``audioflow_tpu/bench.py::_tone_batch``: random tones plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate), dtype=np.float32) / rate
    freqs = rng.uniform(80, 4000, batch).astype(np.float32)
    x = 0.3 * np.sin(2 * np.pi * freqs[:, None] * t[None, :])
    x += 0.05 * rng.standard_normal((batch, t.size)).astype(np.float32)
    return x.astype(np.float32)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke test runs only on one", file=sys.stderr)
        return 1
    from audioflow_torch.models import log_mel_frontend
    from audioflow_torch.ops.kernels import _build, melspec
    from audioflow_torch.ops.mel import cached_filterbank
    from audioflow_torch.ops.stft import dft_banks
    from audioflow_torch.utils.cache import on_device

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    melspec.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("melspec", "").splitlines()
             if "registers" in ln or "spill" in ln]
    nvcc_s = _build.BUILD_SECONDS.get("melspec")
    built = f"nvcc {nvcc_s:.2f} s" if nvcc_s is not None else "already built in build/"
    print(f"phase 2 build: melspec ready in {build_s:.2f} s ({built}); " + " | ".join(ptxas))

    # phase 3: the kernel against its plain version at the stream step's shape
    # (768 carried + 5120 new samples at 16 kHz -> 20 frames per row)
    rng = np.random.default_rng(SEED)
    xs = torch.from_numpy(rng.standard_normal((BATCH, 5888)).astype(np.float32)).to(dev)
    cosb, sinb = dft_banks(1024, "hann", None, dev)
    fb = on_device(cached_filterbank(513, 128, 16000, 0.0, None, False, "slaney"), dev)
    got = melspec.mel_spectrogram(xs, cosb, sinb, fb, 256)
    want = melspec.mel_spectrogram_reference(xs, cosb, sinb, fb, 256)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (BATCH, 20, 128), f"shapes {got.shape}, {want.shape}")
    kernel_err = (got - want).abs().max().item()
    check(kernel_err <= KERNEL_TOL, f"kernel vs plain max|d| {kernel_err} > {KERNEL_TOL}")
    k_ms = cuda_ms(lambda: melspec.mel_spectrogram(xs, cosb, sinb, fb, 256), 20)
    p_ms = cuda_ms(lambda: melspec.mel_spectrogram_reference(xs, cosb, sinb, fb, 256), 20)
    print(f"phase 3 kernel vs plain at [{BATCH}, 5888] -> [{BATCH}, 20, 128]: max|d| {kernel_err:.3e} "
          f"(tol {KERNEL_TOL}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({card})")
    del xs, got, want

    # phase 4: the slice through the port's entry points
    graph = log_mel_frontend(RATE, 16000, 1024, 256, 128, center=False)
    plain = log_mel_frontend(RATE, 16000, 1024, 256, 128, center=False, fused=False)
    gran = graph.chunk_granularity()
    chunk = gran * max(1, 16384 // gran)
    x_np = tone_batch(BATCH, SECONDS, RATE, SEED)
    n_chunks = x_np.shape[-1] // chunk
    x = torch.from_numpy(x_np[:, : n_chunks * chunk]).to(dev)
    del x_np
    lat = graph.stream_latency(chunk)
    n_frames = n_chunks * graph.chunk_lens(chunk)[-1]

    melspec.COUNT.launches = 0
    y = graph.scan_stream(x, chunk)
    torch.cuda.synchronize()
    launches = melspec.COUNT.launches
    check(launches == n_chunks, f"melspec launched {launches} times for {n_chunks} chunks")
    check(tuple(y.shape) == (BATCH, n_frames, 128), f"slice output shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "non-finite log-mel values")
    y_plain = plain.scan_stream(x, chunk)
    slice_err = (y[:, lat:] - y_plain[:, lat:]).abs().max().item()
    check(slice_err <= SLICE_TOL, f"slice vs plain graph max|d| {slice_err} > {SLICE_TOL}")
    print(f"phase 4 slice: {BATCH} x {x.shape[-1]} samples, chunk {chunk} -> {tuple(y.shape)}, "
          f"finite, melspec launches {launches} = chunks {n_chunks}, vs plain graph from frame "
          f"{lat}: max|d| {slice_err:.3e} (tol {SLICE_TOL})")
    del y, y_plain

    # phase 5: timing, alternating plain and kernel paths
    audio_s = BATCH * x.shape[-1] / RATE
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        g = graph if name == "kernel" else plain
        times[name].append(cuda_ms(lambda g=g: g.scan_stream(x, chunk), 3, warmup=1))
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"phase 5 timing ({card}): slice {audio_s:.1f} audio-s per run; "
          f"kernel path {med['kernel']:.2f} ms = {audio_s / med['kernel'] * 1e3:.0f} audio-s/s, "
          f"plain path {med['plain']:.2f} ms = {audio_s / med['plain'] * 1e3:.0f} audio-s/s "
          f"(runs, ms: {json.dumps(times)})")

    print(json.dumps({"kernels": [{
        "name": "melspec", "route": "cuda", "source": "audioflow_torch/csrc/melspec.cu",
        "replaces": "audioflow_tpu/ops/pallas/melspec.py:137", "launches": launches,
        "max_abs_err": kernel_err, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
