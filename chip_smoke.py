"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's three ported paths through the hand-written CUDA kernels
and checks them. The log-mel frontend
``log_mel_frontend(44100, 16000, 1024, 256, 128, center=False)`` streamed in
14,112-sample chunks over a 512 x 10 s tone batch (kernel ``melspec``);
BASELINE config 4, time-stretch and pitch-shift, offline through
``Graph.compile()`` on a 64 x 10 s 16 kHz tone batch (kernel
``timestretch``); and Griffin-Lim phase reconstruction with the mel/MFCC
inversion built on it, on the magnitude ``[64, 626, 513]`` of that batch
(n_fft 1024, hop 256; kernel ``griffinlim``). Phases, each printing its own
line:

1. device: the ``nvidia-smi`` name and power-limit line;
2. build: the three kernels built from ``audioflow_torch/csrc``, one nvcc
   per source started together, with the seconds taken and ptxas's
   registers and spills;
3. melspec kernel vs plain at the main path's step shape;
4. melspec slice: shape, finiteness, launch count, and agreement with the
   plain two-node graph (Spectrogram + MelProject);
5. melspec timing: the slice, kernel path and plain path, in audio-seconds
   per second, timed with CUDA events;
6. timestretch kernel vs plain: at the ``pvoc`` shape (rate 1.25), at the
   ``pitch`` stretch's (rate 0.5, all 64 rows), and at rates 0.8, 2/3 and
   2.0 on 8 rows, every sample;
7. time-stretch slice: the ``TimeStretch(1.25)`` and ``PitchShift(12.0)``
   graphs (one launch each), the kernel-vs-matmul gate of the JAX
   package's validate, and the pitch-doubling probe;
8. time-stretch timing: ``time_stretch`` and ``pitch_shift`` on the kernel
   path and the matmul path, and the kernel per call against its plain
   version and its bound;
9. griffinlim kernel vs plain at ``[64, 626, 513]``: one projection
   elementwise, 8 iterations by spectral convergence, the true-phase
   oracle, and the ms per iteration of both against the bound;
10. Griffin-Lim slice, launches counted from 0: ``griffin_lim(mag,
    n_iter=8)`` (8 launches), the ``Spectrogram(power=False)`` ->
    ``GriffinLim(n_iter=8)`` graph on numpy input (8), ``mel_to_audio`` at
    128 mels with its defaults (32) recovering a 440 Hz row, and the JAX
    package's ``griffinlim_tone_err`` gate (16);
11. Griffin-Lim timing: ``griffin_lim`` (8 iterations) and ``mel_to_audio``
    on the kernel path and the matmul path.

Then one JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``. There is no CPU path: without a card, or
without the package beside it, it exits non-zero and prints no result.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
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
# time stretch: 64 x 10 s at 16 kHz (audioflow_tpu/bench.py pvoc and pitch)
PVOC_BATCH = 64
PVOC_RATE = 16000
# kernel vs plain version, max|d| / max|plain| over every sample: fp32 sums
# in another order, carried through the phase product
STRETCH_TOL = 1e-4
# kernel path vs matmul path on a 1 s tone + noise over all but the last
# 1024 samples: the JAX package's validate gate (pvoc_pallas_vs_xla_rel);
# the two phase forms accumulate in different orders, and the tail frame
# follows different conventions
PVOC_GATE = 6e-3
# griffinlim kernel vs plain version, one projection, max|d| / max|plain|:
# linear in the magnitude, fp32 sums in another order
GL_TOL = 1e-5
# 8 iterations: spectral convergence of kernel and plain within this of each
# other (elementwise comparison is meaningless past the first magnitude
# replacement, which turns rounding at weak bins into O(1) phase steps)
GL_SC_TOL = 0.02
# true-phase oracle: reconstruction error over the interior, of the peak
GL_ORACLE_TOL = 1e-3
# the JAX package's validate gate (griffinlim_tone_err), and its tone test
GL_TONE_GATE = 0.2
PEAK_HZ_TOL = 8.0
# the card's published peaks (H100 SXM data sheet): fp32 outside the tensor
# cores, and device memory
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


def rfft_flops(n: int) -> float:
    """Operations of one real FFT of ``n`` points: half a complex FFT's
    5·n·log2(n). The bounds count the function's FFTs, not the dense DFT
    products that the kernels compute."""
    return 2.5 * n * math.log2(n)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    t_ops, t_mem = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


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
    from audioflow_torch.graph import GriffinLim, Graph, PitchShift, Spectrogram, TimeStretch
    from audioflow_torch.models import log_mel_frontend
    from audioflow_torch.ops import (
        apply_mel, griffin_lim, mel_filterbank, mel_to_audio, mel_to_stft, pitch_shift, power, stft,
        time_stretch,
    )
    from audioflow_torch.ops.kernels import _build, griffinlim, melspec, timestretch
    from audioflow_torch.ops.mel import cached_filterbank
    from audioflow_torch.ops.stft import dft_banks
    from audioflow_torch.profiling import tone_batch
    from audioflow_torch.utils.cache import on_device

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # phase 2: one nvcc per source, started together
    kernels = {"melspec": melspec, "timestretch": timestretch, "griffinlim": griffinlim}
    t0 = time.perf_counter()
    _build.build(*kernels)
    for k in kernels.values():
        k.build()
    build_s = time.perf_counter() - t0
    for name in kernels:
        ptxas = [ln.strip() for ln in _build.BUILD_LOG.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        nvcc_s = _build.BUILD_SECONDS.get(name)
        built = f"nvcc {nvcc_s:.2f} s" if nvcc_s is not None else "already built in build/"
        print(f"phase 2 build: {name} ({built}); " + " | ".join(ptxas))
    print(f"phase 2 build: {len(kernels)} kernels ready in {build_s:.2f} s")

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

    # per frame: window, rFFT, power, mel projection, floor and log
    n_fft, n_bins, n_mels = 1024, 513, 128
    ms_flops = BATCH * 20 * (n_fft + rfft_flops(n_fft) + 3 * n_bins + 2 * n_bins * n_mels + 2 * n_mels)
    ms_work = BATCH * 20 * (4 * n_fft * n_bins + 3 * n_bins + 2 * n_bins * n_mels + 2 * n_mels)
    ms_bound, ms_by = bound_ms(
        ms_flops, 4 * (BATCH * 5888 + 2 * n_fft * n_bins + n_bins * n_mels + BATCH * 20 * n_mels),
    )
    del x

    # phase 6: the time-stretch kernel against its plain version
    x_np = tone_batch(PVOC_BATCH, SECONDS, PVOC_RATE, SEED)
    x = torch.from_numpy(x_np).to(dev)
    t = x.shape[-1]

    def stretch_err(xs, rate):
        before = timestretch.COUNT.launches
        got = timestretch.time_stretch_fused(xs, rate)
        torch.cuda.synchronize()
        check(timestretch.COUNT.launches == before + 1, "timestretch: one launch per call")
        want = timestretch.time_stretch_reference(xs, rate)
        check(got.shape == want.shape == (xs.shape[0], round(xs.shape[-1] / rate)), f"shapes {got.shape}")
        err = (got - want).abs().max().item()
        return err, err / want.abs().max().item()

    ts_err, ts_rel = stretch_err(x, 1.25)
    check(ts_rel <= STRETCH_TOL, f"timestretch vs plain at rate 1.25: rel {ts_rel} > {STRETCH_TOL}")
    half_rel = stretch_err(x, 0.5)[1]  # the PitchShift(12.0) path's shape
    check(half_rel <= STRETCH_TOL, f"timestretch vs plain at rate 0.5: rel {half_rel} > {STRETCH_TOL}")
    rels = {}
    for rate in (0.8, 2.0 / 3.0, 0.5, 2.0):
        rels[f"{rate:.4f}"] = stretch_err(x[:8].contiguous(), rate)[1]
        check(rels[f"{rate:.4f}"] <= STRETCH_TOL, f"timestretch vs plain at rate {rate}: {rels}")
    ts_ms = cuda_ms(lambda: timestretch.time_stretch_fused(x, 1.25), 10)
    tp_ms = cuda_ms(lambda: timestretch.time_stretch_reference(x, 1.25), 3, warmup=1)
    # per input frame: window, rFFT, magnitude and unit increment phasor
    # (14 per bin); per output frame: magnitude interpolation, phase
    # product, renormalisation and scaling (18 per bin), inverse rFFT,
    # synthesis window and overlap-add; per output sample, the WOLA divide
    plan = timestretch.make_plan(t, 1.25, n_fft, 256)
    ts_flops = PVOC_BATCH * (
        plan.n_in * (n_fft + rfft_flops(n_fft) + 14 * n_bins)
        + plan.n_out * (18 * n_bins + rfft_flops(n_fft) + 2 * n_fft) + plan.out_len
    )
    ts_work = PVOC_BATCH * 4 * n_fft * n_bins * (plan.n_in + plan.n_out)  # the kernel's dense DFTs
    ts_bound, ts_by = bound_ms(ts_flops, 4 * PVOC_BATCH * (t + plan.out_len))
    print(f"phase 6 timestretch vs plain at [{PVOC_BATCH}, {t}] rate 1.25: max|d| {ts_err:.3e}, "
          f"rel {ts_rel:.3e}; rate 0.5 on all rows: rel {half_rel:.3e}; on 8 rows at other rates: "
          f"rel {json.dumps(rels)} (tol {STRETCH_TOL}); kernel {ts_ms:.4f} ms, plain {tp_ms:.4f} ms, "
          f"bound {ts_bound:.4f} ms ({ts_by}: {ts_flops / 1e9:.3f} GFLOP with FFTs; the kernel's dense "
          f"DFTs are {ts_work / 1e9:.1f} GFLOP, run at {ts_work / ts_ms / 1e9:.1f} TFLOP/s; "
          f"{plan.n_in} input, {plan.n_out} output frames) ({card})")

    # phase 7: the slice through the graph, counted from 0
    stretch = Graph((TimeStretch(1.25),), input_rate=PVOC_RATE).compile()
    pitch = Graph((PitchShift(12.0),), input_rate=PVOC_RATE).compile()
    timestretch.COUNT.launches = 0
    y = stretch(x_np)  # numpy input goes to the card
    torch.cuda.synchronize()
    check(timestretch.COUNT.launches == 1, f"TimeStretch launched {timestretch.COUNT.launches} times")
    check(tuple(y.shape) == (PVOC_BATCH, 128000) and y.device.type == "cuda", f"stretch {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "non-finite stretched samples")
    y = pitch(x)
    torch.cuda.synchronize()
    ts_launches = timestretch.COUNT.launches
    check(ts_launches == 2, f"PitchShift launched {ts_launches - 1} times")
    check(tuple(y.shape) == (PVOC_BATCH, t), f"pitch output shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "non-finite pitch-shifted samples")
    rng = np.random.default_rng(SEED)
    tt = np.arange(PVOC_RATE) / PVOC_RATE
    xs = (0.4 * np.sin(2 * np.pi * 440.0 * tt)).astype(np.float32)
    xs += 0.05 * rng.standard_normal(PVOC_RATE).astype(np.float32)
    got = time_stretch(xs, 1.25, impl="pallas").cpu().numpy()
    ref = time_stretch(xs, 1.25, impl="matmul").cpu().numpy()
    n = ref.shape[-1] - 1024
    gate = float(np.abs(ref[:n] - got[:n]).max() / np.abs(ref).max())
    check(gate < PVOC_GATE, f"kernel vs matmul path rel {gate} >= {PVOC_GATE}")
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * tt)).astype(np.float32)
    shifted = pitch(tone).cpu().numpy()
    peak_hz = float(np.argmax(np.abs(np.fft.rfft(shifted * np.hanning(shifted.size))))) * PVOC_RATE / shifted.size
    check(abs(peak_hz - 880.0) <= PVOC_RATE / shifted.size, f"pitch +12 of 440 Hz peaks at {peak_hz} Hz")
    print(f"phase 7 slice: TimeStretch(1.25) {PVOC_BATCH} x {t} -> ({PVOC_BATCH}, 128000), "
          f"PitchShift(12.0) -> {tuple(y.shape)}, finite, timestretch launches {ts_launches} for 2 "
          f"calls; kernel vs matmul path on 1 s 440 Hz + noise: rel {gate:.3e} (gate {PVOC_GATE}); "
          f"440 Hz shifted +12 peaks at {peak_hz:.1f} Hz")
    del y

    # phase 8: timing, alternating the matmul and kernel paths
    audio_s = PVOC_BATCH * t / PVOC_RATE
    runs = {
        "time_stretch": lambda impl: time_stretch(x, 1.25, impl=impl),
        "pitch_shift": lambda impl: pitch_shift(x, 12.0, impl=impl),
    }
    for name, fn in runs.items():
        times = {"pallas": [], "matmul": []}
        for impl in ("matmul", "pallas", "pallas", "matmul", "matmul", "pallas"):
            times[impl].append(cuda_ms(lambda impl=impl: fn(impl), 3, warmup=1))
        med = {k: float(np.median(v)) for k, v in times.items()}
        print(f"phase 8 timing ({card}): {name} {audio_s:.1f} audio-s per run; kernel path "
              f"{med['pallas']:.3f} ms = {audio_s / med['pallas'] * 1e3:.0f} audio-s/s, matmul path "
              f"{med['matmul']:.3f} ms = {audio_s / med['matmul'] * 1e3:.0f} audio-s/s "
              f"(runs, ms: {json.dumps(times)})")
    print(f"phase 8 kernels ({card}): melspec {k_ms:.4f} ms vs plain {p_ms:.4f} ms, bound "
          f"{ms_bound:.4f} ms ({ms_by}: {ms_flops / 1e9:.3f} GFLOP with an rFFT; the kernel's dense DFT "
          f"{ms_work / 1e9:.2f} GFLOP at {ms_work / k_ms / 1e9:.1f} TFLOP/s); timestretch {ts_ms:.4f} ms "
          f"vs plain {tp_ms:.4f} ms, bound {ts_bound:.4f} ms ({ts_by})")

    # phase 9: the griffinlim kernel against its plain version at full width
    spec = stft(x, n_fft, 256)
    mag = spec.abs().contiguous()
    n_frames = mag.shape[1]
    check(tuple(mag.shape) == (PVOC_BATCH, 626, n_bins), f"magnitude shape {tuple(mag.shape)}")
    zeros = torch.zeros_like(mag)
    gd = griffinlim.designs(n_fft, 256, "hann", n_frames, dev)
    got = griffinlim.griffin_lim_iteration(mag, zeros, mag, zeros, mag, 0.0)
    want = griffinlim.griffin_lim_iteration_reference(mag, zeros, mag, zeros, mag, 0.0, *gd)
    torch.cuda.synchronize()
    gl_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    gl_rel = gl_err / max(w.abs().max().item() for w in want)
    check(gl_rel <= GL_TOL, f"griffinlim projection vs plain: rel {gl_rel} > {GL_TOL}")
    del got, want

    def specconv(y):
        m2 = stft(y, n_fft, 256).abs()[..., :n_frames, :]
        return (torch.linalg.norm(m2 - mag) / torch.linalg.norm(mag)).item()

    sc_k = specconv(griffinlim.griffin_lim_fused(mag, n_iter=8, length=t))
    sc_p = specconv(griffinlim.griffin_lim_reference(mag, n_iter=8, length=t))
    check(abs(sc_k - sc_p) <= GL_SC_TOL, f"griffinlim 8 iterations: spectral convergence {sc_k} vs plain {sc_p}")
    y = griffinlim.griffin_lim_fused(mag, n_iter=2, init_phase=spec.angle(), length=t)
    oracle = ((y - x)[:, 2048:-2048].abs().max() / x.abs().max()).item()
    check(oracle < GL_ORACLE_TOL, f"griffinlim true-phase oracle {oracle} >= {GL_ORACLE_TOL}")
    del spec, y
    gk_ms = cuda_ms(lambda: griffinlim.griffin_lim_iteration(mag, zeros, mag, zeros, mag, 0.99), 10)
    gp_ms = cuda_ms(lambda: griffinlim.griffin_lim_iteration_reference(mag, zeros, mag, zeros, mag, 0.99, *gd), 10)
    # one iteration, per frame: the prologue (15 per bin: momentum, |a|, the
    # guard, two divides and two products), the inverse rFFT, the synthesis
    # window and overlap-add, the analysis window and the forward rFFT; per
    # row sample, the WOLA inverse. Bytes: 5 state planes in, 2 out, the four
    # banks and the row inverse
    n_rows = n_frames + n_fft // 256 - 1
    gl_flops = PVOC_BATCH * (n_frames * (2 * rfft_flops(n_fft) + 15 * n_bins + 3 * n_fft) + n_rows * 256)
    gl_bytes = 4 * (7 * PVOC_BATCH * n_frames * n_bins + 4 * n_fft * n_bins + n_rows * 256)
    gl_work = PVOC_BATCH * n_frames * 8 * n_fft * n_bins  # the kernel's dense DFTs
    gl_bound, gl_by = bound_ms(gl_flops, gl_bytes)
    print(f"phase 9 griffinlim vs plain at {list(mag.shape)}: one projection max|d| {gl_err:.3e}, rel "
          f"{gl_rel:.3e} (tol {GL_TOL}); 8 iterations spectral convergence kernel {sc_k:.5f} vs plain "
          f"{sc_p:.5f} (tol {GL_SC_TOL}); true-phase oracle {oracle:.3e} (tol {GL_ORACLE_TOL}); kernel "
          f"{gk_ms:.4f} ms per iteration, plain {gp_ms:.4f} ms, bound {gl_bound:.4f} ms ({gl_by}: "
          f"{gl_bytes / 1e6:.1f} MB, {gl_flops / 1e9:.3f} GFLOP with FFTs; the kernel's dense DFTs are "
          f"{gl_work / 1e9:.1f} GFLOP, run at {gl_work / gk_ms / 1e9:.1f} TFLOP/s) ({card})")

    # phase 10: the Griffin-Lim slice through the port's entry points, counted from 0
    fb = mel_filterbank(n_bins, 128, PVOC_RATE)
    tone_np = x_np.copy()
    tone_np[0] = 0.5 * np.sin(2 * np.pi * 440.0 * np.arange(t) / PVOC_RATE)
    mel = apply_mel(power(stft(torch.from_numpy(tone_np).to(dev), n_fft, 256)), fb)
    gl_graph = Graph((Spectrogram(power=False), GriffinLim(n_iter=8)), input_rate=PVOC_RATE).compile()
    griffinlim.COUNT.launches = 0
    y = griffin_lim(mag, n_iter=8, length=t)
    torch.cuda.synchronize()
    counts = [griffinlim.COUNT.launches]
    check(counts[0] == 8, f"griffin_lim(n_iter=8) launched {counts[0]} times")
    check(tuple(y.shape) == (PVOC_BATCH, t) and bool(torch.isfinite(y).all()), f"griffin_lim {tuple(y.shape)}")
    y = gl_graph(x_np)  # numpy input goes to the card
    torch.cuda.synchronize()
    counts.append(griffinlim.COUNT.launches - sum(counts))
    check(counts[1] == 8, f"the GriffinLim graph launched {counts[1]} times")
    check(tuple(y.shape) == (PVOC_BATCH, n_frames * 256) and y.device.type == "cuda"
          and bool(torch.isfinite(y).all()), f"GriffinLim graph {tuple(y.shape)}")
    y = mel_to_audio(mel, fb, length=t)
    torch.cuda.synchronize()
    counts.append(griffinlim.COUNT.launches - sum(counts))
    check(counts[2] == 32, f"mel_to_audio launched {counts[2]} times")
    check(tuple(y.shape) == (PVOC_BATCH, t) and bool(torch.isfinite(y).all()), f"mel_to_audio {tuple(y.shape)}")
    mid = y[0, 16000:144000].cpu().numpy()
    sp = np.abs(np.fft.rfft(mid * np.hanning(mid.size)))
    peak_hz = float(np.fft.rfftfreq(mid.size, 1 / PVOC_RATE)[sp.argmax()])
    check(abs(peak_hz - 440.0) < PEAK_HZ_TOL, f"mel_to_audio of 440 Hz peaks at {peak_hz} Hz")
    tone = torch.from_numpy(tone_np[0, :PVOC_RATE]).to(dev)
    mg = stft(tone, n_fft, 256).abs()
    rec = stft(griffin_lim(mg, n_fft, 256, n_iter=16), n_fft, 256).abs()
    counts.append(griffinlim.COUNT.launches - sum(counts))
    check(counts[3] == 16, f"griffinlim_tone_err's griffin_lim launched {counts[3]} times")
    fg = min(rec.shape[0], mg.shape[0])
    tone_err = (torch.linalg.norm(rec[:fg] - mg[:fg]) / torch.linalg.norm(mg)).item()
    check(tone_err < GL_TONE_GATE, f"griffinlim_tone_err {tone_err} >= {GL_TONE_GATE}")
    gl_launches = griffinlim.COUNT.launches
    print(f"phase 10 slice: griffin_lim(n_iter=8) on {list(mag.shape)} -> ({PVOC_BATCH}, {t}), the "
          f"Spectrogram -> GriffinLim graph -> ({PVOC_BATCH}, {n_frames * 256}), mel_to_audio -> "
          f"({PVOC_BATCH}, {t}), all finite; griffinlim launches {counts} = {gl_launches}; mel_to_audio "
          f"of 440 Hz peaks at {peak_hz:.3f} Hz; griffinlim_tone_err {tone_err:.4f} (gate {GL_TONE_GATE})")
    del y

    # phase 11: timing, alternating the matmul and kernel paths
    runs = {
        "griffin_lim": lambda impl: griffin_lim(mag, n_iter=8, length=t, impl=impl),
        # the matmul form composes mel_to_audio's own steps: it has no impl switch
        "mel_to_audio": lambda impl: mel_to_audio(mel, fb, length=t) if impl == "pallas" else griffin_lim(
            torch.sqrt(torch.clamp_min(mel_to_stft(mel, fb), 0.0)), length=t, impl="matmul"),
    }
    for name, fn in runs.items():
        times = {"pallas": [], "matmul": []}
        for impl in ("matmul", "pallas", "pallas", "matmul", "matmul", "pallas"):
            times[impl].append(cuda_ms(lambda impl=impl: fn(impl), 3, warmup=1))
        med = {k: float(np.median(v)) for k, v in times.items()}
        print(f"phase 11 timing ({card}): {name} {audio_s:.1f} audio-s per run; kernel path "
              f"{med['pallas']:.3f} ms = {audio_s / med['pallas'] * 1e3:.0f} audio-s/s, matmul path "
              f"{med['matmul']:.3f} ms = {audio_s / med['matmul'] * 1e3:.0f} audio-s/s "
              f"(runs, ms: {json.dumps(times)})")

    print(json.dumps({"kernels": [
        {
            "name": "melspec", "route": "cuda", "source": "audioflow_torch/csrc/melspec.cu",
            "replaces": "audioflow_tpu/ops/pallas/melspec.py:137", "launches": launches,
            "max_abs_err": kernel_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": ms_bound, "bound_by": ms_by, "library_ms": None,
        },
        {
            "name": "timestretch", "route": "cuda", "source": "audioflow_torch/csrc/timestretch.cu",
            "replaces": "audioflow_tpu/ops/pallas/timestretch.py:358", "launches": ts_launches,
            "max_abs_err": ts_err, "ms": ts_ms, "plain_ms": tp_ms,
            "bound_ms": ts_bound, "bound_by": ts_by, "library_ms": None,
        },
        {
            "name": "griffinlim", "route": "cuda", "source": "audioflow_torch/csrc/griffinlim.cu",
            "replaces": "audioflow_tpu/ops/pallas/griffinlim.py:216", "launches": gl_launches,
            "max_abs_err": gl_err, "ms": gk_ms, "plain_ms": gp_ms,
            "bound_ms": gl_bound, "bound_by": gl_by, "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
