"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's four ported paths through the hand-written CUDA kernels
and checks them. The log-mel frontend
``log_mel_frontend(44100, 16000, 1024, 256, 128, center=False)`` streamed in
14,112-sample chunks over a 512 x 10 s tone batch (kernel ``melspec``);
BASELINE config 4, time-stretch and pitch-shift, offline through
``Graph.compile()`` on a 64 x 10 s 16 kHz tone batch (kernel
``timestretch``); and Griffin-Lim phase reconstruction with the mel/MFCC
inversion built on it, on the magnitude ``[64, 626, 513]`` of that batch
(n_fft 1024, hop 256; kernel ``griffinlim``); and pYIN pitch tracking with
its defaults (65-2093 Hz, frame 2048, hop 256, 0.1 semitone bins, 100
thresholds: 626 frames, 602 bins, a 139-tap band) on the JAX package's pYIN
benchmark batch, 64 x 10 s of a vibrato tone at 16 kHz (kernel
``viterbi``). Phases, each printing its own line:

1. device: the ``nvidia-smi`` name and power-limit line;
2. build: the four kernels built from ``audioflow_torch/csrc``, one nvcc
   per source started together, with the seconds taken and ptxas's
   registers and spills;
3. melspec kernel vs plain at the main path's step shape, with the path it
   took (checked to be ``fft``), its dense path at n_fft 400, hop 160 on 8
   rows, and the same function composed from ``torch.fft.rfft`` (cuFFT)
   and plain torch timed beside it as a yardstick; the three timed by their
   device time under torch.profiler, as in phase 9;
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
9. griffinlim kernel vs plain at ``[64, 626, 513]``: the path it took
   (checked to be ``fft``), one projection elementwise, its dense path at
   n_fft 501, hop 167 on 8 rows, two launches on the same input bitwise
   equal, 8 iterations by spectral convergence, the true-phase oracle, and
   the ms per iteration of kernel, plain version and a cuFFT composition
   (``torch.fft.irfft``/``rfft`` and plain torch) against the bound;
10. Griffin-Lim slice, launches counted from 0: ``griffin_lim(mag,
    n_iter=8)`` (8 launches), the ``Spectrogram(power=False)`` ->
    ``GriffinLim(n_iter=8)`` graph on numpy input (8), ``mel_to_audio`` at
    128 mels with its defaults (32) recovering a 440 Hz row, and the JAX
    package's ``griffinlim_tone_err`` gate (16);
11. Griffin-Lim timing: ``griffin_lim`` (8 iterations) and ``mel_to_audio``
    on the kernel path and the matmul path;
12. viterbi kernel vs plain: the log observations ``[64, 626, 602]`` of the
    pYIN batch computed once on the card, the kernel's ``dv``, ``du``,
    ``off`` and ``pick`` exactly equal to the plain version's, and on a
    tie-heavy synthetic case at 255 taps; ms per call of both against the
    bound;
13. pYIN slice, launches counted from 0: ``pyin(x)`` on numpy input (1
    launch), the plain scan (``viterbi_impl="xla"``) decoding the same f0
    and voicing, the ``Pyin`` node through ``Graph.compile()`` (1 launch),
    and the JAX package's ``pyin_220_rel`` (1 launch) and ``yin_220_rel``
    gates;
14. pYIN timing: ``pyin`` through the kernel and through the plain scan,
    alternated, and ``yin`` on the same batch, in audio-seconds per second.

Then one JSON line of per-kernel numbers (with ``path`` and ``cufft_ms``
for the two kernels built on the shared-memory FFT), and last
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
# pYIN (BENCHMARKS.md "pyin (defaults: 0.1 st, 100 thresholds)"): 64 x 10 s
PYIN_BATCH = 64
# the JAX package's validate gates pyin_220_rel and yin_220_rel
PITCH_GATE = 5e-3
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


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn``: the self times of its
    kernels under torch.profiler, summed. Unlike :func:`cuda_ms` it does not
    count the card's idle gaps, so a kernel shorter than its wrapper's host
    work is timed by the card, not by the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke test runs only on one", file=sys.stderr)
        return 1
    from audioflow_torch.graph import GriffinLim, Graph, PitchShift, Pyin, Spectrogram, TimeStretch
    from audioflow_torch.models import log_mel_frontend
    from audioflow_torch.ops import (
        apply_mel, frame, griffin_lim, mel_filterbank, mel_to_audio, mel_to_stft, pitch_shift, power, pyin,
        stft, time_stretch, yin,
    )
    from audioflow_torch.ops import pitch as pitch_ops
    from audioflow_torch.ops.kernels import _build, griffinlim, melspec, timestretch, viterbi
    from audioflow_torch.ops.framing import overlap_add
    from audioflow_torch.ops.mel import cached_filterbank, floor_log
    from audioflow_torch.ops.stft import dft_banks, pad_center, padded_window
    from audioflow_torch.profiling import tone_batch, vibrato_batch
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
    kernels = {"melspec": melspec, "timestretch": timestretch, "griffinlim": griffinlim, "viterbi": viterbi}
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
    win = on_device(padded_window(1024, "hann"), dev)
    fb = on_device(cached_filterbank(513, 128, 16000, 0.0, None, False, "slaney"), dev)
    ms_path = melspec.kernel_path(1024)
    check(ms_path == "fft", f"melspec takes the {ms_path} path at n_fft 1024")
    got = melspec.mel_spectrogram(xs, cosb, sinb, win, fb, 256)
    want = melspec.mel_spectrogram_reference(xs, cosb, sinb, fb, 256)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (BATCH, 20, 128), f"shapes {got.shape}, {want.shape}")
    kernel_err = (got - want).abs().max().item()
    check(kernel_err <= KERNEL_TOL, f"kernel vs plain max|d| {kernel_err} > {KERNEL_TOL}")
    # the dense path at Whisper's and Kaldi's n_fft 400, hop 160, on 8 rows
    xd = xs[:8].contiguous()
    dense_args = (*dft_banks(400, "hann", None, dev), on_device(padded_window(400, "hann"), dev),
                  on_device(cached_filterbank(201, 80, 16000, 0.0, None, False, "slaney"), dev))
    check(melspec.kernel_path(400) == "dense", "melspec at n_fft 400 does not take the dense path")
    dense_err = (melspec.mel_spectrogram(xd, *dense_args, 160)
                 - melspec.mel_spectrogram_reference(xd, *dense_args[:2], dense_args[3], 160)).abs().max().item()
    check(dense_err <= KERNEL_TOL, f"dense melspec vs plain max|d| {dense_err} > {KERNEL_TOL}")

    def mel_cufft():  # the same function from cuFFT and plain torch: a yardstick the port never calls
        spec = torch.fft.rfft(xs.unfold(-1, 1024, 256) * win)
        return floor_log(torch.matmul(spec.real * spec.real + spec.imag * spec.imag, fb), 1e-10, "ln")

    cufft_err = (mel_cufft() - want).abs().max().item()
    kc_err = (got - mel_cufft()).abs().max().item()
    # device time: at about 0.05 ms the kernel is shorter than its wrapper's
    # host work, so back-to-back CUDA events would time the host
    k_ms = device_ms(lambda: melspec.mel_spectrogram(xs, cosb, sinb, win, fb, 256), 20)
    p_ms = device_ms(lambda: melspec.mel_spectrogram_reference(xs, cosb, sinb, fb, 256), 20)
    c_ms = device_ms(mel_cufft, 20)
    fb_nnz = int((fb != 0).sum())
    print(f"phase 3 kernel vs plain at [{BATCH}, 5888] -> [{BATCH}, 20, 128], path {ms_path}: max|d| "
          f"{kernel_err:.3e} (tol {KERNEL_TOL}); dense path at n_fft 400, hop 160 on 8 rows: max|d| "
          f"{dense_err:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, cuFFT composition {c_ms:.4f} ms "
          f"(max|d| {cufft_err:.3e}; kernel vs cuFFT {kc_err:.3e}); filterbank {fb_nnz} nonzeros of "
          f"{fb.numel()} ({card})")
    del xs, xd, got, want, dense_args

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

    # per frame: window, rFFT, power, the mel projection over the
    # filterbank's nonzeros, floor and log. Bytes: the signal, the window,
    # the twiddles, the band table and weights in, the mel out
    n_fft, n_bins, n_mels = 1024, 513, 128
    ms_flops = BATCH * 20 * (n_fft + rfft_flops(n_fft) + 3 * n_bins + 2 * fb_nnz + 2 * n_mels)
    ms_bytes = 4 * (BATCH * 5888 + 2 * n_fft + 3 * n_mels + fb_nnz + BATCH * 20 * n_mels)
    ms_bound, ms_by = bound_ms(ms_flops, ms_bytes)
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
    print(f"phase 8 kernels ({card}): melspec {k_ms:.4f} ms vs plain {p_ms:.4f} ms and cuFFT composition "
          f"{c_ms:.4f} ms, bound {ms_bound:.4f} ms ({ms_by}: {ms_bytes / 1e6:.2f} MB, {ms_flops / 1e9:.3f} "
          f"GFLOP with an rFFT and the filterbank's nonzeros; {ms_bound / k_ms:.1%} of it); timestretch "
          f"{ts_ms:.4f} ms vs plain {tp_ms:.4f} ms, bound {ts_bound:.4f} ms ({ts_by})")

    # phase 9: the griffinlim kernel against its plain version at full width
    spec = stft(x, n_fft, 256)
    mag = spec.abs().contiguous()
    n_frames = mag.shape[1]
    check(tuple(mag.shape) == (PVOC_BATCH, 626, n_bins), f"magnitude shape {tuple(mag.shape)}")
    zeros = torch.zeros_like(mag)
    gd = griffinlim.designs(n_fft, 256, "hann", n_frames, dev)
    gl_path = griffinlim.kernel_path(n_fft, 256)
    check(gl_path == "fft", f"griffinlim takes the {gl_path} path at n_fft 1024, hop 256")
    got = griffinlim.griffin_lim_iteration(mag, zeros, mag, zeros, mag, 0.0)
    want = griffinlim.griffin_lim_iteration_reference(mag, zeros, mag, zeros, mag, 0.0, gd)
    torch.cuda.synchronize()
    gl_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    gl_rel = gl_err / max(w.abs().max().item() for w in want)
    check(gl_rel <= GL_TOL, f"griffinlim projection vs plain: rel {gl_rel} > {GL_TOL}")

    def gl_cufft(momentum):  # the same function from cuFFT and plain torch: a yardstick the port never calls
        s_re, s_im = griffinlim.replace_magnitude(mag, zeros, mag, zeros, mag, momentum)
        frames = torch.fft.irfft(torch.complex(s_re, s_im), n_fft) * gd.window
        spec = torch.fft.rfft(frame(overlap_add(frames, 256) * gd.inv.reshape(-1), n_fft, 256) * gd.window)
        return spec.real, spec.imag

    peak = max(w.abs().max().item() for w in want)
    cufft_rel = max((g - w).abs().max().item() for g, w in zip(gl_cufft(0.0), want)) / peak
    kc_rel = max((g - w).abs().max().item() for g, w in zip(got, gl_cufft(0.0))) / peak
    # two launches on the same planes, from a random phase with momentum: bitwise equal
    ph = torch.from_numpy(np.random.default_rng(SEED).uniform(-np.pi, np.pi, mag.shape).astype(np.float32)).to(dev)
    r_re, r_im = (mag * torch.cos(ph)).contiguous(), (mag * torch.sin(ph)).contiguous()
    runs = [griffinlim.griffin_lim_iteration(r_re, r_im, mag, zeros, mag, 0.99) for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*runs)), "two griffinlim launches on the same input differ")
    # the dense path at an odd n_fft (501, hop 167) on 8 rows
    check(griffinlim.kernel_path(501, 167) == "dense", "griffinlim at 501/167 does not take the dense path")
    md = stft(x[:8], 501, 167).abs().contiguous()
    zd = torch.zeros_like(md)
    gdd = griffinlim.designs(501, 167, "hann", md.shape[1], dev)
    dense_want = griffinlim.griffin_lim_iteration_reference(md, zd, md, zd, md, 0.0, gdd)
    dense_rel = max((g - w).abs().max().item() for g, w in zip(
        griffinlim.griffin_lim_iteration(md, zd, md, zd, md, 0.0, 501, 167), dense_want)) / max(
        w.abs().max().item() for w in dense_want)
    check(dense_rel <= GL_TOL, f"dense griffinlim projection vs plain: rel {dense_rel} > {GL_TOL}")
    del got, want, runs, r_re, r_im, ph, md, zd, gdd, dense_want

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
    gk_ms = device_ms(lambda: griffinlim.griffin_lim_iteration(mag, zeros, mag, zeros, mag, 0.99), 10)
    gp_ms = device_ms(lambda: griffinlim.griffin_lim_iteration_reference(mag, zeros, mag, zeros, mag, 0.99, gd), 10)
    gc_ms = device_ms(lambda: gl_cufft(0.99), 10)
    # one iteration, per frame: the prologue (15 per bin: momentum, |a|, the
    # guard, two divides and two products), the inverse rFFT, the synthesis
    # window and overlap-add, the analysis window and the forward rFFT; per
    # row sample, the WOLA inverse. Bytes: 5 state planes in, 2 out, the row
    # inverse, the window and the twiddles
    n_rows = n_frames + n_fft // 256 - 1
    gl_flops = PVOC_BATCH * (n_frames * (2 * rfft_flops(n_fft) + 15 * n_bins + 3 * n_fft) + n_rows * 256)
    gl_bytes = 4 * (7 * PVOC_BATCH * n_frames * n_bins + n_rows * 256 + 2 * n_fft)
    gl_bound, gl_by = bound_ms(gl_flops, gl_bytes)
    print(f"phase 9 griffinlim vs plain at {list(mag.shape)}, path {gl_path}: one projection max|d| "
          f"{gl_err:.3e}, rel {gl_rel:.3e} (tol {GL_TOL}); dense path at 501/167 on 8 rows: rel "
          f"{dense_rel:.3e}; two launches bitwise equal; 8 iterations spectral convergence kernel {sc_k:.5f} "
          f"vs plain {sc_p:.5f} (tol {GL_SC_TOL}); true-phase oracle {oracle:.3e} (tol {GL_ORACLE_TOL}); "
          f"kernel {gk_ms:.4f} ms per iteration, plain {gp_ms:.4f} ms, cuFFT composition {gc_ms:.4f} ms "
          f"(rel {cufft_rel:.3e}; kernel vs cuFFT {kc_rel:.3e}), bound {gl_bound:.4f} ms ({gl_by}: "
          f"{gl_bytes / 1e6:.1f} MB, {gl_flops / 1e9:.3f} GFLOP with FFTs; {gl_bound / gk_ms:.1%} of it) ({card})")

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

    del mag, zeros, mel, x, x_np, gd
    torch.cuda.empty_cache()

    # phase 12: the viterbi kernel against its plain version at full width
    x_np = vibrato_batch(PYIN_BATCH, SECONDS, PVOC_RATE, SEED)
    x = torch.from_numpy(x_np).to(dev)
    fr = frame(pad_center(x, 2048), 2048, 256)
    obs_v, voiced_prob, *_, n_bins, nbps = pitch_ops._pyin_observations(fr, PVOC_RATE, 65.0, 2093.0)
    lv, lu = pitch_ops._pyin_log_obs(obs_v, voiced_prob, n_bins)
    lv, lu = lv.movedim(-2, 0).contiguous(), lu.movedim(-2, 0).contiguous()  # [F, B, N]
    half, lk, _, _ = pitch_ops._pyin_hmm_consts(PVOC_RATE, 256, nbps, 35.92, 0.01, dev)
    vargs = (lk, -np.log(2 * n_bins), np.log1p(-0.01), np.log(0.01))
    n_frames, k_taps = lv.shape[0], 2 * half + 1
    check((n_frames, n_bins, k_taps) == (626, 602, 139), f"pyin shape {n_frames} frames, {n_bins} bins, {k_taps} taps")
    got = viterbi.pyin_viterbi_forward(lv, lu, *vargs)
    want = viterbi.pyin_viterbi_forward_reference(lv, lu, *vargs)
    torch.cuda.synchronize()
    for name, g, w in zip(("dv", "du", "off", "pick"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), f"viterbi {name} differs from plain")
    vit_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    raw_max = int(got[2].max()) + half
    # a tie-heavy band of 255 taps: everything on a 0.5 grid, the unvoiced
    # track constant per frame, every fifth frame quiet so that tracks switch
    rng = np.random.default_rng(SEED)
    tv_np = np.round(rng.uniform(-12, 0, (64, 8, 700)) * 2) / 2
    tv_np[3::5] -= 10.0
    tv = torch.from_numpy(tv_np.astype(np.float32)).to(dev)
    tu = torch.from_numpy((np.round(rng.uniform(-12, 0, (64, 8, 1)) * 2) / 2).astype(np.float32)).to(dev)
    tu = tu.expand(64, 8, 700).contiguous()
    tk = -np.round(np.abs(np.arange(-127, 128)) / 8) / 2
    tie = [viterbi.pyin_viterbi_forward(tv, tu, tk, -3.0, -0.5, -1.0),
           viterbi.pyin_viterbi_forward_reference(tv, tu, tk, -3.0, -0.5, -1.0)]
    for name, g, w in zip(("dv", "du", "off", "pick"), *tie):
        check(torch.equal(g, w), f"viterbi {name} differs from plain on the 255-tap tie case")
    del got, want, tie, tv, tu
    vk_ms = cuda_ms(lambda: viterbi.pyin_viterbi_forward(lv, lu, *vargs), 10)
    vp_ms = cuda_ms(lambda: viterbi.pyin_viterbi_forward_reference(lv, lu, *vargs), 2, warmup=1)
    # an add and a max per tap, state and frame past the first, and the
    # merge's 2 adds, compare, select and add per state; bytes: the two
    # observation tensors in, the final messages and the int8 backpointers out
    vit_states = 2 * PYIN_BATCH * n_bins
    vit_flops = (n_frames - 1) * vit_states * (2 * k_taps + 5) + vit_states
    vit_bytes = 4 * 2 * n_frames * PYIN_BATCH * n_bins + 4 * vit_states + 2 * n_frames * vit_states + 4 * k_taps
    vit_bound, vit_by = bound_ms(vit_flops, vit_bytes)
    print(f"phase 12 viterbi vs plain at [{n_frames}, {PYIN_BATCH}, {n_bins}], {k_taps} taps: dv, du, off, pick "
          f"exactly equal (max|d| {vit_err}; raw offsets up to {raw_max}); 255-tap tie case [64, 8, 700] exactly "
          f"equal; kernel {vk_ms:.4f} ms, plain {vp_ms:.4f} ms, bound {vit_bound:.4f} ms ({vit_by}: "
          f"{vit_flops / 1e9:.3f} G operations, {vit_bytes / 1e6:.1f} MB; the kernel at "
          f"{vit_flops / vk_ms / 1e9:.2f} T operations/s) ({card})")
    del lv, lu, obs_v, voiced_prob, fr

    # phase 13: the pYIN slice through the port's entry points, counted from 0
    pyin_graph = Graph((Pyin(),), input_rate=PVOC_RATE).compile()
    viterbi.COUNT.launches = 0
    f0, vflag, vprob = pyin(x_np, PVOC_RATE)  # numpy input goes to the card
    torch.cuda.synchronize()
    counts = [viterbi.COUNT.launches]
    check(counts[0] == 1, f"pyin launched the viterbi kernel {counts[0]} times")
    check(f0.shape == vflag.shape == vprob.shape == (PYIN_BATCH, n_frames) and f0.device.type == "cuda",
          f"pyin shapes {tuple(f0.shape)}")
    check(bool(torch.isfinite(f0).all() and torch.isfinite(vprob).all()), "non-finite pyin output")
    f0s, vflags, vprobs = pyin(x_np, PVOC_RATE, viterbi_impl="xla")
    check(viterbi.COUNT.launches == 1, "the plain scan launched the viterbi kernel")
    check(torch.equal(f0, f0s) and torch.equal(vflag, vflags), "kernel and scan decodes differ")
    vprob_d = (vprob - vprobs).abs().max().item()
    out = pyin_graph(x_np)
    torch.cuda.synchronize()
    counts.append(viterbi.COUNT.launches - sum(counts))
    check(counts[1] == 1, f"the Pyin graph launched {counts[1]} times")
    check(tuple(out.shape) == (PYIN_BATCH, n_frames, 3) and torch.equal(out[..., 0], f0), f"Pyin graph {out.shape}")
    tt = np.arange(PVOC_RATE) / PVOC_RATE
    xy = (0.5 * np.sin(2 * np.pi * 220.0 * tt)).astype(np.float32)
    f0p, vfp, _ = pyin(xy, PVOC_RATE, fmin=80, fmax=1200, resolution=0.5, n_thresholds=32)
    counts.append(viterbi.COUNT.launches - sum(counts))
    check(counts[2] == 1, f"pyin_220_rel's pyin launched {counts[2]} times")
    f0p, vfp = f0p.cpu().numpy()[4:-4], vfp.cpu().numpy()[4:-4]
    pyin_220 = float(np.abs(f0p - 220.0).max() / 220.0) if vfp.all() else 1.0
    check(pyin_220 < PITCH_GATE, f"pyin_220_rel {pyin_220} >= {PITCH_GATE}")
    f0y = yin(xy, PVOC_RATE, fmin=80, fmax=1200).cpu().numpy()
    yin_220 = float(np.abs(f0y[4:-4] - 220.0).max() / 220.0)
    check(yin_220 < PITCH_GATE, f"yin_220_rel {yin_220} >= {PITCH_GATE}")
    vit_launches = viterbi.COUNT.launches
    voiced = vflag.float().mean().item()
    print(f"phase 13 slice: pyin {PYIN_BATCH} x {x.shape[-1]} -> f0, voiced, prob ({PYIN_BATCH}, {n_frames}), "
          f"finite, {voiced:.3f} of frames voiced; the plain scan decodes equal f0 and voicing (voiced prob "
          f"max|d| {vprob_d:.3e}); the Pyin graph -> {tuple(out.shape)}; viterbi launches {counts} = "
          f"{vit_launches}; pyin_220_rel {pyin_220:.3e}, yin_220_rel {yin_220:.3e} (gates {PITCH_GATE})")
    del f0s, vflags, vprobs, out

    # phase 14: timing, alternating the scan and kernel paths
    audio_s = PYIN_BATCH * x.shape[-1] / PVOC_RATE
    times = {"pallas": [], "xla": []}
    for impl in ("xla", "pallas", "pallas", "xla", "xla", "pallas"):
        times[impl].append(cuda_ms(lambda impl=impl: pyin(x, PVOC_RATE, viterbi_impl=impl), 2, warmup=1))
    med = {k: float(np.median(v)) for k, v in times.items()}
    yin_ms = cuda_ms(lambda: yin(x, PVOC_RATE), 3, warmup=1)
    print(f"phase 14 timing ({card}): pyin {audio_s:.1f} audio-s per run; kernel path {med['pallas']:.3f} ms = "
          f"{audio_s / med['pallas'] * 1e3:.0f} audio-s/s, plain scan {med['xla']:.3f} ms = "
          f"{audio_s / med['xla'] * 1e3:.0f} audio-s/s (runs, ms: {json.dumps(times)}); yin {yin_ms:.3f} ms = "
          f"{audio_s / yin_ms * 1e3:.0f} audio-s/s")

    print(json.dumps({"kernels": [
        {
            "name": "melspec", "route": "cuda", "source": "audioflow_torch/csrc/melspec.cu",
            "replaces": "audioflow_tpu/ops/pallas/melspec.py:137", "launches": launches,
            "max_abs_err": kernel_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": ms_bound, "bound_by": ms_by, "library_ms": None, "path": ms_path, "cufft_ms": c_ms,
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
            "bound_ms": gl_bound, "bound_by": gl_by, "library_ms": None, "path": gl_path, "cufft_ms": gc_ms,
        },
        {
            "name": "viterbi", "route": "cuda", "source": "audioflow_torch/csrc/viterbi.cu",
            "replaces": "audioflow_tpu/ops/pallas/viterbi.py:124", "launches": vit_launches,
            "max_abs_err": vit_err, "ms": vk_ms, "plain_ms": vp_ms,
            "bound_ms": vit_bound, "bound_by": vit_by, "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
