"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's ported paths through the hand-written CUDA kernels,
BASELINE configs 3 and 5 through the biquad engine and the melspec kernel,
the file path (decode, staging ring, batch runner, sinks) through
``audioflow run``, the validate report, the dictation path (stream
session, VAD, i16 wire egress over a WebSocket), the mastering, effects
and feature families (denoise mastering, keyword spotting, the effects
chain, the feature graphs, the loudness meter, NMF separation), and the CQT
and rhythm families (the CQT and its inverses, ``run -g
cqt|cqtroundtrip|onset|beats``, tempo, the beat DP, the streaming beat
graph), the trainable frontend's train step (one card, and an NCCL world of
one rank), and the multi-rank paths (gloo worlds of 2 and 4 ranks on the
card: batch and time sharding, the DP x TP step, ``run --sharded`` under
``torch.distributed.run``), and the bench (``audioflow bench``), and checks
them. The log-mel frontend
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

1. device: the ``nvidia-smi`` name and power-limit line, and the SM clock;
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
6. timestretch kernel vs plain: the path it took (checked to be ``fft``),
   at the ``pvoc`` shape (rate 1.25), at the ``pitch`` stretch's (rate 0.5,
   all 64 rows), and at rates 0.8, 2/3 and 2.0 on 8 rows, every sample; its
   dense path at n_fft 960, hop 240 on 8 rows; two launches bitwise equal;
   the ms per call of kernel, plain version and the cuFFT composition
   (``time_stretch(impl="fft")``) by device time;
7. time-stretch slice: the ``TimeStretch(1.25)`` and ``PitchShift(12.0)``
   graphs (one launch each), the kernel-vs-matmul gate of the JAX
   package's validate (and the kernel's distance to the cuFFT composition
   beside it), and the pitch-doubling probe;
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
    pYIN batch computed once on the card, the cluster size taken (checked
    above 1), the kernel's ``dv``, ``du``, ``off`` and ``pick`` exactly
    equal to the plain version's, and at batch 1 (clusters of 8), on a
    narrow band whose margins span more than one neighbour, and on a
    tie-heavy synthetic case at 255 taps; ms per call of both by device
    time against the bound;
13. pYIN slice, launches counted from 0: ``pyin(x)`` on numpy input (1
    launch), the plain scan (``viterbi_impl="xla"``) decoding the same f0
    and voicing, the ``Pyin`` node through ``Graph.compile()`` (1 launch),
    and the JAX package's ``pyin_220_rel`` (1 launch) and ``yin_220_rel``
    gates;
14. pYIN timing: ``pyin`` through the kernel and through the plain scan,
    alternated, and ``yin`` on the same batch, in audio-seconds per second;
15. BASELINE config 3, ``master_chain_graph(16000).compile()`` on 64 x 10 s
    of the tone batch: the EQ on 4 rows against the float64
    ``scipy.signal.sosfilt``, the chain on the card against the CPU, the
    limiter's peak (and at four times the level, where it engages),
    ``scan_stream`` in 16,384-sample chunks against ``compile()`` and the
    whole-array chain, and one ``BiquadChain`` call's aten ops, counted
    exactly, at 1,250 and 5,000 blocks (the doubling scan adds two steps,
    not 3,750 blocks);
16. BASELINE config 5, ``log_mel_frontend(..., eq=eq_bands_default(16000))``
    streamed over 256 x 31 chunks of 14,112 at 44.1 kHz: one melspec launch
    per chunk, shape, finiteness, and agreement with the JAX benchmark's
    plain composition Resample -> BiquadChain -> Spectrogram -> MelProject;
17. their timing: config 3 through ``compile()``, config 5's kernel path and
    plain composition alternated, and ``BiquadChain``'s share of config 5's
    device time (its 31 steps on the resampled chunks, timed alone), with
    its device events a chunk under the profiler;
18. the native batch decoder: ``native/wavcodec.cpp`` built with ``g++``
    into ``build/audioflow_torch/`` (the seconds printed), and on the files
    of phase 19 ``decode_batch`` natively and by numpy bit for bit equal;
19. the file path of the headline graph through ``audioflow run``, called in
    the process: 256 mono 16-bit WAV files of 10 s at 44.1 kHz written from
    the tone batch, plus one corrupt file and one at 48 kHz, run by
    ``run -g logmel --batch-size 32`` (9 batches through the loader's
    5-slot pinned staging ring, so slots are refilled): the JSON line's
    counts (258 files, 2 failed), the native decoder used once a batch,
    one melspec launch a batch, the ``.npy`` exactly equal to the graph
    called directly on the decoded samples in the same batches, and the
    corrupt and 48 kHz lanes all zero out of the runner's masked step;
20. BASELINE config 5 through ``run --spec``: the port's ``graph_to_spec``
    of ``log_mel_frontend(..., eq=eq_bands_default(16000))`` run over the
    same files, exactly equal to the graph called directly;
21. the file path's timing, printed with no bound: audio-s/s from the run's
    ``RunMetrics``, host decode, the copy to the card and the graph per
    batch, and the device busy share of the run under torch.profiler;
22. the validate report: ``run_validation`` in the process with every
    kernel's launches counted from 0 (each row set launches a kernel), then
    ``python -m audioflow_torch.cli validate`` in a subprocess: exit 0, all
    23 rows and none missing, each row printed beside its budget (the CQT's
    six among them, the hybrid inverse's broadband rows in their two-sided
    bands);
23. the stream session at the JAX bench's width (``bench.py:196-245``):
    ``StreamSession(log_mel_frontend(44100, 16000, 1024, 256, 128))`` with
    lead (64,) over 64 x 10 s of the tone batch, chunk 14,112, pushed a
    chunk at a time and in 8-chunk blocks (staging of 17 chunks): results
    exactly equal to ``scan_stream``, one melspec launch a chunk and one
    for the warm-up; audio-s/s, p50/p99 ms a chunk with the host copy of
    its result, the card's idle share;
24. the dictation fork (SURVEY 3.3): ``fork(Resample(48000->16000,
    kaiser), wire=VadGate(320)+QuantizeI16, vad=Vad(320),
    features=LogMelSpec(1024, 256, 128))`` through a session, lead (64,),
    64 x 30 s at 48 kHz of a seeded speech-like batch in 960-sample pushes:
    every branch exactly equal to ``Fork.scan_stream``; a snapshot halfway
    restored into a fresh session, its tail exactly the uninterrupted one;
    VAD states equal to the CPU's, i16 within 1 LSB; NaN and +-inf
    quantized as on the CPU; ms a push and the VAD nodes' aten ops a chunk;
25. egress: a 48 kHz WAV through ``audioflow egress --vad-gate`` to a
    loopback WebSocket server (``tests/ws_loopback.py``, 127.0.0.1, an
    ephemeral port): the server's audio exactly the i16 of the graph on the
    card, the chunk count and the transcript lines as sent; then once more
    with the server dropping the connection after 3 chunks: a reconnect,
    the configure message again, the chunks that arrived in order;
26. denoise mastering (voice-over and podcast batches): 64 float WAV files
    of 60 s at 16 kHz of the phase-24 speech-like signal over a -45 dBFS
    noise floor, through ``audioflow run --spec
    examples/denoise_master_spec.json`` and ``run -g denoise``, each
    ``--batch-size 16``: the output exactly the graph called directly on the
    runner's batches, every lane at -16 LUFS within 0.1 LU or held at the
    -1 dBTP ceiling, the noise-only stretches (100 ms clear of speech)
    falling relative to the speech, by at least 10 dB through the spectral
    gate alone; the spec's graph on the first file on the CPU within its
    CPU test's tolerance, with the gate decisions that differ counted;
    audio-s/s, the card's busy share and the largest items of device time;
27. the keyword-spotting front end (a voice-assistant fleet): a
    ``StreamSession`` over ``examples/kws_pcen_spec.json``, lead (64,),
    64 x 10 s at 16 kHz pushed 320 samples (20 ms) at a time: exactly
    ``scan_stream``, within 1e-5 of the offline graph from frame 0 (the PCEN
    reseed); ms a push;
28. the effects chain ``examples/echo_ensemble_spec.json`` on 64 x 30 s at
    16 kHz, offline and streamed in 16,384-sample chunks: ``Delay`` alone
    streamed exactly equal to offline; the chain streamed within the bound
    that the fp32 read positions of the modulated taps set (the offline
    form reads at positions up to 30 s, where fp32 steps are 2^-5); audio-s/s
    and ``Delay``'s aten ops;
29. ``run -g features|chroma|contrast|tonnetz|deltafbank|kws`` over the 256
    tone files of phase 19, each against the same graph on the CPU on the
    first file within its CPU test's tolerance; audio-s/s for each;
30. ``audioflow loudness`` of a 997 Hz 0 dBFS sine (-3.01 LKFS within
    0.01) and ``audioflow separate -k 2`` of 30 s of two tones (the
    components sum to the input within 1e-4 of its peak; the 16-bit WAVs
    within the format's round trip of them); nmf's aten ops;
31. the CQT at the framework default (84 bins from C1, hop 256) on 64 x 10 s
    of the tone batch at 16 kHz: each impl on the card against the CPU on 4
    lanes (1e-5 of the peak), its ms, peak memory and aten ops; the onedot
    product as a hop-block conv against the matmul on the framed view (ms,
    peak memory, the bound); ``chroma_cqt``; ``cqt_frontend`` streamed in
    16,384-sample chunks against offline at its latency; the painless,
    hybrid and multirate round trips at validate's configs inside its
    budgets, the multirate round trip of the tone batch >= 30 dB inside the
    CQT's band, and each round trip timed at 64 x 10 s;
32. ``run -g cqt``, ``run -g cqtroundtrip`` and ``run -g cqtroundtrip
    --multirate`` with ``--batch-size 32`` over phase 19's 256 files: the
    first batch exactly the graph called directly, audio-s/s, host decode
    and graph ms a batch, which sets the pace, peak device memory, and the
    multirate round trip of each file >= 30 dB inside the CQT's band;
33. ``run -g onset`` and ``run -g beats`` the same way; the tempo of click
    tracks at 90, 120 and 150 BPM; ``beat_track`` of 64 click tracks of 30 s
    on the card equal to the CPU's mask wherever the DP's margins are clear
    (the frames left out counted); the streaming beat graph
    (``Spectrogram -> MelProject -> OnsetStrength -> OnlineBeats``) over the
    same tracks in 16,384-sample chunks equal to offline at its latency
    where its decisions are clear; aten ops per envelope frame of
    ``beat_track`` and ``OnlineBeats``; no kernel launched on phases 31-33;
34. online pYIN (``pyin_online`` at ``make_online_pyin_plan``'s defaults:
    602 bins, lag 25) on the pyin cell's 64 x 10 s: the ``OnlinePyin`` node
    streamed in 16,384-sample chunks equal to offline at its latency; the
    card against the CPU on 8 lanes, equal wherever the decisions that reach
    an emission agree (each place they part a near tie of the messages,
    ``tests/decision_margins.py``); against the offline Viterbi (the kernel)
    outside the lag window on a steady 220 Hz tone; ms a frame, aten ops a
    frame, audio-s/s and the card's idle share; no kernel launched;
35. ``audioflow pitch --method yin|pyin|pyin-online``, ``align`` (two 30 s
    files at 16 kHz), ``segments`` (180 s at 44.1 kHz, T = 15,504 frames)
    and ``inspect -g logmel`` in the process, each against ``--device
    cpu``; ``pitch --method pyin`` launches viterbi exactly once, counted
    from 0; the dense Viterbi and LPC at the JAX tests' shapes; DTW and
    ``segments`` timed with their peak device memory, the novelty's
    summed-area table against the CPU within its fp32 bound;
36. training: ``examples/train_kws_torch.py``'s assertions on the card;
    ``TrainableFrontend`` at its defaults and with ``hidden=256`` on 256
    keyword-shaped clips of 1 s, one step on the card against the same step
    on the CPU (loss, gradients, the parameters after one Adam step where
    the gradient clears its margin), ms a step by CUDA events, clips/s, peak
    memory and device launches a step, with ``remat`` off and on; the step
    over an NCCL world of one rank, exactly the unsharded step, with NCCL's
    kernels in its profile; no kernel of the port launched;
37. sharding: gloo worlds of 2 and 4 ranks (spawned processes that share
    the card, each world under a deadline): ``compile_sharded`` in batch
    mode (``log_mel_frontend`` over 64 x 10 s) against ``graph.chain``, in
    time mode over one 600 s speech-like recording (``log_mel_frontend``'s
    Resample -> LogMelSpec, melspec launches counted per rank, and
    ``master_chain_graph``'s BiquadChain + Limiter at 16 kHz) against the
    unsharded run on the card, both log-mel modes also against the plain
    (unfused) graph, so that the melspec kernel is held to its plain
    version at the shapes these paths give it; gloo's all-reduce and
    all-gather checked on values with CUDA tensors; on 4 ranks the DP x TP step on a (2, 2) mesh against the
    single-process step; ``run --sharded`` under ``torch.distributed.run``
    with 2 ranks over phase 19's files, exactly ``run --batch-size 16``'s
    output (the ranks' halves of each batch of 32);
38. the bench: ``audioflow bench all --report --profile-dir`` in the
    process: exit 0, seven rows, each with the keys of the JAX package's
    row (listed here), every realtime factor finite and positive, the
    report's six table rows, and a torch.profiler trace whose kernel events
    name the melspec and timestretch kernels; the kernels' launches counted
    from 0 around ``run_benchmark`` for ``logmel_stream``, ``logmel``,
    ``pvoc``, ``pitch``, ``session``, ``master`` and ``stft``, each equal to the count
    worked out from its chunking and its calls (warm-up and the flop
    counter's call included; griffinlim and viterbi 0); config 2's chunked
    ``compile()`` (256 x 10 s, the melspec kernel) against the plain graph
    on the same input; ``bench streaming --sharded`` in an NCCL world of one
    rank and a gloo world of 2 ranks on the card; each untraced row printed
    beside PERF.md section 5's row of the same path.

Every device time (phases 3, 6, 9, 12) is the median of three readings
under torch.profiler, printed with the readings and the device events per
call; a kernel's reading sums the mean time per launch of each kernel it
runs once a call, which events the profiler drops or repeats do not bias. Then a JSON line of the seconds of
phases 34 to 38 and of the whole run, one JSON line of per-kernel numbers (with ``path`` and ``cufft_ms``
for the three kernels built on the shared-memory FFT, ``cluster`` for
viterbi), and last
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
# readings per device time; their median is reported
READINGS = 3
# BASELINE config 3 (master): 64 x 10 s at 16 kHz (audioflow_tpu/bench.py:103-108)
MASTER_BATCH = 64
MASTER_RATE = 16000
# BASELINE config 5 (streaming): 256 x 31 chunks of 14,112 at 44.1 kHz (bench.py:132-165)
STREAM_BATCH = 256
# the file path (phases 18-21): 256 mono 16-bit WAV files of 10 s at 44.1 kHz
# from the tone batch, one corrupt file and one at 48 kHz, run in batches of
# 32: 9 batches through the loader's 5-slot staging ring, so slots are reused
FILES = 256
FILE_BATCH = 32
CORRUPT = "f100_corrupt.wav"
OFF_RATE = "f200_48k.wav"
# run output vs the graph called directly on the decoded samples in the same
# batches: the same graph on the same card at the same shapes, so exactly
# equal; a copy that read a refilled staging slot would differ by O(1)
FILE_TOL = 0.0
# the EQ against the float64 sosfilt oracle: the reference's biquad_chain
# budget (validate.py:58-70, 417)
IIR_ORACLE_TOL = 1e-4
# sample space: the card against the CPU, streamed against offline
SAMPLE_TOL = 1e-5
# the session (phase 23) at the JAX bench's width (bench.py:196-245): 64 x 10 s
SESSION_BATCH = 64
# the dictation fork (phase 24): 64 x 30 s at 48 kHz; egress (phase 25): one 12 s file
DICTATION_SECONDS = 30.0
EGRESS_SECONDS = 12.0
# denoise mastering (phase 26): 64 files of 60 s at 16 kHz of the phase-24
# speech-like signal over a -45 dBFS noise floor, float WAV (61.4 M samples,
# 246 MB of PCM), run in batches of 16 (voice-over and podcast batches)
DENOISE_FILES = 64
DENOISE_SECONDS = 60.0
DENOISE_BATCH = 16
NOISE_DB = -45.0
# the denoise chain on the card against the CPU, of the output's peak: its
# CPU test's tolerance on 1 s (tests/test_torch_decompose.py), plus what the
# compressor's envelope adds on a long signal (phase 26 computes it): the
# envelope runs in the log domain against a ramp of T / tau (600 at 60 s),
# whose fp32 spacing (2^-14 there) bounds its relative error
DENOISE_TOL = 2e-5
# loudness normalization: each lane within 0.1 LU of its target, or held at
# the -1 dBTP ceiling
TARGET_LU_TOL = 0.1
# the spectral gate lowers the noise-only stretches (100 ms clear of speech)
# by at least this much relative to the speech
GATE_DB = 10.0
# the keyword-spotting front end (phase 27): 64 streams of 10 s, 20 ms pushes
KWS_SECONDS = 10.0
KWS_PUSH = 320
# streamed from frame 0 against offline, of the peak: the JAX package's own
# streaming tolerance for Pcen (tests/test_decompose_deltas.py)
PCEN_TOL = 1e-5
# the effects chain (phase 28): 64 x 30 s at 16 kHz, streamed in 16,384-sample chunks
EFFECTS_SECONDS = 30.0
EFFECTS_CHUNK = 16384
# the feature graphs (phase 29) on the card against the CPU, each within its
# CPU test's tolerance (tests/test_torch_cli.py): ("rel" of the peak or "abs")
FEATURE_TOLS = {"features": ("rel", 2e-5), "chroma": ("rel", 2e-5), "contrast": ("abs", 0.02),
                "tonnetz": ("rel", 2e-5), "deltafbank": ("abs", 5e-4), "kws": ("abs", 5e-4)}
# meters and separation (phase 30): the BS.1770 anchor (-3.01 LKFS for a
# 997 Hz 0 dBFS sine), and two separated components summing to the input
ANCHOR_LU_TOL = 0.01
SEPARATE_SECONDS = 30.0
SEPARATE_TOL = 1e-4
# the CQT (phases 31-32) at the framework default (84 bins from C1, hop 256):
# 64 x 10 s of the tone batch at 16 kHz, and phase 19's 256 files at 44.1 kHz
CQT_BATCH = 64
# the card against the CPU, of the peak: the CPU tests' tolerances
# (tests/test_torch_cqt.py FWD_TOL and INV_TOL); streamed against offline on
# the card, the same frames from cuDNN at two input shapes: FWD_TOL too
CQT_TOL = 1e-5
ICQT_TOL = 2e-5
# validate's round-trip budgets (icqt_painless_snr_db, icqt_tone_snr_db,
# icqt_multirate_noise_snr_db: >= 30 dB; the hybrid's broadband rows in
# their two-sided bands)
SNR_DB = 30.0
# rhythm (phase 33): 64 click tracks of 30 chunks of 16,384 samples (30.72 s)
# at 16 kHz, tempi 70-180 BPM, clicks to the end: a zero-padded tail would
# tie the beat DP's scores, which no margin clears; the tempo of a click
# track within one lag's step (tests/test_torch_rhythm.py)
RHYTHM_CHUNKS = 30
BPM_TOL = 1.5
# online pYIN (phase 34), card vs CPU where the decisions agree: f0 from the
# same candidate's refined lag (cuFFT against pocketfft), relative; the
# voiced probability, frame-local sums
ONLINE_F0_RTOL = 1e-5
ONLINE_VP_TOL = 1e-5
# the pitch CLI (phase 35) against --device cpu: the share of frames with
# equal voicing (tests/test_torch_pitch.py's bound between the packages),
# f0 within one rounding step of 0.01 Hz plus this relative part
PITCH_VOICING = 0.99
PITCH_F0_RTOL = 1e-4
# DTW's accumulated cost card vs CPU on the same features, of the final
# cost: the cost's products round differently (tests/test_torch_sequence.py)
DTW_TOL = 1e-5
# segments: a 180 s music-like file at 44.1 kHz (n_fft 2048, hop 512); the
# peak picker's sliding mean, an fp32 cumsum of the novelty on each device
SEGMENT_SECONDS = 180.0
SEG_MEAN_SLACK = 1e-4
# decision margins (tests/decision_margins.py): the beat DP's scores, the
# causal tracker's envelope comparisons, weighted autocorrelations (relative)
DP_MARGIN = 1e-3
ENV_MARGIN = 1e-5
LAG_MARGIN = 1e-5
# training (phase 36): TrainableFrontend at its defaults (n_fft 512, hop 128,
# 64 mels, 10 classes) and with hidden=256, on 256 keyword-shaped clips of
# 1 s at 16 kHz; the card against the CPU at the CPU tests' tolerances
# (tests/test_torch_trainable.py): the loss 1e-5 relative, each gradient
# within 1e-4 of its parameter's largest, the parameters after one Adam
# step 1e-6 where the gradient clears the margin (|g| at least 100 times the
# two devices' difference in it), elsewhere within 2 lr (Adam's first step
# is close to lr·sign(g))
TRAIN_CLIPS = 256
TRAIN_RATE = 16000
TRAIN_HIDDEN = 256
TRAIN_LR = 1e-3
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_STEP_TOL = 1e-6
TRAIN_MARGIN = 100.0
TRAIN_STEPS = 5
# sharding (phase 37): gloo worlds of 2 and 4 ranks on one card; the batch
# mode over 64 x 10 s of the tone batch at 44.1 kHz in log-mel space (the
# ranks' resampler products run at other shapes than the whole batch's,
# which cuBLAS may sum in another order); the time mode over one 600 s
# speech-like recording (a lecture's length: 26,460,000 samples at 44.1 kHz
# is whole resampler blocks and whole hops on 2 and 4 ranks) at the CPU
# tests' tolerances (tests/test_torch_parallel.py): log_mel_frontend 1e-3
# absolute and relative, the master chain 1e-5 plus the envelope's fp32
# bound (its log-domain ramp reaches T·|log r|, where fp32 steps by the
# spacing there: a relative gain error of 4 spacings)
SHARD_BATCH = 64
SHARD_BATCH_TOL = 1e-4
LECTURE_SAMPLES = 26_460_000
LECTURE_TOL = 1e-3
MASTER_LECTURE_SAMPLES = 9_600_000
WORLD_TIMEOUT = 600.0
# the bench (phase 38): `audioflow bench all`'s seven rows and the rows of
# logmel_stream and pitch, each with the keys of the JAX package's row on the CPU (tests/test_torch_bench.py holds
# the port's rows to those; this machine has no JAX), without achieved_gbps,
# which the port leaves out with no byte count; pvoc's call is the
# timestretch kernel, in which the flop counter sees no product, so its row
# has no cost columns
BENCH_ALL = ("roofline", "stft", "logmel", "master", "pvoc", "streaming", "session")
BENCH_RUN_KEYS = ("audio_seconds", "wall_seconds", "batches", "files", "failed_files", "compile_seconds",
                  "n_devices", "realtime_factor", "realtime_factor_per_chip", "benchmark", "batch", "clip_seconds")
BENCH_COST_KEYS = ("flops", "bytes_accessed", "achieved_tflops")
BENCH_KEYS = {
    "roofline": ("benchmark", "hbm_gbps", "mxu_tflops_bf16", "triad_ms", "matmul_ms", "compile_seconds"),
    "stft": BENCH_RUN_KEYS + BENCH_COST_KEYS, "logmel": BENCH_RUN_KEYS + BENCH_COST_KEYS,
    "master": BENCH_RUN_KEYS + BENCH_COST_KEYS, "streaming": BENCH_RUN_KEYS + BENCH_COST_KEYS,
    "logmel_stream": BENCH_RUN_KEYS + BENCH_COST_KEYS, "pitch": BENCH_RUN_KEYS + BENCH_COST_KEYS,
    "pvoc": BENCH_RUN_KEYS,
    "session": BENCH_RUN_KEYS + ("latency_ms_p50", "latency_ms_p99", "latency_x_realtime_p50"),
}
BENCH_REPORT_HEAD = ["# Benchmarks", "", "| config | batch | clip s | ms/iter | x realtime/chip |", "|---|---|---|---|---|"]
# a measured case's calls: 2 warm-up and 10 timed (measure_throughput), one under the flop counter
BENCH_CALLS = 13
# the card's published dense peaks beside the roofline row (H100 SXM data sheet)
BF16_FLOPS = 989e12
# PERF.md section 5's row of the same path and shape (NVIDIA H100 80GB HBM3, 700.00 W)
BENCH_PERF5 = {
    "logmel_stream": "logmel, kernel: 20.725 ms", "pvoc": "pvoc, kernel: 1.247 ms",
    "pitch": "pitch, kernel: 2.242 ms", "streaming": "streaming, plain: 34.395-38.903 ms",
    "master": "master, compile(): 19.448 ms", "session": "session, per-chunk pushes: 9,756-11,945 audio-s/s",
}


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


def device_ms(fn, iters: int, kernels: int | None = None) -> tuple[float, list[float], float]:
    """Device milliseconds per call of ``fn`` by torch.profiler: the median
    of :data:`READINGS` readings over ``iters`` calls each, the readings,
    and the device events a call that the profiler recorded (their mean).
    Unlike :func:`cuda_ms` it does not count the card's idle gaps, so a
    kernel shorter than its wrapper's host work is timed by the card, not by
    the host.

    A reading is the self times of the calls' device events, summed and
    divided by ``iters``. On the H100 the profiler drops some kernel events
    of a session (up to a third of them) and, with a warm-up step in its
    schedule, keeps one too many, so a sum per call reads low or high by as
    much. Where ``kernels`` is given, ``fn`` launches that many distinct
    kernels once a call each, and a reading is instead the sum of each
    kernel's mean time per recorded launch, which no dropped or extra event
    biases."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    readings, events = [], []
    for _ in range(READINGS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        if kernels is None:
            ms = sum(e.self_device_time_total for e in dev) / 1e3 / iters
        else:
            check(len(dev) == kernels, f"{kernels} kernels a call, the profiler recorded {[e.key for e in dev]}")
            ms = sum(e.self_device_time_total / e.count for e in dev) / 1e3
        readings.append(round(ms, 4))
        events.append(sum(e.count for e in dev) / iters)
    return float(np.median(readings)), readings, float(np.mean(events))


def timed(t: tuple[float, list[float], float]) -> str:
    """A :func:`device_ms` result for a log line."""
    return f"{t[0]:.4f} ms (readings {t[1]}, {t[2]:g} device events a call)"


def run_cli(args: list[str]) -> list[dict]:
    """``audioflow <args>`` in the process; its exit code checked, its JSON
    lines returned."""
    import contextlib
    import io

    from audioflow_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    check(rc == 0, f"audioflow exited {rc}: {args}")
    return [json.loads(line) for line in out.getvalue().strip().splitlines()]


def configs_3_and_5(dev: torch.device, card: str) -> int:
    """Phases 15-17: BASELINE configs 3 and 5 through the port's entry
    points. Returns melspec's launches on the config-5 stream."""
    import scipy.signal

    from audioflow_torch.graph import BiquadChain, MelProject, Resample, Spectrogram, chain
    from audioflow_torch.models import eq_bands_default, eq_chain_graph, log_mel_frontend, master_chain_graph
    from audioflow_torch.ops.kernels import melspec
    from audioflow_torch.profiling import aten_ops, tone_batch

    # phase 15: config 3, high-pass + 5-band EQ + limiter, through Graph.compile()
    x_np = tone_batch(MASTER_BATCH, SECONDS, MASTER_RATE, SEED)
    t = x_np.shape[-1]
    g3 = master_chain_graph(MASTER_RATE)
    master, whole = g3.compile(), g3.compile(chunked=False)
    y = master(x_np, device=dev)  # numpy input goes to the card
    torch.cuda.synchronize()
    check(y.device.type == dev.type and tuple(y.shape) == (MASTER_BATCH, t), f"master chain {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "non-finite master chain samples")
    bands = eq_bands_default(float(MASTER_RATE))
    y_eq = eq_chain_graph(MASTER_RATE).compile()(x_np, device=dev)
    sos = np.stack([np.concatenate(b.as_ba()) for b in bands])
    oracle = scipy.signal.sosfilt(sos, x_np[:4].astype(np.float64), axis=-1)
    eq_err = float(np.abs(y_eq[:4].cpu().numpy() - oracle).max())
    check(eq_err <= IIR_ORACLE_TOL, f"EQ vs float64 sosfilt max|d| {eq_err} > {IIR_ORACLE_TOL}")
    cpu_err = (y.cpu() - master(x_np, device="cpu")).abs().max().item()
    check(cpu_err <= SAMPLE_TOL, f"master chain card vs CPU max|d| {cpu_err} > {SAMPLE_TOL}")
    thresh = 10.0 ** (-1.0 / 20.0)
    peak = y.abs().max().item()
    check(peak <= thresh + 1e-6, f"limiter output peak {peak} > {thresh} + 1e-6")
    # four times louder, so that the limiter engages: the peak is held to the
    # threshold within the rounding of the envelope's log-domain ramp
    loud_peak = master(4.0 * x_np, device=dev).abs().max().item()
    check(thresh - 1e-3 < loud_peak <= thresh + SAMPLE_TOL, f"loud limiter peak {loud_peak} vs {thresh}")
    chunk3 = 16384
    xs = torch.nn.functional.pad(torch.from_numpy(x_np).to(dev), (0, -(-t // chunk3) * chunk3 - t))
    streamed = g3.scan_stream(xs, chunk3)[:, :t]
    stream_err = (streamed - y).abs().max().item()
    whole_err = (streamed - whole(x_np, device=dev)).abs().max().item()
    check(max(stream_err, whole_err) <= SAMPLE_TOL,
          f"scan_stream vs offline max|d| {stream_err} (compile()), {whole_err} (whole array) > {SAMPLE_TOL}")
    # one BiquadChain call at T and 4·T: the doubling scan adds two steps,
    # a product and an add each
    node = g3.nodes[0]
    x_dev = torch.from_numpy(x_np).to(dev)
    n_blk = -(-t // node.block)
    node.apply(x_dev)  # the plan is on the card before the count
    iir = [aten_ops(lambda xx=xx: node.apply(xx)) for xx in (x_dev, x_dev.repeat(1, 4))]
    check(iir[1] - iir[0] == 4 and iir[0] < n_blk // 40,
          f"BiquadChain aten ops {iir} at {n_blk} and {4 * n_blk} blocks")
    print(f"phase 15 config 3: master_chain_graph({MASTER_RATE}).compile() on {MASTER_BATCH} x {t} -> "
          f"{tuple(y.shape)}, finite; EQ on 4 rows vs float64 sosfilt max|d| {eq_err:.3e} (tol {IIR_ORACLE_TOL}); "
          f"card vs CPU {cpu_err:.3e}, scan_stream in {chunk3}-sample chunks vs compile() {stream_err:.3e} and vs "
          f"the whole-array chain {whole_err:.3e} (tol {SAMPLE_TOL}); limiter peak {peak:.7f}, x4 louder "
          f"{loud_peak:.7f} (threshold {thresh:.7f}); one BiquadChain call: {iir[0]} aten ops at {n_blk} blocks, "
          f"{iir[1]} at {4 * n_blk} ({card})")
    del y, y_eq, streamed, xs

    # phase 16: config 5 streamed through log_mel_frontend(eq=...), the melspec kernel
    eq = eq_bands_default(16000.0)
    g5 = log_mel_frontend(RATE, 16000, 1024, 256, 128, eq=eq, center=False)
    plain5 = chain(Resample(RATE, 16000, "kaiser"), BiquadChain(eq), Spectrogram(1024, 256, center=False),
                   MelProject(n_mels=128), input_rate=RATE)
    gran = g5.chunk_granularity()
    chunk5 = gran * max(1, 16384 // gran)
    x5_np = tone_batch(STREAM_BATCH, SECONDS, RATE, SEED)
    n5 = x5_np.shape[-1] // chunk5
    x5 = torch.from_numpy(x5_np[:, : n5 * chunk5]).to(dev)
    del x5_np
    lat5 = g5.stream_latency(chunk5)
    frames5 = n5 * g5.chunk_lens(chunk5)[-1]
    melspec.COUNT.launches = 0
    y5 = g5.scan_stream(x5, chunk5)
    torch.cuda.synchronize()
    launches5 = melspec.COUNT.launches
    check(launches5 == n5, f"config 5: melspec launched {launches5} times for {n5} chunks")
    check(tuple(y5.shape) == (STREAM_BATCH, frames5, 128), f"config 5 output shape {tuple(y5.shape)}")
    check(bool(torch.isfinite(y5).all()), "non-finite config 5 log-mel values")
    err5 = (y5[:, lat5:] - plain5.scan_stream(x5, chunk5)[:, lat5:]).abs().max().item()
    check(err5 <= SLICE_TOL, f"config 5 vs the plain composition max|d| {err5} > {SLICE_TOL}")
    print(f"phase 16 config 5: log_mel_frontend(eq=eq_bands_default(16000)) streamed over {STREAM_BATCH} x "
          f"{x5.shape[-1]} samples in {n5} chunks of {chunk5} -> {tuple(y5.shape)}, finite, melspec launches "
          f"{launches5} = chunks {n5}; vs the plain composition Resample -> BiquadChain -> Spectrogram -> "
          f"MelProject from frame {lat5}: max|d| {err5:.3e} (tol {SLICE_TOL})")
    del y5

    # phase 17: timing. Config 3 through compile(); config 5's kernel path
    # and plain composition alternated; BiquadChain's share of config 5's
    # device time: its 31 steps on the resampled chunks against the stream
    audio3 = MASTER_BATCH * t / MASTER_RATE
    runs3 = [cuda_ms(lambda: master(x_dev), 3, warmup=1) for _ in range(3)]
    ms3 = float(np.median(runs3))
    audio5 = STREAM_BATCH * x5.shape[-1] / RATE
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        g = g5 if name == "kernel" else plain5
        times[name].append(cuda_ms(lambda g=g: g.scan_stream(x5, chunk5), 3, warmup=1))
    med = {k: float(np.median(v)) for k, v in times.items()}
    res_node, bq_node = g5.nodes[0], g5.nodes[1]
    carry = res_node.init_carry((STREAM_BATCH,), chunk5, device=dev)
    resampled = []
    for c in range(n5):
        carry, out = res_node.step(carry, x5[:, c * chunk5 : (c + 1) * chunk5])
        resampled.append(out)

    def bq_steps():
        s = bq_node.init_carry((STREAM_BATCH,), resampled[0].shape[-1], device=dev)
        for c in resampled:
            s, _ = bq_node.step(s, c)

    bq_t = device_ms(bq_steps, 1)
    all_t = device_ms(lambda: g5.scan_stream(x5, chunk5), 1)
    print(f"phase 17 timing ({card}): config 3 master chain {audio3:.1f} audio-s per run, {ms3:.3f} ms = "
          f"{audio3 / ms3 * 1e3:.0f} audio-s/s (runs, ms: {json.dumps(runs3)}); config 5 {audio5:.1f} audio-s per "
          f"run, kernel path {med['kernel']:.2f} ms = {audio5 / med['kernel'] * 1e3:.0f} audio-s/s, plain "
          f"composition {med['plain']:.2f} ms = {audio5 / med['plain'] * 1e3:.0f} audio-s/s (runs, ms: "
          f"{json.dumps(times)}); BiquadChain {timed(bq_t)} of the kernel path's {timed(all_t)} device time: "
          f"{bq_t[0] / all_t[0]:.1%}; BiquadChain's device events a chunk {bq_t[2] / n5:.1f}")
    return launches5


def file_path(dev: torch.device, card: str) -> dict:
    """Phases 18-21: the file path of the headline graph, host decode ->
    staging ring -> batch runner -> graph on the card -> sinks, through
    ``audioflow run``. Returns the numbers for the kernels line."""
    import dataclasses
    import os
    import tempfile

    from audioflow_torch import runner
    from audioflow_torch.config import graph_to_spec
    from audioflow_torch.io import BatchLoader, decode_batch, native, write_wav
    from audioflow_torch.models import eq_bands_default, log_mel_frontend
    from audioflow_torch.ops.kernels import melspec
    from audioflow_torch.profiling import tone_batch
    from audioflow_torch.sinks import ArraySink

    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as tmp:
        # phase 18: the native decoder, and the files of phase 19
        x_np = tone_batch(FILES, SECONDS, RATE, SEED)
        names = [f"f{i:03d}.wav" for i in range(FILES)]
        for name, row in zip(names, x_np):
            write_wav(os.path.join(tmp, name), row, RATE)
        with open(os.path.join(tmp, CORRUPT), "wb") as f:
            f.write(b"RIFF\x24\x00\x00\x00WAVEfmt \x10\x00\x00\x00truncated")
        write_wav(os.path.join(tmp, OFF_RATE), tone_batch(1, SECONDS, 48000, SEED + 1)[0], 48000)
        del x_np
        files = sorted(os.path.join(tmp, n) for n in os.listdir(tmp))
        mb = sum(os.path.getsize(f) for f in files) / 1e6
        t0 = time.perf_counter()
        check(native.available(), f"native decoder: {native.load_error()}")
        ready_s = time.perf_counter() - t0
        built = (f"g++ {native.STATS.build_seconds:.2f} s" if native.STATS.build_seconds is not None
                 else "already built in build/")
        stride = 1024 * -(-int(SECONDS * 48000) // 1024)  # the CLI's stride: the longest file, the 48 kHz one
        nat = decode_batch(files, stride=stride, use_native=True)
        npy = decode_batch(files, stride=stride, use_native=False)
        same = all(np.array_equal(getattr(nat, k), getattr(npy, k)) for k in ("samples", "lengths", "rates", "valid"))
        check(same, "native and numpy batch decoders differ")
        bad = [os.path.basename(p) for p, v in zip(files, nat.valid) if not v]
        check(bad == [CORRUPT], f"failed lanes {bad}")
        del npy
        print(f"phase 18 native decoder: {native.library_path().name} ({built}), ready in {ready_s:.2f} s; "
              f"{len(files)} files ({mb:.1f} MB) decoded natively and by numpy into [{len(files)}, {stride}]: "
              f"bit-equal (samples, lengths, rates, valid); failed lanes {bad}")

        # phase 19: audioflow run -g logmel over the files, in the process
        glob = os.path.join(tmp, "*.wav")
        g = log_mel_frontend(RATE, 16000, 1024, 256, 128)
        batches = -(-len(files) // FILE_BATCH)
        calls = native.STATS.calls
        melspec.COUNT.launches = 0
        line = run_cli(["run", "-i", glob, "-g", "logmel", "--batch-size", str(FILE_BATCH),
                        "-o", os.path.join(tmp, "logmel.npy"), "--stats", os.path.join(tmp, "stats.json")])[-1]
        launches = melspec.COUNT.launches
        check(native.STATS.calls - calls == batches, f"native decoder calls {native.STATS.calls - calls}")
        # one launch a batch, and one for the runner's warm-up call of the first
        check(launches == batches + 1, f"melspec launched {launches} times for {batches} batches and a warm-up")
        check((line["files"], line["failed_files"], line["batches"]) == (len(files), 2, batches),
              f"run line {line}")
        got = np.load(os.path.join(tmp, "logmel.npy"))
        ok = nat.valid & (nat.rates == RATE)
        check(got.shape[0] == int(ok.sum()) == FILES and np.isfinite(got).all(), f"run output {got.shape}")

        def offline(graph):
            """The graph called directly on the card on the decoded samples, in
            the run's batches (the tail zero-padded to a full batch), valid
            lanes kept."""
            rows = []
            for b in range(0, len(files), FILE_BATCH):
                x = np.zeros((FILE_BATCH, stride), np.float32)
                x[: min(FILE_BATCH, len(files) - b)] = nat.samples[b : b + FILE_BATCH]
                y = graph.chain(torch.from_numpy(x).to(dev)).cpu().numpy()
                rows.append(y[: len(files) - b][ok[b : b + FILE_BATCH]])
            return np.concatenate(rows)

        want = offline(g)
        err = float(np.abs(got - want).max())
        check(err <= FILE_TOL, f"run -g logmel vs the graph called directly max|d| {err} > {FILE_TOL}")
        # the masked lanes, through the runner's own step on their batches
        loader = BatchLoader(files, FILE_BATCH, stride=stride)
        zeros = []
        for batch in loader:
            out = runner.run_batch(g, batch, stride, FILE_BATCH, RATE, dev)
            for i, p in enumerate(batch.paths):
                if os.path.basename(p) in (CORRUPT, OFF_RATE):
                    zeros.append(bool((out[i] == 0).all()))
        check(zeros == [True, True], f"masked lanes all zero: {zeros}")
        print(f"phase 19 run -g logmel --batch-size {FILE_BATCH}: {line['files']} files -> {got.shape}, "
              f"failed_files {line['failed_files']}, batches {line['batches']} through a ring of "
              f"{loader.prefetch + 3} slots; native decoder calls {batches}; melspec launches {launches} = "
              f"batches {batches} + 1 warm-up; vs log_mel_frontend(44100, 16000, 1024, 256, 128) called directly on the "
              f"decoded samples in the same batches: max|d| {err:.3e} (tol {FILE_TOL}); the corrupt and "
              f"48 kHz lanes all zero {zeros}")
        del got, want

        # phase 20: config 5 through --spec
        g5 = log_mel_frontend(RATE, 16000, 1024, 256, 128, eq=eq_bands_default(16000))
        spec = os.path.join(tmp, "config5.json")
        with open(spec, "w") as f:
            json.dump(dataclasses.asdict(graph_to_spec(g5)), f)
        melspec.COUNT.launches = 0
        line5 = run_cli(["run", "-i", glob, "--spec", spec, "--batch-size", str(FILE_BATCH),
                         "-o", os.path.join(tmp, "config5.npy"), "--stats", os.path.join(tmp, "stats.json")])[-1]
        launches5 = melspec.COUNT.launches
        check(launches5 == batches + 1, f"config 5: melspec launched {launches5} times for {batches} batches + 1")
        got5 = np.load(os.path.join(tmp, "config5.npy"))
        err5 = float(np.abs(got5 - offline(g5)).max())
        check(got5.shape[0] == FILES and err5 <= FILE_TOL, f"config 5 spec run {got5.shape}: max|d| {err5}")
        print(f"phase 20 run --spec config5.json ({[type(n).__name__ for n in g5.nodes]}): {line5['files']} files "
              f"-> {got5.shape}, failed_files {line5['failed_files']}, melspec launches {launches5}; vs the graph "
              f"called directly: max|d| {err5:.3e} (tol {FILE_TOL})")
        del got5, nat

        # phase 21: timing (printed, no bound). Host decode of one batch into
        # a warm staging buffer; the copy to the card (from page-locked memory,
        # as the runner's ring holds it on the card, and from pageable memory)
        # and the graph on one batch by CUDA events, whose sum is the device
        # time of a batch; the file path end to end through run_batches with
        # its page-locked ring and with a pageable one, alternated
        buf = np.empty((FILE_BATCH, stride), np.float32)
        decode_s = [decode_batch(files[:FILE_BATCH], stride=stride, out=buf).decode_seconds for _ in range(3)]
        decode_ms = float(np.median(decode_s)) * 1e3
        x_page = torch.from_numpy(buf)
        x_pin = x_page.pin_memory()
        copy_ms = cuda_ms(lambda: x_pin.to(dev, non_blocking=True), 5, warmup=1)
        copy_page_ms = cuda_ms(lambda: x_page.to(dev, non_blocking=True), 5, warmup=1)
        xd = x_pin.to(dev)
        vd = torch.ones(FILE_BATCH, dtype=torch.bool, device=dev)
        graph_ms = cuda_ms(lambda: runner.mask_lanes(g.chain(xd), vd), 5, warmup=1)
        del xd, x_pin
        batch_dev_ms = copy_ms + graph_ms

        class PageableLoader(BatchLoader):
            """The ring in pageable memory on the card too."""

            def batches(self, pin_memory: bool = False):
                return super().batches(pin_memory=False)

        e2e = {"page-locked": [], "pageable": []}
        for kind in ("page-locked", "pageable", "pageable", "page-locked", "page-locked", "pageable"):
            cls = BatchLoader if kind == "page-locked" else PageableLoader
            m = runner.run_batches(g, cls(files, FILE_BATCH, stride=stride), sinks=[ArraySink()],
                                   expect_rate=RATE, device=dev)
            e2e[kind].append(m.realtime_factor)
        print(f"phase 21 timing ({card}): run -g logmel {line['audio_seconds']:.1f} audio-s in "
              f"{line['wall_seconds']:.3f} s = {line['realtime_factor']:.0f} audio-s/s (warm-up call of the first "
              f"batch {line['compile_seconds']:.3f} s, left out); per batch of {FILE_BATCH} x {stride}: host decode "
              f"{decode_ms:.2f} ms (readings, s: {json.dumps(decode_s)}), copy to the card {copy_ms:.2f} ms from "
              f"page-locked memory ({copy_page_ms:.2f} ms pageable), graph on the card {graph_ms:.2f} ms; device "
              f"time a batch (copy + graph, CUDA events) {batch_dev_ms:.2f} ms against {decode_ms:.2f} ms of "
              f"decode: {'decode' if decode_ms > batch_dev_ms else 'the card'} sets the pace; device busy share "
              f"of the run {line['batches'] * batch_dev_ms / 1e3 / line['wall_seconds']:.1%} (batches x device "
              f"time a batch / wall); run_batches end to end, audio-s/s, page-locked ring "
              f"{json.dumps([round(r, 1) for r in e2e['page-locked']])}, pageable ring "
              f"{json.dumps([round(r, 1) for r in e2e['pageable']])}")
    return {"launches_file_path": launches, "launches_config5_spec": launches5}


def _speech_batch(batch: int, seconds: float, rate: int, seed: int, floor_db: float = -100.0,
                  with_mask: bool = False):
    """A seeded speech-like batch: per row, tone-and-noise bursts of 0.2-1.2 s
    (about -20 dBFS in the VAD's mean-square measure) between silences of
    0.4-1.5 s (a noise floor at ``floor_db``, by default near -100 dBFS, well
    clear of the VAD's -50 dB threshold). With ``with_mask`` also the
    boolean mask of the burst samples."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    x = (10 ** (floor_db / 20) * rng.standard_normal((batch, n))).astype(np.float32)
    mask = np.zeros(x.shape, bool)
    for row, row_mask in zip(x, mask):
        pos = int(rng.uniform(0.1, 0.6) * rate)
        while pos < n:
            m = min(n - pos, int(rng.uniform(0.2, 1.2) * rate))
            t = np.arange(m, dtype=np.float32) / rate
            row[pos : pos + m] += (0.3 * np.sin(2 * np.pi * rng.uniform(120, 900) * t)
                                   + 0.05 * rng.standard_normal(m)).astype(np.float32)
            row_mask[pos : pos + m] = True
            pos += m + int(rng.uniform(0.4, 1.5) * rate)
    return (x, mask) if with_mask else x


def dictation(dev: torch.device, card: str) -> dict:
    """Phases 22-25: the validate report, the stream session at the JAX
    bench's width, the dictation fork through a session, and the egress over
    a loopback WebSocket. Returns the launch counts for the kernels line."""
    import contextlib
    import io
    import os
    import tempfile

    from audioflow_torch import cli
    from audioflow_torch.graph import LogMelSpec, QuantizeI16, Resample, Vad, VadGate, chain, fork
    from audioflow_torch.io import write_wav
    from audioflow_torch.models import log_mel_frontend
    from audioflow_torch.ops import quantize_i16
    from audioflow_torch.ops.kernels import griffinlim, melspec, timestretch, viterbi
    from audioflow_torch.profiling import aten_ops, profile, tone_batch
    from audioflow_torch.session import StreamSession
    from audioflow_torch.sinks import pcm_f32_to_i16_bytes
    from audioflow_torch.validate import BUDGETS, ROWS_MISSING, run_validation, within_budget

    root = os.path.dirname(os.path.abspath(__file__))
    kernels = {"melspec": melspec, "timestretch": timestretch, "griffinlim": griffinlim, "viterbi": viterbi}
    out = {}

    # phase 22: validate. In the process, with the launches counted from 0,
    # then as the CLI in a subprocess, whose exit code is the verdict
    for k in kernels.values():
        k.COUNT.launches = 0
    report = run_validation(device=dev)
    torch.cuda.synchronize()
    out["launches_validate"] = {name: k.COUNT.launches for name, k in kernels.items()}
    check(all(out["launches_validate"].values()), f"validate launches {out['launches_validate']}")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    proc = subprocess.run([sys.executable, "-m", "audioflow_torch.cli", "validate"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"audioflow validate exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    cli_report = json.loads(proc.stdout)
    rows = {k: v for k, v in cli_report.items() if k not in ("pass", "max_abs_err", "rows_missing")}
    check(len(rows) == 23 and ROWS_MISSING == () and cli_report["rows_missing"] == [] and cli_report["pass"],
          f"validate report rows {sorted(rows)}, missing {cli_report['rows_missing']}")
    bad = [k for k, v in {**rows, "max_abs_err": cli_report["max_abs_err"]}.items() if not within_budget(k, v)]
    check(not bad and report["pass"], f"validate rows over budget: {bad}")
    print(f"phase 22 validate on the card ({card}): `audioflow validate` exit 0, pass {cli_report['pass']}; "
          f"{len(rows)} rows, missing {len(cli_report['rows_missing'])} {cli_report['rows_missing']}; row (budget): "
          + ", ".join(f"{k} {v:.3e} ({BUDGETS.get(k, ('<', 1e-4))[0]} {BUDGETS.get(k, ('<', 1e-4))[1]})"
                      for k, v in {**rows, "max_abs_err": cli_report["max_abs_err"]}.items())
          + f"; in-process launches {json.dumps(out['launches_validate'])}")

    # phase 23: the session at the JAX bench's width (bench.py:196-245):
    # per-chunk pushes and 8-chunk block pushes, each against scan_stream
    g = log_mel_frontend(RATE, 16000, 1024, 256, 128)
    gran = g.chunk_granularity()
    chunk = gran * max(1, 16384 // gran)
    x_np = tone_batch(SESSION_BATCH, SECONDS, RATE, SEED)
    n_all = x_np.shape[-1] // chunk
    x_np = np.ascontiguousarray(x_np[:, : n_all * chunk])
    want_all = g.scan_stream(torch.from_numpy(x_np).to(dev), chunk).cpu().numpy()
    per_chunk_out = want_all.shape[1] // n_all
    session_rows = {}
    for name, block, cap in (("per-chunk", chunk, None), ("8-chunk blocks", 8 * chunk, 17 * chunk)):
        # whole blocks of the signal, as the JAX bench: a prefix of the stream
        n_chunks = n_all // (block // chunk) * (block // chunk)
        want = want_all[:, : n_chunks * per_chunk_out]
        melspec.COUNT.launches = 0
        sess = StreamSession(g, chunk, lead_shape=(SESSION_BATCH,), ring_capacity=cap, device=dev).open()
        for i in range(0, n_chunks * chunk, block):
            sess.push(x_np[:, i : i + block])
        res = sess.poll_all()
        launches = melspec.COUNT.launches
        got = np.concatenate([r.data for r in res], axis=1)
        check(len(res) == n_chunks and [r.index for r in res] == list(range(n_chunks)), f"{name}: {len(res)} results")
        check(np.array_equal(got, want), f"session {name} vs scan_stream max|d| {np.abs(got - want).max()}")
        check(launches == n_chunks + 1, f"session {name}: melspec launched {launches} times for {n_chunks} chunks + 1")
        # throughput: one pass of pushes after a warm one, the last result
        # copied to the host as the sync; latency: per push, with the host
        # copy of its last result, as the JAX bench's latency loop
        t0 = time.perf_counter()
        for i in range(0, n_chunks * chunk, block):
            sess.push(x_np[:, i : i + block])
        res = sess.poll_all()
        res[-1].data.sum()
        wall = time.perf_counter() - t0
        lat = []
        for _ in range(3):
            for i in range(0, n_chunks * chunk, block):
                tb = time.perf_counter()
                sess.push(x_np[:, i : i + block])
                res = sess.poll_all()
                res[-1].data.sum()
                lat.append((time.perf_counter() - tb) / (block // chunk) * 1e3)

        def one_pass(sess=sess, block=block):
            for i in range(0, n_chunks * chunk, block):
                sess.push(x_np[:, i : i + block])
            sess.poll_all()[-1].data.sum()

        prof = profile(one_pass)
        top = ", ".join(f"{k['name'][:40]} {k['share']:.1%}" for k in prof["kernels"][:4])
        sess.close()
        audio = SESSION_BATCH * n_chunks * chunk / RATE
        session_rows[name] = {"audio_s_per_s": audio / wall, "p50_ms": float(np.percentile(lat, 50)),
                              "p99_ms": float(np.percentile(lat, 99)), "idle_untraced": prof["idle_untraced"],
                              "idle_traced": prof["idle_traced"], "launches": launches}
        print(f"phase 23 session {name} ({card}): log_mel_frontend(44100, 16000, 1024, 256, 128), lead "
              f"({SESSION_BATCH},), chunk {chunk}, {n_chunks} chunks: results exactly equal to scan_stream, melspec "
              f"launches {launches} = chunks {n_chunks} + 1 warm-up; {audio / wall:.0f} audio-s/s ({audio:.1f} "
              f"audio-s in {wall * 1e3:.1f} ms); per chunk with the host copy p50 {np.percentile(lat, 50):.3f} ms, "
              f"p99 {np.percentile(lat, 99):.3f} ms; card idle {prof['idle_untraced']:.1%} untraced, "
              f"{prof['idle_traced']:.1%} traced ({prof['launches']} device events a pass, busy "
              f"{prof['busy_ms']:.3f} ms; {top})")
    out["launches_session"] = session_rows["per-chunk"]["launches"]
    out["session"] = session_rows
    del x_np, want, want_all

    # phase 24: the dictation fork (SURVEY 3.3) through a session, pushed at
    # the capture cadence (20 ms), snapshot halfway and restored
    def dictation_fork(branches):
        return fork(chain(Resample(48000, 16000, "kaiser"), input_rate=48000), **branches)

    full = {
        "wire": chain(VadGate(320), QuantizeI16(), input_rate=16000),
        "vad": chain(Vad(320), input_rate=16000),
        "features": chain(LogMelSpec(1024, 256, 128, center=False), input_rate=16000),
    }
    f = dictation_fork(full)
    x48 = _speech_batch(SESSION_BATCH, DICTATION_SECONDS, 48000, SEED)
    push = 960
    n_push = x48.shape[-1] // push

    def drive(sess, first, last):
        for p in range(first, last):
            sess.push(x48[:, p * push : (p + 1) * push])
        return sess.poll_all()

    melspec.COUNT.launches = 0
    sess = StreamSession(f, lead_shape=(SESSION_BATCH,), device=dev).open()
    chunk48 = sess.chunk_in
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_a = drive(sess, 0, n_push)
    res_a[-1].data
    push_ms = (time.perf_counter() - t0) / n_push * 1e3
    sess.flush()
    res_a += sess.poll_all()
    sess.close()
    launches_d = melspec.COUNT.launches
    n_res = len(res_a)
    check(n_res == -(-x48.shape[-1] // chunk48) and launches_d == n_res + 1,
          f"dictation: {n_res} results, melspec launched {launches_d} times")
    cat = {k: np.concatenate([r.data[k] for r in res_a], axis=1) for k in full}
    pad = n_res * chunk48 - x48.shape[-1]
    xd = torch.nn.functional.pad(torch.from_numpy(x48).to(dev), (0, pad))
    scan = {k: v.cpu().numpy() for k, v in f.scan_stream(xd, chunk48).items()}
    for k in full:
        check(np.array_equal(cat[k], scan[k]), f"dictation branch {k}: session vs Fork.scan_stream differ")
    # snapshot halfway, restore into a fresh session, finish the stream
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as tmp:
        sess = StreamSession(f, lead_shape=(SESSION_BATCH,), device=dev).open()
        first = drive(sess, 0, n_push // 2)
        sess.snapshot(os.path.join(tmp, "half"))
        pending = sess._pending
        sess.close()
        resumed = StreamSession(f, lead_shape=(SESSION_BATCH,), device=dev).restore(os.path.join(tmp, "half"))
        tail = drive(resumed, n_push // 2, n_push)
        resumed.flush()
        tail += resumed.poll_all()
    check([r.index for r in tail] == list(range(len(first), n_res)), "restored session's result indices")
    for r in tail:
        for k in full:
            check(np.array_equal(r.data[k], res_a[r.index].data[k]), f"restored tail, chunk {r.index} {k} differs")
    # the card against the CPU: VAD states exactly, i16 within 1 LSB
    cpu = dictation_fork({k: full[k] for k in ("wire", "vad")}).scan_stream(xd.cpu(), chunk48)
    vad_cpu, wire_cpu = cpu["vad"].numpy(), cpu["wire"].numpy()
    check(np.array_equal(scan["vad"], vad_cpu), "dictation VAD states: card vs CPU differ")
    lsb = int(np.abs(scan["wire"].astype(np.int32) - wire_cpu).max())
    check(lsb <= 1, f"dictation i16: card vs CPU {lsb} LSB")
    states = np.unique(scan["vad"])
    check(set(states.tolist()) == {0, 1, 2}, f"dictation VAD states {states}")
    specials = torch.tensor([np.nan, np.inf, -np.inf, 0.99999, -0.99999, 1.5, -1.5, 0.5, 0.0])
    q_card, q_cpu = quantize_i16(specials.to(dev)).cpu(), quantize_i16(specials)
    check(torch.equal(q_card, q_cpu) and q_card[:4].tolist() == [0, 32767, -32767, 32766],
          f"quantize_i16 of NaN, +-inf on the card {q_card.tolist()} vs the CPU {q_cpu.tolist()}")
    # the VAD's launches per chunk: one Vad and one VadGate step on one
    # resampled chunk (4 frames of 320), every aten op counted
    mid = chunk48 // 3
    y_mid = xd[:, :mid] * 0 + 0.1
    vad_ops = aten_ops(lambda: Vad(320).step(Vad(320).init_carry((SESSION_BATCH,), mid, device=dev), y_mid))
    gate_ops = aten_ops(lambda: VadGate(320).step(VadGate(320).init_carry((SESSION_BATCH,), mid, device=dev), y_mid))
    step_ops = aten_ops(lambda: f.stream_step(f.init_state(chunk48, (SESSION_BATCH,), device=dev), xd[:, :chunk48]))
    # where a push's time goes: 200 pushes (50 chunks) of a warm session
    sess = StreamSession(f, lead_shape=(SESSION_BATCH,), device=dev).open()
    prof = profile(lambda: drive(sess, 0, 200)[-1].data)
    sess.close()
    top = ", ".join(f"{k['name'][:40]} {k['share']:.1%} ({k['calls']})" for k in prof["kernels"][:5])
    out["launches_dictation"] = launches_d
    out["dictation"] = {"push_ms": push_ms, "vad_ops_per_chunk": vad_ops, "gate_ops_per_chunk": gate_ops,
                        "step_ops": step_ops, "chunks": n_res}
    print(f"phase 24 dictation ({card}): fork(Resample(48000->16000, kaiser), wire=VadGate(320)+QuantizeI16, "
          f"vad=Vad(320), features=LogMelSpec(1024, 256, 128)) through a session, lead ({SESSION_BATCH},), "
          f"{DICTATION_SECONDS:.0f} s at 48 kHz in {n_push} pushes of {push}, chunk {chunk48}: {n_res} results, "
          f"every branch exactly equal to Fork.scan_stream; snapshot after {len(first)} chunks ({pending} samples "
          f"pending), restored tail of {len(tail)} exactly equal; VAD states {states.tolist()} equal to the CPU's, "
          f"i16 within {lsb} LSB of the CPU's; quantize_i16 of [nan, inf, -inf, 0.99999] on the card "
          f"{q_card[:4].tolist()}; melspec launches {launches_d} = chunks {n_res} + 1 warm-up; {push_ms:.3f} ms a "
          f"push ({push_ms * chunk48 / push:.3f} ms a chunk); aten ops a chunk: Vad {vad_ops}, VadGate {gate_ops}, "
          f"the whole fork step {step_ops}; 200 pushes under the profiler: {prof['untraced_ms']:.1f} ms, card busy "
          f"{prof['busy_ms']:.2f} ms, idle {prof['idle_untraced']:.1%} untraced, {prof['idle_traced']:.1%} traced, "
          f"{prof['launches']} device events; {top}")
    del xd, x48, scan, cat

    # phase 25: egress over a loopback WebSocket (127.0.0.1, ephemeral port)
    sys.path.insert(0, os.path.join(root, "tests"))
    from ws_loopback import ScribeServer

    def run_egress(wav, srv):
        buf = io.StringIO()
        srv.start()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["egress", "-i", wav, "--url", f"ws://127.0.0.1:{srv.port}/v1/scribe", "--vad-gate",
                           "--receive-timeout", "5.0"])
        srv.join(10)
        check(rc == 0 and not srv.is_alive(), f"audioflow egress exited {rc}")
        return [json.loads(line) for line in buf.getvalue().strip().splitlines()]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_egress_") as tmp:
        sig = _speech_batch(1, EGRESS_SECONDS, 48000, SEED + 7)[0]
        wav = os.path.join(tmp, "say48k.wav")
        write_wav(wav, sig, 48000)
        from audioflow_torch.io import read_audio

        data, _ = read_audio(wav)
        pcm = chain(VadGate(960), Resample(48000, 16000, "cubic"), input_rate=48000).compile()(data, device=dev)
        want_i16 = np.frombuffer(pcm_f32_to_i16_bytes(pcm.cpu().numpy()), "<i2")
        n_wire = -(-want_i16.size // 3200)
        srv = ScribeServer([{"reply": True}])
        lines = run_egress(wav, srv)
        got_i16 = np.concatenate(srv.audio[0])
        check(np.array_equal(got_i16, want_i16), "egress: the server's audio differs from the card's i16")
        check(lines[-1] == {"chunks_sent": n_wire, "results": 2}, f"egress summary {lines[-1]}")
        texts = [line.get("text") for line in lines[:-1]]
        check(texts == ["turn", "turn it on"] and srv.configures == 1, f"egress transcript {texts}")
        # one forced disconnect: the client reconnects, configures again and
        # resumes; the chunks that reached the server are the card's, in order
        srv2 = ScribeServer([{"drop_after_chunks": 3}, {"reply": True}])
        lines2 = run_egress(wav, srv2)
        chunks = [want_i16[i : i + 3200] for i in range(0, want_i16.size, 3200)]
        it = iter(range(len(chunks)))
        in_order = all(any(np.array_equal(c, chunks[j]) for j in it) for conn in srv2.audio for c in conn)
        received = sum(len(c) for c in srv2.audio)
        texts2 = [line.get("text") for line in lines2[:-1]]
        check(srv2.connections == 2 and srv2.configures == 2 and in_order and "turn it on" in texts2
              and lines2[-1]["chunks_sent"] == n_wire, f"egress with a disconnect: {srv2.connections} connections, "
              f"{srv2.configures} configures, in order {in_order}, transcript {texts2}, summary {lines2[-1]}")
    print(f"phase 25 egress ({card}): `audioflow egress --vad-gate` of a {EGRESS_SECONDS:.0f} s 48 kHz WAV to a "
          f"loopback server: {n_wire} chunks, the server's audio exactly the card's i16 ({want_i16.size} samples), "
          f"transcript {texts}; with a drop after 3 chunks: {srv2.connections} connections, {srv2.configures} "
          f"configures, {received} of {n_wire} chunks received in order, transcript {texts2}")
    return out


def _snr_db(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Round-trip SNR per row, as validate computes it."""
    e = y - x
    return 10.0 * np.log10((x**2).sum(axis=-1) / np.maximum((e**2).sum(axis=-1), 1e-30))


def _inband_snr_db(y: np.ndarray, x: np.ndarray, rate: int, lo_hz: float, hi_hz: float, trim: int) -> np.ndarray:
    """Round-trip SNR per row inside the CQT's band: output and input both
    limited to ``[lo_hz, hi_hz]`` (a mask on their FFTs, 32 rows at a time),
    then compared away from ``trim`` samples at each edge. The transform
    measures nothing outside its band (the tone batch's white noise reaches
    Nyquist), so an inverse can return only what lies inside it."""
    out = []
    f = np.fft.rfftfreq(x.shape[-1], 1.0 / rate)
    keep = (f >= lo_hz) & (f <= hi_hz)
    for i in range(0, x.shape[0], 32):
        yb, xb = (np.fft.irfft(np.fft.rfft(np.asarray(a[i : i + 32], np.float64)) * keep, x.shape[-1])
                  for a in (y, x))
        out.append(_snr_db(yb[:, trim:-trim], xb[:, trim:-trim]))
    return np.concatenate(out)


def _click_batch(bpms, n: int, rate: int, seed: int) -> np.ndarray:
    """Click tracks of ``n`` samples at ``bpms``: 10 ms noise bursts at each
    beat over -40 dB noise (tests/test_torch_rhythm.py's ``_click_audio``)."""
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal((len(bpms), n))
    burst = rng.standard_normal(160) * np.hanning(160)
    for row, bpm in zip(x, bpms):
        for s in np.arange(0.0, n - 160, 60.0 * rate / bpm):
            row[int(s) : int(s) + 160] += burst
    return x.astype(np.float32)


def _dp_clear_from(env: torch.Tensor, rate: int) -> list:
    """Per lane of ``env [B, T]`` (on the CPU), the first frame from which
    the beat DP's decisions clear DP_MARGIN (tests/decision_margins.py):
    a best predecessor or its sign unclear at a beat of the CPU's path can
    move every beat before it, so the frames up to it are left out; an
    unclear tempo lag or best final beat leaves the lane out (None)."""
    from audioflow_torch.ops import rhythm

    max_lag = min(int(round(8.0 * rate / 256)), env.shape[-1] - 1)
    ac = rhythm.autocorrelate(env, max_lag=max_lag).double()
    prior = rhythm._bpm_prior(rhythm.tempo_frequencies(max_lag + 1, rate, 256), 120.0, 1.0, 320.0)
    lags = (ac * torch.from_numpy(prior.astype(np.float32)).double()).topk(2, dim=-1).values
    tempo_ok = (lags[:, 0] - lags[:, 1]) / lags[:, 0] > LAG_MARGIN
    dp = rhythm._beat_dp(env, rate, 256, None, 100.0, 256, 120.0)
    mask = rhythm._backtrace(dp["scores"], dp["backgaps"])
    scores, cost = dp["scores"].double(), dp["cost"].double()
    w = cost.shape[-1]
    buf = torch.cat([scores.new_full((scores.shape[0], w), -np.inf), scores[:, :-1]], dim=-1)
    top = (buf.unfold(-1, w, 1) + cost[:, None, :]).topk(2, dim=-1).values  # [B, T, 2]
    gap_ok = ~torch.isfinite(top[..., 0]) | (top[..., 0] - top[..., 1] > DP_MARGIN)
    sign_ok = ~torch.isfinite(top[..., 0]) | (top[..., 0].abs() > DP_MARGIN)
    unclear = mask & ~(gap_ok & sign_ok)
    last = scores.topk(2, dim=-1).values
    last_ok = last[:, 0] - last[:, 1] > DP_MARGIN
    out = []
    for b in range(env.shape[0]):
        if not (bool(tempo_ok[b]) and bool(last_ok[b])):
            out.append(None)
            continue
        bad = torch.nonzero(unclear[b]).flatten()
        out.append(int(bad[-1]) + 1 if bad.numel() else 0)
    return out


def _online_clear_until(env: np.ndarray, plan, env_diff: float) -> np.ndarray:
    """Per lane of ``env [B, T]``, the first aligned frame that an unclear
    decision of the causal tracker can reach (T where none is), from a
    float64 run of its state (tests/decision_margins.py's
    ``online_margins_clear``, per lane): a flipped peak test or best lag
    changes the beat clock from that step on."""
    b, n = env.shape
    e64 = env.astype(np.float64)
    acf = np.zeros((b, plan.max_lag + 1))
    ring = np.zeros_like(acf)
    win = np.zeros((b, plan.pre + plan.post + 1))
    emean = np.zeros(b)
    prior = plan.prior.astype(np.float64)
    slack = ENV_MARGIN + 2 * env_diff
    until = np.full(b, n)
    for t in range(n):
        e = e64[:, t]
        ring = np.concatenate([e[:, None], ring[:, :-1]], 1)
        acf = plan.rho * acf + e[:, None] * ring
        s = np.sort(acf * prior, axis=-1)
        lag_bad = (s[:, -1] > 0) & ((s[:, -1] - s[:, -2]) <= (LAG_MARGIN + 4 * env_diff) * s[:, -1])
        win = np.concatenate([e[:, None], win[:, :-1]], 1)
        cand = win[:, plan.post]
        over = cand - (emean + plan.delta)
        runner = cand - np.delete(win, plan.post, axis=1).max(axis=1)
        peak_bad = ((over > -slack) & (np.abs(runner) <= slack)) | ((runner > -slack) & (np.abs(over) <= slack))
        hit = (lag_bad | peak_bad) & (until == n)
        until[hit] = max(0, t - plan.post)
        emean = 0.95 * emean + 0.05 * e
    return until


def cqt_rhythm(dev: torch.device, card: str) -> dict:
    """Phases 31-33: the CQT family and the rhythm family through the port's
    entry points: the CQT and its three inverses on the card against the CPU
    and validate's budgets, ``audioflow run -g cqt|cqtroundtrip|onset|beats``
    over phase 19's files, the tempo of click tracks, the beat DP on the card
    against the CPU, and the streaming beat graph. Returns their numbers."""
    import os
    import tempfile

    import torch.nn.functional as F

    from audioflow_torch import cli, ops
    from audioflow_torch.config import ConfigManager
    from audioflow_torch.graph import MelProject, OnlineBeats, OnsetStrength, Spectrogram, Tempo, chain
    from audioflow_torch.io import decode_batch, write_wav
    from audioflow_torch.models import cqt_frontend, onset_frontend
    from audioflow_torch.ops import cqt_mod, rhythm
    from audioflow_torch.ops.kernels import griffinlim, melspec, timestretch, viterbi
    from audioflow_torch.profiling import aten_ops, profile, tone_batch

    kernels = {"melspec": melspec, "timestretch": timestretch, "griffinlim": griffinlim, "viterbi": viterbi}
    for k in kernels.values():
        k.COUNT.launches = 0
    out = {}

    def rel(got: torch.Tensor, want: torch.Tensor) -> float:
        return float((got.cpu() - want).abs().max() / want.abs().max())

    def peak_mb(fn) -> float:
        """Device memory that one call of ``fn`` takes beyond what is held."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e6

    # phase 31: the CQT on the card, at the framework default on 64 x 10 s
    x_np = tone_batch(CQT_BATCH, SECONDS, 16000, SEED)
    x = torch.from_numpy(x_np).to(dev)
    x4 = torch.from_numpy(x_np[:4])
    audio = CQT_BATCH * SECONDS
    impls = {}
    for impl in ("onedot", "split", "direct"):
        err = rel(ops.cqt(x[:4], 16000, impl=impl, output="complex"), ops.cqt(x4, 16000, impl=impl, output="complex"))
        check(err <= CQT_TOL, f"cqt impl={impl} on the card vs the CPU {err} > {CQT_TOL}")
        ms = cuda_ms(lambda impl=impl: ops.cqt(x, 16000, impl=impl), 5)
        impls[impl] = {"err": err, "ms": ms, "audio_s_per_s": audio / ms * 1e3,
                       "peak_mb": peak_mb(lambda impl=impl: ops.cqt(x, 16000, impl=impl)),
                       "aten_ops": aten_ops(lambda impl=impl: ops.cqt(x, 16000, impl=impl))}
    f0, _, bank = cqt_mod._design(16000, 256, 84, cqt_mod.FMIN_C1, 12, "hann", 1.0)
    xp = F.pad(x, (f0 // 2, f0 - f0 // 2))
    n_fr = (xp.shape[-1] - f0) // 256 + 1
    forms = {}
    for form in ("conv", "unfold"):
        forms[form] = {"ms": cuda_ms(lambda form=form: cqt_mod._framed_dot(xp, bank, 256, n_fr, form), 5),
                       "peak_mb": peak_mb(lambda form=form: cqt_mod._framed_dot(xp, bank, 256, n_fr, form))}
    form_err = rel(cqt_mod._framed_dot(xp, bank, 256, n_fr, "conv"), cqt_mod._framed_dot(xp, bank, 256, n_fr, "unfold").cpu())
    check(form_err <= CQT_TOL, f"cqt product forms differ by {form_err}")
    flops = 2.0 * CQT_BATCH * n_fr * f0 * bank.shape[1]
    onedot_bound, onedot_by = bound_ms(flops, 4.0 * (xp.numel() + bank.size + CQT_BATCH * n_fr * bank.shape[1]))
    chroma_err = rel(ops.chroma_cqt(x[:4], 16000), ops.chroma_cqt(x4, 16000))
    check(chroma_err <= CQT_TOL, f"chroma_cqt on the card vs the CPU {chroma_err}")
    # cqt_frontend streamed in 16,384-sample chunks against offline
    g = cqt_frontend(16000)
    xs = F.pad(x, (0, -x.shape[-1] % EFFECTS_CHUNK))
    lat = g.stream_latency(EFFECTS_CHUNK)
    streamed = g.scan_stream(xs, EFFECTS_CHUNK)
    offline = g.chain(xs)
    n_st = streamed.shape[1] - lat
    stream_err = rel(streamed[:, lat:], offline[:, :n_st].cpu())
    check(stream_err <= CQT_TOL, f"cqt_frontend streamed vs offline {stream_err} > {CQT_TOL}")
    stream_ms = cuda_ms(lambda: g.scan_stream(xs, EFFECTS_CHUNK), 1, warmup=1)
    state = g.init_state(EFFECTS_CHUNK, (CQT_BATCH,), device=dev)
    chunk_ops = aten_ops(lambda: g.stream_step(state, xs[:, :EFFECTS_CHUNK]))
    del streamed, offline, xp
    print(f"phase 31 cqt ({card}): the framework default (84 bins from C1, hop 256, F0 {f0}) on {CQT_BATCH} x "
          f"{x.shape[-1]} at 16 kHz; per impl (card vs CPU on 4 lanes, complex, tol {CQT_TOL}; magnitude ms by CUDA "
          f"events; peak MB beyond the input; aten ops a call): "
          + "; ".join(f"{k} {v['err']:.2e}, {v['ms']:.3f} ms = {v['audio_s_per_s']:.0f} audio-s/s, "
                      f"{v['peak_mb']:.1f} MB, {v['aten_ops']} ops" for k, v in impls.items())
          + f"; the onedot product as a hop-block conv {forms['conv']['ms']:.3f} ms, {forms['conv']['peak_mb']:.1f} MB"
          f" against the matmul on the framed view {forms['unfold']['ms']:.3f} ms, {forms['unfold']['peak_mb']:.1f} MB"
          f" (differ {form_err:.2e}); its bound {onedot_bound:.3f} ms ({onedot_by}: {flops / 1e9:.1f} GFLOP); "
          f"chroma_cqt vs CPU {chroma_err:.2e}; cqt_frontend streamed in {EFFECTS_CHUNK}-sample chunks vs offline "
          f"{stream_err:.2e} at latency {lat} frames, {stream_ms:.1f} ms = {audio / stream_ms * 1e3:.0f} audio-s/s, "
          f"{chunk_ops} aten ops a chunk")
    out["cqt"] = {"impls": impls, "forms": forms, "bound_ms": onedot_bound, "stream_ms": stream_ms}

    # the three inverses at validate's configs and budgets, then timed at 64 x 10 s
    rng = np.random.default_rng(SEED)
    fr48 = ops.cqt_frequencies(48, 110.0)
    xt = np.stack([np.sin(2 * np.pi * fr48[k] * np.arange(24000) / 16000.0) for k in (0, 24, 47)]).astype(np.float32)
    yt = ops.icqt(ops.cqt(torch.from_numpy(xt).to(dev), 16000, 48, 48, 110.0, output="complex"), 16000, 48, 48, 110.0,
                  length=24000).cpu().numpy()
    snr_p = _snr_db(yt[:, 8000:16000], xt[:, 8000:16000])
    f84 = ops.cqt_frequencies(84)
    nv = np.arange(64000)
    zf = np.fft.rfft(rng.standard_normal(64000))
    fg = np.fft.rfftfreq(64000, 1.0 / 16000.0)
    zf[(fg < 800.0) | (fg > 2000.0)] = 0
    noise = np.fft.irfft(zf, 64000)
    noise /= np.abs(noise).max() * 2.0
    harm = sum((0.5 / (i + 1)) * np.sin(2 * np.pi * 150.0 * (i + 1) * nv / 16000.0) for i in range(12))
    hyb_bins = (0, 1, 21, 41, 42, 43, 44, 63, 82, 83)
    xh = np.stack([np.sin(2 * np.pi * f84[k] * nv / 16000.0) for k in hyb_bins] + [noise, harm]).astype(np.float32)
    yh = ops.icqt(ops.cqt(torch.from_numpy(xh).to(dev), 16000, output="complex"), 16000, length=64000).cpu().numpy()
    snr_h = _snr_db(yh[:, 17000:47000], xh[:, 17000:47000])
    xm = np.stack([noise, harm] + [np.sin(2 * np.pi * f84[k] * nv / 16000.0) for k in (0, 79, 80, 81, 83)])
    xm = xm.astype(np.float32)
    ym = ops.icqt(ops.cqt(torch.from_numpy(xm).to(dev), 16000, multirate=True, output="complex"), length=64000)
    snr_m = _snr_db(ym.cpu().numpy()[:, 17000:47000], xm[:, 17000:47000])
    check(snr_p.min() >= SNR_DB and snr_h[:10].min() >= SNR_DB and -25.0 < snr_h[10] < 10.0 and 0.0 < snr_h[11] < 25.0
          and snr_m.min() >= SNR_DB, f"round trips: painless {snr_p}, hybrid {snr_h}, multirate {snr_m}")
    trips = {
        "painless (hop 48, 48 bins from 110 Hz)": lambda: ops.icqt(
            ops.cqt(x, 16000, 48, 48, 110.0, output="complex"), 16000, 48, 48, 110.0, length=x.shape[-1]),
        "hybrid": lambda: ops.icqt(ops.cqt(x, 16000, output="complex"), 16000, length=x.shape[-1]),
        "multirate": lambda: ops.icqt(ops.cqt(x, 16000, multirate=True, output="complex")),
    }
    trip_rows = {}
    for name, fn in trips.items():
        trip_rows[name] = {"ms": cuda_ms(fn, 2, warmup=1), "peak_mb": peak_mb(fn), "aten_ops": aten_ops(fn)}
    y_mr = trips["multirate"]().cpu().numpy()
    band = (cqt_mod.FMIN_C1, float(ops.cqt_frequencies(84)[-1]))
    snr_big = _inband_snr_db(y_mr, x_np, 16000, *band, 17000)
    check(snr_big.min() >= SNR_DB, f"multirate round trip of the tone batch in its band: {snr_big.min():.2f} dB")
    del y_mr
    print(f"phase 31 icqt ({card}): at validate's configs the painless round trip {snr_p.min():.2f} dB worst tone, "
          f"the hybrid {snr_h[:10].min():.2f} dB worst tone, band noise {snr_h[10]:.2f} dB (band -25..10), harmonic "
          f"complex {snr_h[11]:.2f} dB (band 0..25), the multirate {snr_m.min():.2f} dB worst (budgets {SNR_DB} dB); "
          f"the multirate round trip of the {CQT_BATCH} x 10 s tone batch inside the CQT's band ({band[0]:.1f}-"
          f"{band[1]:.1f} Hz) {snr_big.min():.2f} dB worst lane; round "
          f"trips of {CQT_BATCH} x 10 s (CUDA events, peak MB, aten ops): "
          + "; ".join(f"{k} {v['ms']:.2f} ms = {audio / v['ms'] * 1e3:.0f} audio-s/s, {v['peak_mb']:.0f} MB, "
                      f"{v['aten_ops']} ops" for k, v in trip_rows.items()))
    out["icqt"] = {"snr_painless": float(snr_p.min()), "snr_hybrid_tone": float(snr_h[:10].min()),
                   "snr_hybrid_noise": float(snr_h[10]), "snr_hybrid_harm": float(snr_h[11]),
                   "snr_multirate": float(snr_m.min()), "snr_multirate_batch": float(snr_big.min()),
                   "trips": trip_rows}
    del x, x4

    # phases 32-33 over phase 19's 256 files
    cfg = ConfigManager().current()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cqt_") as tmp:
        x_np = tone_batch(FILES, SECONDS, RATE, SEED)
        for i, row in enumerate(x_np):
            write_wav(os.path.join(tmp, f"f{i:03d}.wav"), row, RATE)
        del x_np
        glob = os.path.join(tmp, "f*.wav")
        files = sorted(os.path.join(tmp, n) for n in os.listdir(tmp))
        stride = 1024 * -(-int(SECONDS * RATE) // 1024)
        decoded = decode_batch(files, stride=stride)
        buf = np.empty((FILE_BATCH, stride), np.float32)
        decode_s = [decode_batch(files[:FILE_BATCH], stride=stride, out=buf).decode_seconds for _ in range(3)]
        decode_ms = float(np.median(decode_s)) * 1e3
        x0 = torch.from_numpy(decoded.samples[:FILE_BATCH]).to(dev)
        # the onedot product's two forms at the file path's shape (32 x 10 s at 44.1 kHz)
        f0_44, _, bank44 = cqt_mod._design(RATE, 256, 84, cqt_mod.FMIN_C1, 12, "hann", 1.0)
        xp0 = F.pad(x0, (f0_44 // 2, f0_44 - f0_44 // 2))
        n44 = (xp0.shape[-1] - f0_44) // 256 + 1
        forms44 = {form: {"ms": cuda_ms(lambda form=form: cqt_mod._framed_dot(xp0, bank44, 256, n44, form), 3),
                          "peak_mb": peak_mb(lambda form=form: cqt_mod._framed_dot(xp0, bank44, 256, n44, form))}
                   for form in ("conv", "unfold")}
        del xp0
        print(f"phase 32 cqt product ({card}): onedot at [{FILE_BATCH}, {stride}], 44.1 kHz (F0 {f0_44}, {n44} "
              f"frames): hop-block conv {forms44['conv']['ms']:.3f} ms, {forms44['conv']['peak_mb']:.0f} MB; matmul on "
              f"the framed view {forms44['unfold']['ms']:.3f} ms, {forms44['unfold']['peak_mb']:.0f} MB")
        out["cqt"]["forms_44k"] = forms44
        runs = {}
        # phase 32: the CQT graphs; phase 33: the rhythm graphs
        for name, multirate in (("cqt", False), ("cqtroundtrip", False), ("cqtroundtrip", True), ("onset", False),
                                ("beats", False)):
            label = name + (" --multirate" if multirate else "")
            npy = os.path.join(tmp, f"{name}{'_mr' if multirate else ''}.npy")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            line = run_cli(["run", "-i", glob, "-g", name, *(["--multirate"] if multirate else []), "--batch-size",
                            str(FILE_BATCH), "-o", npy, "--stats", os.path.join(tmp, "stats.json")])[-1]
            peak = torch.cuda.max_memory_allocated() / 1e6
            got = np.load(npy, mmap_mode="r")
            graph = cli._build_graph(name, RATE, cfg, multirate=multirate)
            want = graph.chain(x0).cpu().numpy()
            check(got.shape[0] == FILES and got.shape[1:] == want.shape[1:] and np.isfinite(got[:FILE_BATCH]).all(),
                  f"run -g {label}: {got.shape} vs {want.shape}")
            err = float(np.abs(got[:FILE_BATCH] - want).max())
            check(err <= FILE_TOL, f"run -g {label}: the first batch vs the graph called directly max|d| {err}")
            graph_ms = cuda_ms(lambda graph=graph: graph.chain(x0), 3, warmup=1)
            row = {"audio_s_per_s": line["realtime_factor"], "graph_ms": graph_ms, "decode_ms": decode_ms,
                   "peak_mb": peak, "pace": "decode" if decode_ms > graph_ms else "the card"}
            extra = ""
            if row["pace"] == "the card":  # where its device time goes
                prof = profile(lambda graph=graph: graph.chain(x0))
                row.update(busy_ms=prof["busy_ms"], idle=prof["idle_untraced"], launches=prof["launches"],
                           top=[(k["name"][:60], round(k["share"], 4)) for k in prof["kernels"][:4]])
                extra += (f"; one batch under the profiler: busy {prof['busy_ms']:.2f} ms, idle "
                          f"{prof['idle_untraced']:.1%} untraced, {prof['launches']} device events, largest "
                          + ", ".join(f"{n} {sh:.1%}" for n, sh in row["top"]))
            if name == "cqtroundtrip" and multirate:
                # the steady part of each tone file: the joint dual spans nd/2 samples each side
                nd = cqt_mod._multirate_design(RATE, 256, 84, cqt_mod.FMIN_C1, 12, "hann", 1.0)["nd"]
                n = int(SECONDS * RATE)
                snr = _inband_snr_db(got[:, :n], decoded.samples[:, :n], RATE, *band, nd // 2)
                check(snr.min() >= SNR_DB, f"run -g cqtroundtrip --multirate: {snr.min():.2f} dB worst file")
                row["snr_db_worst"] = float(snr.min())
                extra += (f"; round trip of each file over its steady part, inside the CQT's band, {snr.min():.2f} dB "
                          f"worst (>= {SNR_DB})")
            runs[label] = row
            print(f"phase {32 if name.startswith('cqt') else 33} run -g {label} --batch-size {FILE_BATCH} ({card}): "
                  f"{line['files']} files of {SECONDS:.0f} s at {RATE} Hz -> {got.shape}, the first batch exactly the "
                  f"graph called directly (max|d| {err:.1e}); {line['realtime_factor']:.0f} audio-s/s; per batch host "
                  f"decode {decode_ms:.2f} ms (readings, s: {json.dumps(decode_s)}), graph on the card {graph_ms:.2f} "
                  f"ms (CUDA events): {row['pace']} sets the pace; peak device memory {peak:.0f} MB{extra}")
            del got, want
        out["runs"] = runs
        del decoded, x0

    # phase 33: the tempo of click tracks, the DP on the card against the
    # CPU, and the streaming beat graph over 64 click tracks of 30 s
    clicks = torch.from_numpy(_click_batch((90.0, 120.0, 150.0), 20 * 16000, 16000, SEED)).to(dev)
    tg = chain(*onset_frontend(16000).nodes, Tempo(hop=256), input_rate=16000)
    bpm = tg.chain(clicks).flatten().cpu().numpy()
    check(np.abs(bpm - [90.0, 120.0, 150.0]).max() <= BPM_TOL, f"tempo of 90/120/150 BPM clicks: {bpm}")
    bpms = np.random.default_rng(SEED + 33).uniform(70.0, 180.0, CQT_BATCH)
    xc = torch.from_numpy(_click_batch(bpms, RHYTHM_CHUNKS * EFFECTS_CHUNK, 16000, SEED + 34)).to(dev)
    front = onset_frontend(16000)
    env = front.chain(xc)[..., 0]
    mask, dp_bpm = rhythm.beat_track(env, 16000, 256)
    env_cpu = env.cpu()
    want_mask, want_bpm = rhythm.beat_track(env_cpu, 16000, 256)
    clear = _dp_clear_from(env_cpu, 16000)
    t_env = env.shape[-1]
    left_out = sum(t_env if c is None else c for c in clear)
    same = all(c is None or torch.equal(mask[b, c:].cpu(), want_mask[b, c:]) for b, c in enumerate(clear))
    check(same, "beat_track on the card differs from the CPU where the DP's margins are clear")
    bpm_same = all(c is None or float(dp_bpm[b]) == float(want_bpm[b]) for b, c in enumerate(clear))
    check(bpm_same, "beat_track's tempo on the card differs from the CPU's")
    dp_ms = cuda_ms(lambda: rhythm.beat_track(env, 16000, 256), 1, warmup=1)
    dp_ops = aten_ops(lambda: rhythm.beat_track(env, 16000, 256))
    # the streaming beat graph, streamed against offline at its latency
    g = chain(Spectrogram(1024, 256, center=False, power=True), MelProject(n_mels=64, log=None),
              OnsetStrength(n_bins=64), OnlineBeats(hop=256), input_rate=16000)
    lat = g.stream_latency(EFFECTS_CHUNK)
    streamed = g.scan_stream(xc, EFFECTS_CHUNK)
    offline = g.chain(xc)
    env_st = front.scan_stream(xc, EFFECTS_CHUNK)[:, front.stream_latency(EFFECTS_CHUNK):, 0]
    n_al = streamed.shape[1] - lat
    env_diff = float((env_st[:, :n_al] - env[:, :n_al]).abs().max())
    plan = OnlineBeats(hop=256, sample_rate=16000)._plan()
    until = np.minimum(_online_clear_until(env_cpu.numpy(), plan, env_diff), n_al)
    beats_st = streamed[:, lat:, 0].cpu()
    beats_off = offline[:, :n_al, 0].cpu()
    same = all(torch.equal(beats_st[b, : until[b]], beats_off[b, : until[b]]) for b in range(CQT_BATCH))
    check(same, "the streaming beat graph differs from offline where its decisions are clear")
    online_left = int((n_al - until).sum())
    n_beats = int(beats_off.sum())
    st_ms = cuda_ms(lambda: g.scan_stream(xc, EFFECTS_CHUNK), 1, warmup=1)
    carry = rhythm.online_beat_init(plan, (CQT_BATCH,), device=dev)
    chunk_env = env[:, : EFFECTS_CHUNK // 256]
    online_ops = aten_ops(lambda: rhythm.online_beat_step(plan, carry, chunk_env))
    audio_c = CQT_BATCH * xc.shape[-1] / 16000
    launches = {name: k.COUNT.launches for name, k in kernels.items()}
    check(not any(launches.values()), f"a kernel launched on the CQT and rhythm paths: {launches}")
    print(f"phase 33 rhythm ({card}): the tempo of 90/120/150 BPM click tracks {bpm.tolist()} (tol {BPM_TOL}); "
          f"beat_track of {CQT_BATCH} click tracks of {xc.shape[-1] / 16000:.2f} s ({t_env} envelope frames) on the card "
          f"equals the CPU's mask and tempo where the DP's margins are clear ({left_out} of {CQT_BATCH * t_env} "
          f"frames left out, lanes out {sum(c is None for c in clear)}), {int(want_mask.sum())} beats; {dp_ms:.1f} ms, "
          f"{dp_ops} aten ops = {dp_ops / t_env:.2f} a frame; the streaming beat graph (Spectrogram(1024, 256) -> "
          f"MelProject(64, linear) -> OnsetStrength -> OnlineBeats) in {EFFECTS_CHUNK}-sample chunks equals offline "
          f"at latency {lat} frames ({online_left} of {CQT_BATCH * n_al} frames left out where a decision is within "
          f"its margin, envelopes differing {env_diff:.2e}), {n_beats} beats; {st_ms:.0f} ms = "
          f"{audio_c / st_ms * 1e3:.0f} audio-s/s; OnlineBeats {online_ops} aten ops for {chunk_env.shape[-1]} "
          f"frames = {online_ops / chunk_env.shape[-1]:.1f} a frame; kernel launches on phases 31-33 "
          f"{json.dumps(launches)}")
    out["rhythm"] = {"bpm": bpm.tolist(), "dp_left_out": left_out, "dp_ms": dp_ms,
                     "dp_ops_per_frame": dp_ops / t_env, "online_left_out": online_left,
                     "online_ops_per_frame": online_ops / chunk_env.shape[-1], "stream_ms": st_ms}
    out["launches"] = launches
    return out


def _fp32_spacing(n: float) -> float:
    """The spacing of fp32 values at magnitude ``n``."""
    return 2.0 ** (math.floor(math.log2(n)) - 23)


def _relative_fall_db(x: np.ndarray, y: np.ndarray, speech: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """Per lane, how far the noise stretches fell relative to the speech
    from ``x`` to ``y``, in dB (positive: the noise fell more)."""
    def ratio(a):
        return np.array([10 * np.log10((r[s] ** 2).mean() / (r[n] ** 2).mean()) for r, s, n in zip(a, speech, noise)])
    return ratio(y) - ratio(x)


def mastering(dev: torch.device, card: str) -> dict:
    """Phases 26-30: the mastering, effects and feature families through
    the port's entry points: denoise mastering through ``audioflow run``,
    the keyword-spotting front end through a session, the effects chain
    offline and streamed, the feature graphs over the file path, and the
    ``loudness`` and ``separate`` subcommands. Returns their numbers."""
    import os
    import tempfile

    from scipy.ndimage import binary_dilation

    from audioflow_torch import cli, ops
    from audioflow_torch.config import ConfigManager, graph_from_spec
    from audioflow_torch.graph import Delay, chain
    from audioflow_torch.io import decode_batch, read_audio, write_wav
    from audioflow_torch.models import denoise_master_chain
    from audioflow_torch.ops import decompose, integrated_loudness, true_peak
    from audioflow_torch.ops.effects import history_len
    from audioflow_torch.ops.kernels import melspec
    from audioflow_torch.profiling import aten_ops, profile, tone_batch
    from audioflow_torch.session import StreamSession

    root = os.path.dirname(os.path.abspath(__file__))

    def example(name):
        with open(os.path.join(root, "examples", name)) as f:
            return json.load(f)

    def top(prof, n=4):
        return ", ".join(f"{k['name'][:40]} {k['share']:.1%}" for k in prof["kernels"][:n])

    out = {}

    # phase 26: denoise mastering through `audioflow run`, the example spec
    # and `-g denoise`, each against the graph called directly on the
    # runner's batches, the loudness target, the gate's noise fall, and the
    # spec's graph on the CPU
    with tempfile.TemporaryDirectory(prefix="chip_smoke_denoise_") as tmp:
        x, speech = _speech_batch(DENOISE_FILES, DENOISE_SECONDS, 16000, SEED + 11, floor_db=NOISE_DB, with_mask=True)
        files = [os.path.join(tmp, f"vo{i:02d}.wav") for i in range(DENOISE_FILES)]
        for path, row in zip(files, x):
            write_wav(path, row, 16000, bits=32)
        mb = sum(os.path.getsize(f) for f in files) / 1e6
        glob = os.path.join(tmp, "vo*.wav")
        stride = 1024 * -(-x.shape[-1] // 1024)  # the CLI's stride
        # the noise-only stretches, 100 ms clear of any speech (the STFT's
        # window and the gate's smoothing spread a burst by about that)
        noise = ~binary_dilation(speech, iterations=1600)
        spec = example("denoise_master_spec.json")
        runs = {}
        for label, args, g in (("--spec denoise_master_spec.json", ["--spec", os.path.join(root, "examples",
                                                                                             "denoise_master_spec.json")],
                                graph_from_spec(spec)),
                               ("-g denoise", ["-g", "denoise"], denoise_master_chain(16000))):
            npy = os.path.join(tmp, "out.npy")
            melspec.COUNT.launches = 0
            line = run_cli(["run", "-i", glob, *args, "--batch-size", str(DENOISE_BATCH), "-o", npy,
                            "--stats", os.path.join(tmp, "stats.json")])[-1]
            check(melspec.COUNT.launches == 0, f"denoise {label}: melspec launched {melspec.COUNT.launches} times")
            got = np.load(npy)
            check(got.shape == (DENOISE_FILES, stride) and np.isfinite(got).all(), f"denoise {label}: {got.shape}")
            # the graph called directly on the card, on the batches the runner built
            err = 0.0
            for b in range(0, DENOISE_FILES, DENOISE_BATCH):
                xb = np.zeros((DENOISE_BATCH, stride), np.float32)
                xb[:, : x.shape[-1]] = x[b : b + DENOISE_BATCH]
                want = g.chain(torch.from_numpy(xb).to(dev)).cpu().numpy()
                err = max(err, float(np.abs(got[b : b + DENOISE_BATCH] - want).max()))
            check(err == 0.0, f"denoise {label}: run vs the graph called directly max|d| {err}")
            y = torch.from_numpy(got).to(dev)
            li = integrated_loudness(y, 16000).cpu().numpy()
            tp = true_peak(y, 16000).cpu().numpy()
            on_target = (np.abs(li + 16.0) <= TARGET_LU_TOL) | (tp <= -1.0 + 1e-3)
            check(on_target.all(), f"denoise {label}: lanes off target: LUFS {li[~on_target]}, dBTP {tp[~on_target]}")
            fall = _relative_fall_db(x, got[:, : x.shape[-1]], speech, noise)
            check((fall > 0).all(), f"denoise {label}: noise stretches did not fall relative to the speech: {fall}")
            runs[label] = {"line": line, "fall": fall, "li": li, "tp": tp, "graph": g, "got0": got[0]}
            print(f"phase 26 denoise mastering ({card}): `audioflow run {label} --batch-size {DENOISE_BATCH}` over "
                  f"{DENOISE_FILES} float WAV files of {DENOISE_SECONDS:.0f} s at 16 kHz ({mb:.1f} MB, speech-like "
                  f"bursts over a {NOISE_DB:.0f} dBFS floor): {line['files']} files -> {DENOISE_FILES} x {stride}, "
                  f"exactly the graph called directly on the runner's batches; melspec launches 0; integrated "
                  f"loudness {li.min():.3f} to {li.max():.3f} LUFS (target -16, tol {TARGET_LU_TOL}) or true "
                  f"peak <= -1 dBTP (max {tp.max():.3f}); noise-only stretches fell {fall.min():.2f} to "
                  f"{fall.max():.2f} dB relative to the speech through the whole chain; "
                  f"{line['realtime_factor']:.0f} audio-s/s ({line['audio_seconds']:.0f} audio-s in "
                  f"{line['wall_seconds']:.3f} s, warm-up call {line['compile_seconds']:.3f} s left out)")
        # the spectral gate alone (the spec's first node) on the first batch
        xb = torch.from_numpy(np.pad(x[:DENOISE_BATCH], ((0, 0), (0, stride - x.shape[-1])))).to(dev)
        gate = chain(graph_from_spec(spec).nodes[0], input_rate=16000)
        gated = gate.chain(xb).cpu().numpy()[:, : x.shape[-1]]
        gate_fall = _relative_fall_db(x[:DENOISE_BATCH], gated, speech[:DENOISE_BATCH], noise[:DENOISE_BATCH])
        check((gate_fall >= GATE_DB).all(), f"spectral gate: noise fell only {gate_fall.min():.2f} dB < {GATE_DB}")
        # the spec's graph on the first file on the CPU. A gate decision
        # (log10 |X| > threshold) that the card and the CPU take differently
        # moves the output near it by more than the fp32 tolerance; the
        # samples such a bin can reach are left out of the comparison and
        # counted: its STFT frames and the smoothing's 2 frames on either
        # side, then the FIR's taps and 5 time constants of the
        # compressor's release
        g_spec = runs["--spec denoise_master_spec.json"]["graph"]
        x0 = torch.from_numpy(xb[:1].cpu().numpy())
        cpu0 = g_spec.chain(x0).numpy()[0]
        card0 = runs["--spec denoise_master_spec.json"]["got0"]

        def gate_parts(d):
            mag = ops.stft(x0.to(d), 1024, 256, impl="matmul").abs()
            mean, std = decompose.noise_profile(mag)
            return torch.log10(torch.clamp_min(mag, 1e-10)).cpu(), (mean + 1.5 * std).cpu()

        (lg, tg), (lc, tc) = gate_parts(dev), gate_parts("cpu")
        flipped = ((lg > tg[..., None, :]) != (lc > tc[..., None, :]))[0].any(dim=-1)
        flips = int(((lg > tg[..., None, :]) != (lc > tc[..., None, :])).sum())
        reach = spec["nodes"][1]["num_taps"] - 1 + 5 * round(spec["nodes"][2]["release_ms"] * 16)
        clear = np.ones(card0.shape, bool)
        for f in torch.nonzero(flipped).flatten().tolist():
            clear[max(0, (f - 2) * 256 - 512) : (f + 2) * 256 + 512 + reach] = False
        diff = np.abs(card0 - cpu0) / np.abs(cpu0).max()
        cpu_err = float(diff[clear].max())
        near_err = float(diff[~clear].max()) if (~clear).any() else 0.0
        comp = spec["nodes"][2]
        tau = comp["release_ms"] * 16  # the release's time constant in samples
        env_tol = (1 - 1 / comp["ratio"]) * _fp32_spacing(stride / tau)
        cpu_tol = DENOISE_TOL + env_tol
        check(cpu_err <= cpu_tol, f"denoise spec: card vs CPU {cpu_err:.3e} > {cpu_tol:.3e} (at sample "
              f"{int(np.argmax(np.where(clear, diff, 0)))}) away from the {flips} gate decisions that differ")
        # where the time goes: one batch of 16 x 60 s under the profiler
        prof = profile(lambda: g_spec.chain(xb))
        print(f"phase 26 denoise details ({card}): the spectral gate alone lowers the noise-only stretches "
              f"{gate_fall.min():.2f} to {gate_fall.max():.2f} dB relative to the speech (bound >= {GATE_DB}); the "
              f"spec's graph on file 0 on the CPU vs the card: max|d| {cpu_err:.3e} of the peak (tol {cpu_tol:.3e}: "
              f"{DENOISE_TOL} and the envelope's {env_tol:.3e} at T / tau = {stride / tau:.0f}) "
              f"outside the reach of the {flips} of {lg.numel()} gate decisions that differ ({(~clear).sum()} "
              f"samples, max|d| {near_err:.3e} there); a batch of {DENOISE_BATCH} x {stride} under the "
              f"profiler: {prof['untraced_ms']:.2f} ms, card busy {1 - prof['idle_untraced']:.1%} "
              f"({prof['busy_ms']:.2f} ms, {prof['launches']} device events); {top(prof)}")
        out["denoise"] = {k: {"audio_s_per_s": r["line"]["realtime_factor"], "fall_db_min": float(r["fall"].min())}
                          for k, r in runs.items()}
        out["denoise"]["batch"] = {"untraced_ms": prof["untraced_ms"], "busy_ms": prof["busy_ms"],
                                   "idle_untraced": prof["idle_untraced"], "launches": prof["launches"],
                                   "gate_fall_db_min": float(gate_fall.min()), "cpu_err": cpu_err, "flips": flips,
                                   "near_flip_err": near_err}
        del x, speech, noise, xb, runs

    # phase 27: the keyword-spotting front end through a session, 20 ms pushes
    g = graph_from_spec(example("kws_pcen_spec.json"))
    xk = _speech_batch(SESSION_BATCH, KWS_SECONDS, 16000, SEED + 13)
    n_push = xk.shape[-1] // KWS_PUSH
    melspec.COUNT.launches = 0
    sess = StreamSession(g, lead_shape=(SESSION_BATCH,), device=dev).open()
    chunk = sess.chunk_in
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(n_push):
        sess.push(xk[:, p * KWS_PUSH : (p + 1) * KWS_PUSH])
    res = sess.poll_all()
    res[-1].data
    push_ms = (time.perf_counter() - t0) / n_push * 1e3
    sess.close()
    check(melspec.COUNT.launches == 0, f"kws: melspec launched {melspec.COUNT.launches} times")
    got = np.concatenate([r.data for r in res], axis=1)
    xd = torch.from_numpy(xk[:, : len(res) * chunk]).to(dev)
    want = g.scan_stream(xd, chunk).cpu().numpy()
    check(np.array_equal(got, want), f"kws session vs scan_stream max|d| {np.abs(got - want).max()}")
    lat = g.stream_latency(chunk)
    off = g.chain(xd).cpu().numpy()
    n = min(got.shape[1] - lat, off.shape[1])
    kws_err = float(np.abs(got[:, lat : lat + n] - off[:, :n]).max() / np.abs(off).max())
    check(kws_err <= PCEN_TOL, f"kws streamed vs offline from frame 0: {kws_err} > {PCEN_TOL}")
    step_ops = aten_ops(lambda: g.stream_step(g.init_state(chunk, (SESSION_BATCH,), device=dev), xd[:, :chunk]))
    sess = StreamSession(g, lead_shape=(SESSION_BATCH,), device=dev).open()

    def one_pass():
        for p in range(n_push):
            sess.push(xk[:, p * KWS_PUSH : (p + 1) * KWS_PUSH])
        sess.poll_all()[-1].data

    prof_k = profile(one_pass)
    sess.close()
    print(f"phase 27 keyword spotting ({card}): StreamSession(kws_pcen_spec.json: Spectrogram(512, 160) -> "
          f"MelProject(40, linear) -> Pcen), lead ({SESSION_BATCH},), {KWS_SECONDS:.0f} s at 16 kHz in {n_push} pushes "
          f"of {KWS_PUSH}, chunk {chunk}: {len(res)} results {got.shape}, exactly scan_stream; streamed from frame "
          f"{lat} vs offline from frame 0 {kws_err:.3e} of the peak (tol {PCEN_TOL}, the PCEN reseed); melspec "
          f"launches 0; {push_ms:.3f} ms a push ({push_ms * chunk / KWS_PUSH:.3f} ms a chunk); {step_ops} aten ops "
          f"a chunk; a pass of {n_push} pushes under the profiler: {prof_k['untraced_ms']:.1f} ms, card busy "
          f"{prof_k['busy_ms']:.2f} ms, idle {prof_k['idle_untraced']:.1%} untraced, {prof_k['idle_traced']:.1%} "
          f"traced, {prof_k['launches']} device events; {top(prof_k)}")
    out["kws"] = {"push_ms": push_ms, "step_ops": step_ops, "err": kws_err, "prof": {
        k: prof_k[k] for k in ("untraced_ms", "busy_ms", "idle_untraced", "idle_traced", "launches")}}
    del xk, xd, want, off, got

    # phase 28: the effects chain (Chorus -> Delay -> Limiter), offline and
    # streamed; Delay alone streamed exactly equal to offline
    spec = example("echo_ensemble_spec.json")
    g = graph_from_spec(spec)
    xe = _speech_batch(SESSION_BATCH, EFFECTS_SECONDS, 16000, SEED + 17, floor_db=NOISE_DB)
    t = xe.shape[-1] // EFFECTS_CHUNK * EFFECTS_CHUNK
    xd = torch.from_numpy(xe[:, :t]).to(dev)
    off = g.chain(xd)
    streamed = g.scan_stream(xd, EFFECTS_CHUNK)
    fx_err = float((streamed - off).abs().max())
    # the bound: both forms read at an fp32 position n + Dmax - d(n), off
    # by half a spacing (at n up to T offline, up to a chunk streamed) and
    # an ulp of d each; the taps' weight sums to mix; the delay adds
    # 1 + mix / (1 - feedback); the limiter at most doubles a change
    ch, dl = spec["nodes"][0], spec["nodes"][1]
    dmax = history_len(16000, ch["base_delay_s"], ch["depth_s"])
    d_frac = (_fp32_spacing(t + dmax) + _fp32_spacing(EFFECTS_CHUNK + dmax)) / 2 + 2 * _fp32_spacing(dmax)
    step = float(np.abs(np.diff(xe[:, :t], axis=-1)).max())
    fx_bound = 2 * (1 + dl["mix"] / (1 - dl["feedback"])) * ch["mix"] * d_frac * step
    check(fx_err <= fx_bound, f"effects streamed vs offline {fx_err} > {fx_bound}")
    dg = chain(Delay(dl["delay_s"], dl["feedback"], dl["mix"]), input_rate=16000)
    check(torch.equal(dg.scan_stream(xd, EFFECTS_CHUNK), dg.chain(xd)), "Delay streamed differs from offline")
    audio = SESSION_BATCH * t / 16000
    prof_off = profile(lambda: g.chain(xd))
    prof_st = profile(lambda: g.scan_stream(xd, EFFECTS_CHUNK))
    off_ms, st_ms = prof_off["untraced_ms"], prof_st["untraced_ms"]
    d = round(dl["delay_s"] * 16000)
    delay_ops = {"offline": aten_ops(lambda: dg.chain(xd)), "chunk": aten_ops(
        lambda: dg.nodes[0].step(dg.nodes[0].init_carry((SESSION_BATCH,), EFFECTS_CHUNK, device=dev),
                                 xd[:, :EFFECTS_CHUNK]))}
    print(f"phase 28 effects ({card}): echo_ensemble_spec.json (Chorus(3 voices) -> Delay(0.18 s, D={d}) -> "
          f"Limiter) on {SESSION_BATCH} x {t} at 16 kHz: streamed in {EFFECTS_CHUNK}-sample chunks vs offline max|d| "
          f"{fx_err:.3e} (bound {fx_bound:.3e} from the fp32 read positions: spacing {_fp32_spacing(t + dmax)} at "
          f"n = {t}, largest step between samples {step:.3f}; the JAX package's documented figure is 1e-3 on "
          f"unit-scale audio); Delay alone streamed exactly equal to offline; offline {audio / off_ms * 1e3:.0f} "
          f"audio-s/s ({off_ms:.2f} ms; card busy {prof_off['busy_ms']:.2f} ms, idle {prof_off['idle_untraced']:.1%} "
          f"untraced, {prof_off['idle_traced']:.1%} traced, {prof_off['launches']} device events; {top(prof_off)}), "
          f"streamed {audio / st_ms * 1e3:.0f} audio-s/s ({st_ms:.2f} ms; card busy {prof_st['busy_ms']:.2f} ms, "
          f"idle {prof_st['idle_untraced']:.1%} untraced, {prof_st['idle_traced']:.1%} traced, "
          f"{prof_st['launches']} device events); Delay's aten ops: {delay_ops['offline']} offline "
          f"({-(-t // d)} blocks), {delay_ops['chunk']} a chunk ({-(-EFFECTS_CHUNK // d)} blocks)")
    out["effects"] = {"offline_audio_s_per_s": audio / off_ms * 1e3, "streamed_audio_s_per_s": audio / st_ms * 1e3,
                      "err": fx_err, "bound": fx_bound, "delay_ops": delay_ops}
    del xe, xd, off, streamed

    # phase 29: the feature graphs through `audioflow run` over phase 19's
    # tone files, each against the same graph on the CPU on the first file
    cfg = ConfigManager().current()
    rates = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_features_") as tmp:
        x_np = tone_batch(FILES, SECONDS, RATE, SEED)
        for i, row in enumerate(x_np):
            write_wav(os.path.join(tmp, f"f{i:03d}.wav"), row, RATE)
        del x_np
        glob = os.path.join(tmp, "f*.wav")
        first = os.path.join(tmp, "f000.wav")
        stride = 1024 * -(-int(SECONDS * RATE) // 1024)
        x0 = torch.from_numpy(decode_batch([first], stride=stride).samples)
        for name, (kind, tol) in FEATURE_TOLS.items():
            npy = os.path.join(tmp, f"{name}.npy")
            melspec.COUNT.launches = 0
            line = run_cli(["run", "-i", glob, "-g", name, "--batch-size", str(FILE_BATCH), "-o", npy,
                            "--stats", os.path.join(tmp, "stats.json")])[-1]
            check(melspec.COUNT.launches == 0, f"run -g {name}: melspec launched {melspec.COUNT.launches} times")
            got = np.load(npy)
            want = cli._build_graph(name, RATE, cfg).chain(x0).numpy()[0]
            check(got.shape[0] == FILES and got.shape[1:] == want.shape and np.isfinite(got).all(),
                  f"run -g {name}: {got.shape} vs {want.shape}")
            diff = np.abs(got[0] - want)
            excluded = 0
            if name == "features":
                # the rolloff column picks the first bin whose cumulative
                # magnitude crosses 85%: frames within 1e-5 of a tie are left out
                mag = ops.spectrogram(x0, 1024, 256, center=False, power=False, dtype=torch.float64)[0]
                cum = torch.cumsum(mag, -1)
                near = ((cum - 0.85 * cum[..., -1:]).abs() / cum[..., -1:]).amin(-1).numpy() < 1e-5
                excluded = int(near.sum())
                diff[near, 2] = 0.0
            err = float(diff.max() / (np.abs(want).max() if kind == "rel" else 1.0))
            check(err <= tol, f"run -g {name}: card vs CPU {err} > {tol}")
            rates[name] = line["realtime_factor"]
            print(f"phase 29 run -g {name} ({card}): {line['files']} files of {SECONDS:.0f} s at {RATE} Hz -> "
                  f"{got.shape}, batches {line['batches']}; file 0 vs the graph on the CPU: {err:.3e} "
                  f"({kind}, tol {tol}){f', {excluded} rolloff frames at a tie left out' if name == 'features' else ''}; "
                  f"melspec launches 0; {line['realtime_factor']:.0f} audio-s/s")
            del got
    out["features"] = rates

    # phase 30: the meters and the separation through the CLI
    with tempfile.TemporaryDirectory(prefix="chip_smoke_meters_") as tmp:
        anchor = os.path.join(tmp, "sine997.wav")
        write_wav(anchor, np.sin(2 * np.pi * 997.0 * np.arange(5 * 48000) / 48000.0).astype(np.float32), 48000,
                  bits=32)
        row = run_cli(["loudness", anchor])[-1]
        check(abs(row["integrated_lufs"] + 3.01) <= ANCHOR_LU_TOL, f"loudness anchor {row}")
        ts = np.arange(int(SEPARATE_SECONDS * 16000)) / 16000
        x2 = (0.5 * np.sin(2 * np.pi * 220.0 * ts) * (ts < SEPARATE_SECONDS / 2) + 0.3 * np.sin(2 * np.pi * 660.0 * ts)
              + 1e-3 * np.random.default_rng(SEED + 19).standard_normal(ts.size)).astype(np.float32)
        two = os.path.join(tmp, "two_tones.wav")
        write_wav(two, x2, 16000, bits=32)
        t0 = time.perf_counter()
        sep = run_cli(["separate", "-i", two, "-k", "2"])[-1]
        sep_s = time.perf_counter() - t0
        # the function `separate` runs, on the card with the CLI's arguments:
        # its components sum to the input; the CLI's 16-bit WAVs hold them
        # to the format's round trip, trunc(c * 32767) / 32768
        comps, _, _ = ops.nmf_separate(torch.from_numpy(x2).to(dev), 2, 1024, 256)
        comps = comps.cpu().numpy()
        sep_err = float(np.abs(comps.sum(0) - x2).max() / np.abs(x2).max())
        wavs = np.stack([read_audio(p)[0] for p in sep["components"]])
        wav_err = float((np.abs(wavs - comps) - (np.abs(comps) + 1) / 32768).max())
        check(len(wavs) == 2 and sep_err <= SEPARATE_TOL and sep["residual_rel"] <= SEPARATE_TOL and wav_err <= 0,
              f"separate: {len(wavs)} components, sum err {sep_err}, residual_rel {sep['residual_rel']}, "
              f"WAVs past the 16-bit round trip by {wav_err}")
        mag = ops.stft(torch.from_numpy(x2).to(dev), 1024, 256).abs()
        nmf_ops = aten_ops(lambda: ops.nmf(mag, 2))
    print(f"phase 30 meters and separation ({card}): `audioflow loudness` of a 997 Hz 0 dBFS sine at 48 kHz: "
          f"{row['integrated_lufs']} LKFS (want -3.01 within {ANCHOR_LU_TOL}), true peak {row['true_peak_dbtp']} "
          f"dBTP; `audioflow separate -k 2` of {SEPARATE_SECONDS:.0f} s of two tones: templates peak at "
          f"{sep['template_peak_hz']} Hz, the components sum to the input within {sep_err:.2e} of its peak "
          f"(tol {SEPARATE_TOL}), residual_rel {sep['residual_rel']}, the 16-bit WAVs within the format's round "
          f"trip of them; {sep_s:.2f} s end to end; nmf's 200 "
          f"iterations run {nmf_ops} aten ops")
    out["meters"] = {"anchor_lufs": row["integrated_lufs"], "separate_s": sep_s, "separate_err": sep_err,
                     "nmf_ops": nmf_ops}
    return out


def _music_like(seconds: float, rate: int, seed: int) -> np.ndarray:
    """A music-like file for ``segments``: sections of 10-25 s, each a chord
    of three harmonic tones with a tremolo, over noise."""
    rng = np.random.default_rng(seed)
    out, n = [], int(seconds * rate)
    while sum(len(p) for p in out) < n:
        t = np.arange(int(rng.uniform(10.0, 25.0) * rate)) / rate
        f0 = rng.uniform(110.0, 440.0)
        env = 0.8 + 0.2 * np.sin(2 * np.pi * rng.uniform(2.0, 6.0) * t)
        sec = sum(np.sin(2 * np.pi * f0 * r * t) / (1 + k) for k, r in enumerate((1.0, 1.25, 1.5)))
        out.append(0.2 * env * sec + 0.01 * rng.standard_normal(t.size))
    return np.concatenate(out)[:n].astype(np.float32)


def _novelty_f64(s: torch.Tensor, l: int) -> torch.Tensor:
    """Foote novelty of ``s [T, T]`` from a float64 summed-area table: the
    reference's formula, without the fp32 table's rounding."""
    t = s.shape[-1]
    sat = torch.zeros((t + 1, t + 1), dtype=torch.float64, device=s.device)
    sat[1:, 1:] = s.double().cumsum(-1).cumsum(-2)
    ts = torch.arange(t, device=s.device)
    lo, hi = (ts - l).clamp_min(0), (ts + l).clamp_max(t)

    def block(r0, r1, c0, c1):
        return sat[r1, c1] - sat[r0, c1] - sat[r1, c0] + sat[r0, c0]

    area = ((ts - lo) * (hi - ts)).double()
    nov = (block(lo, ts, lo, ts) + block(ts, hi, ts, hi) - 2.0 * block(lo, ts, ts, hi)) / area.clamp_min(1.0)
    return torch.where(area > 0, nov.clamp_min(0.0), 0.0)

def analysis(dev: torch.device, card: str) -> dict:
    """Phases 34-35: online pYIN and the analysis commands through the
    port's entry points: ``pyin_online`` and the ``OnlinePyin`` node on the
    pyin cell's batch, the card against the CPU, the fixed-lag decode
    against the offline Viterbi on a steady tone; then ``audioflow pitch
    --method yin|pyin|pyin-online``, ``align``, ``segments`` and ``inspect
    -g logmel`` in the process, each against ``--device cpu``, the dense
    Viterbi and LPC at the JAX tests' shapes, and DTW and ``segments`` at
    full size, timed with their peak device memory. Returns their numbers
    and each kernel's launches, counted from 0."""
    import os
    import tempfile

    from audioflow_torch import ops
    from audioflow_torch.graph import OnlinePyin, chain
    from audioflow_torch.io import write_wav
    from audioflow_torch.ops import pitch as pitch_ops
    from audioflow_torch.ops import rhythm as rhythm_ops
    from audioflow_torch.ops import sequence as seq_ops
    from audioflow_torch.ops.kernels import griffinlim, melspec, timestretch, viterbi
    from audioflow_torch.profiling import aten_ops, profile, vibrato_batch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from decision_margins import (dtw_common_suffix, online_pyin_flips_explained, online_pyin_trace,
                                  peak_pick_clear, sat_bound)

    kernels = {"melspec": melspec, "timestretch": timestretch, "griffinlim": griffinlim, "viterbi": viterbi}

    def zero():
        for k in kernels.values():
            k.COUNT.launches = 0

    def counts():
        return {name: k.COUNT.launches for name, k in kernels.items()}

    def peak_mb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, (torch.cuda.max_memory_allocated() - base) / 1e6

    out = {"seconds": {}}
    t_phase = time.perf_counter()

    # phase 34: online pYIN at make_online_pyin_plan's defaults on the pyin
    # cell's batch (64 x 10 s at 16 kHz), offline and streamed, counted from 0
    plan = ops.make_online_pyin_plan(PVOC_RATE)
    check((plan.n_bins, plan.lag, plan.frame_length, plan.hop) == (602, 25, 2048, 256), f"plan {plan}")
    x_np = vibrato_batch(PYIN_BATCH, SECONDS, PVOC_RATE, SEED)
    x = torch.from_numpy(x_np).to(dev)
    zero()
    (f0, vf, vp), first_ms, on_mb = peak_mb(lambda: ops.pyin_online(x_np, PVOC_RATE))
    _, on_ms, _ = peak_mb(lambda: ops.pyin_online(x, PVOC_RATE))  # the second call: cuFFT plans cached
    n_frames = f0.shape[-1]
    check(f0.device.type == "cuda" and f0.shape == vf.shape == vp.shape == (PYIN_BATCH, n_frames),
          f"pyin_online shapes {tuple(f0.shape)}")
    check(bool(torch.isfinite(f0).all() and torch.isfinite(vp).all()), "non-finite pyin_online output")
    g = chain(OnlinePyin(), input_rate=PVOC_RATE)
    offline = g.chain(x)
    n_use = x.shape[-1] // EFFECTS_CHUNK * EFFECTS_CHUNK
    streamed, st_ms, _ = peak_mb(lambda: g.scan_stream(x[:, :n_use], EFFECTS_CHUNK))
    lat = g.stream_latency(EFFECTS_CHUNK)
    # a chunk step on its own: the state's set-up (a step over meta tensors
    # sizes the pendings), then host-clocked steps of a warm stream
    st_state, init_ms, _ = peak_mb(lambda: g.init_state(EFFECTS_CHUNK, (PYIN_BATCH,), device=dev))
    step_ms = []
    for c in range(4):
        st_state, _ = g.stream_step(st_state, x[:, c * EFFECTS_CHUNK : (c + 1) * EFFECTS_CHUNK])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_state, _ = g.stream_step(st_state, x[:, (c + 4) * EFFECTS_CHUNK : (c + 5) * EFFECTS_CHUNK])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del st_state
    n_al = streamed.shape[-2] - lat
    check(lat == (2048 // 256 - 1) + 25 and n_al > 500, f"OnlinePyin latency {lat}, {n_al} aligned frames")
    check(torch.equal(streamed[:, lat : lat + n_al], offline[:, :n_al]), "OnlinePyin streamed != offline at its latency")
    check(torch.equal(offline[:, : n_frames - plan.lag, 0], f0[:, plan.lag :]), "the node's offline form != pyin_online")
    launches_online = counts()
    check(not any(launches_online.values()), f"a kernel launched on the online pYIN path: {launches_online}")
    # the step's three first-maximum rules on the card, on tie-heavy inputs
    # (values on a coarse grid): the band's offsets at the plan's 139 taps,
    # the best state over both tracks, the refinement's best candidate; each
    # equal to the CPU's, which the CPU tests hold to the JAX package's
    g_rng = np.random.default_rng(SEED)
    ties = torch.from_numpy((np.round(g_rng.standard_normal((PYIN_BATCH, 2 * plan.n_bins)) * 2) / 2)
                            .astype(np.float32))
    _, lk_cpu, _, _ = pitch_ops._pyin_hmm_consts(PVOC_RATE, plan.hop, plan.nbps, plan.max_transition_rate,
                                                plan.switch_prob)
    lk_tie = torch.round(lk_cpu * 2) / 2
    band = [seq_ops.max_plus_band_argmax(t, lk_tie.to(t.device))
            for t in (ties[:, : plan.n_bins].to(dev), ties[:, : plan.n_bins])]
    firsts = [t.argmax(dim=-1) for t in (ties.to(dev), ties)] + [t.max(dim=-1)[1] for t in (ties.to(dev), ties)]
    check(torch.equal(band[0][0].cpu(), band[1][0]) and torch.equal(band[0][1].cpu(), band[1][1])
          and torch.equal(firsts[0].cpu(), firsts[1]) and torch.equal(firsts[2].cpu(), firsts[3]),
          "a first-maximum rule differs on the card")
    n_tied = int((ties == ties.max(dim=-1, keepdim=True).values).sum(dim=-1).gt(1).sum())
    # where the time goes: aten ops a frame of one chunk step, and the card's idle share
    fr = ops.frame(x[:, : 64 * plan.hop + plan.frame_length - plan.hop], plan.frame_length, plan.hop)
    state = ops.online_pyin_init(plan, (PYIN_BATCH,), device=dev)
    step_ops = aten_ops(lambda: ops.online_pyin_step(plan, state, fr))
    # the frame loop's share: a 64-frame step less a 1-frame step, over 63
    frame_ops = (step_ops - aten_ops(lambda: ops.online_pyin_step(plan, state, fr[:, :1]))) / (fr.shape[1] - 1)
    prof = profile(lambda: ops.pyin_online(x, PVOC_RATE))
    audio_s = PYIN_BATCH * SECONDS
    # the card against the CPU on 8 lanes: equal where the decisions that
    # reach an emission are the same (each parting a near tie)
    x8 = x_np[:8]
    cpu = ops.pyin_online(x8, PVOC_RATE, device="cpu")
    fr8 = ops.frame(torch.from_numpy(x8), plan.frame_length, plan.hop)
    t_card, t_cpu = online_pyin_trace(plan, fr8.to(dev)), online_pyin_trace(plan, fr8)
    score_diff = float(np.abs(t_card["score"] - t_cpu["score"]).max())
    walks = online_pyin_flips_explained(plan, t_cpu, t_card, score_diff)
    eq = torch.from_numpy(walks["equal"])
    check(eq.float().mean().item() > 0.9, f"{eq.float().mean().item():.3f} of emissions with equal decisions")
    check(torch.equal(vf[:8].cpu()[eq], cpu[1][eq]), "voicing differs from the CPU's where the decisions agree")
    f0_rel = ((f0[:8].cpu() / cpu[0] - 1.0).abs()[eq]).max().item()
    vp_d = (vp[:8].cpu() - cpu[2]).abs().max().item()
    check(f0_rel <= ONLINE_F0_RTOL and vp_d <= ONLINE_VP_TOL, f"card vs CPU f0 {f0_rel}, voiced prob {vp_d}")
    # the fixed-lag decode against the offline Viterbi (the kernel) outside
    # the lag window on a steady 220 Hz tone (tests/test_pitch.py:344-365)
    rng = np.random.default_rng(SEED)
    tt = np.arange(int(SECONDS * PVOC_RATE)) / PVOC_RATE
    tone = (0.4 * np.sin(2 * np.pi * 220.0 * tt) + 0.01 * rng.standard_normal((8, tt.size))).astype(np.float32)
    of, ov, _ = ops.pyin_online(tone, PVOC_RATE)
    zero()
    vf0, vvf, _ = pitch_ops.pyin_frames(ops.frame(torch.from_numpy(tone).to(dev), 2048, 256), PVOC_RATE, hop=256)
    check(viterbi.COUNT.launches == 1, f"the offline decode launched the viterbi kernel {viterbi.COUNT.launches} times")
    dec_f0, dec_vf = of[:, plan.lag :], ov[:, plan.lag :]
    sl = slice(5, dec_f0.shape[-1] - 5)
    check(torch.equal(dec_vf[:, sl], vvf[:, : dec_f0.shape[-1]][:, sl]), "online voicing != the offline Viterbi's")
    tone_rel = (dec_f0[:, sl] / vf0[:, : dec_f0.shape[-1]][:, sl] - 1.0).abs().max().item()
    check(tone_rel <= 1e-6, f"online f0 vs the offline Viterbi {tone_rel} > 1e-6")
    out["online"] = {"ms": on_ms, "first_ms": first_ms, "ms_per_frame": on_ms / n_frames, "peak_mb": on_mb,
                     "stream_ms": st_ms, "init_state_ms": init_ms, "step_ms": step_ms,
                     "audio_s_per_s": audio_s / on_ms * 1e3, "aten_ops_per_frame": step_ops / fr.shape[1],
                     "decode_ops_per_frame": frame_ops, "idle_untraced": prof["idle_untraced"],
                     "idle_traced": prof["idle_traced"], "untraced_ms": prof["untraced_ms"], "busy_ms": prof["busy_ms"],
                     "flips": walks["flips"], "equal_share": eq.float().mean().item()}
    print(f"phase 34 online pYIN ({card}): pyin_online at the plan's defaults ({plan.n_bins} bins, lag {plan.lag}, "
          f"frame {plan.frame_length}, hop {plan.hop}) on {PYIN_BATCH} x {SECONDS:.0f} s -> {n_frames} frames, "
          f"{on_ms:.1f} ms (the first call {first_ms:.1f}) = {on_ms / n_frames:.3f} ms a frame for {PYIN_BATCH} streams = "
          f"{audio_s / on_ms * 1e3:.0f} audio-s/s, {on_mb:.0f} MB; OnlinePyin streamed in {EFFECTS_CHUNK}-sample chunks "
          f"({st_ms:.0f} ms) equals offline at latency {lat} frames exactly ({n_al} frames); init_state "
          f"{init_ms:.0f} ms, a warm chunk step (64 frames) {json.dumps([round(v, 1) for v in step_ms])} ms; aten ops "
          f"{step_ops / fr.shape[1]:.1f} a frame in a 64-frame chunk step, {frame_ops:.1f} of them the frame loop's; "
          f"under the "
          f"profiler {prof['untraced_ms']:.1f} ms, busy {prof['busy_ms']:.2f} ms, idle {prof['idle_untraced']:.1%} "
          f"untraced, {prof['idle_traced']:.1%} traced, {prof['launches']} device events; card vs CPU on 8 lanes: "
          f"{eq.float().mean().item():.4f} of emissions with equal decisions ({walks['flips']} near-tie flips), f0 "
          f"rel {f0_rel:.2e}, voiced prob {vp_d:.2e}; steady 220 Hz vs the offline Viterbi (1 launch): voicing equal, "
          f"f0 rel {tone_rel:.2e}; the first-maximum rules equal to the CPU's on tie-heavy inputs ({n_tied} of "
          f"{PYIN_BATCH} rows tied at their maximum); kernel launches on the online path {json.dumps(launches_online)}")
    del x, offline, streamed, t_card, t_cpu
    out["seconds"]["34"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # phase 35: the analysis commands in the process, each against --device cpu
    with tempfile.TemporaryDirectory() as tmp:
        pv = os.path.join(tmp, "vibrato.wav")
        write_wav(pv, x_np[0], PVOC_RATE, bits=32)
        lines, paths = {}, {}
        for method in ("yin", "pyin", "pyin-online"):
            zero()
            lines[method] = got = run_cli(["pitch", "-i", pv, "--method", method])[-1]
            paths[f"pitch {method}"] = counts()
            want = run_cli(["pitch", "-i", pv, "--method", method, "--device", "cpu"])[-1]
            check(got["frames"] == want["frames"] and [a["t"] for a in got["track"]] == [a["t"] for a in want["track"]],
                  f"pitch --method {method}: frames")
            pairs = list(zip(got["track"], want["track"]))
            same_v = float(np.mean([(a["f0_hz"] is None) == (b["f0_hz"] is None) for a, b in pairs]))
            f0_d = max(abs(a["f0_hz"] - b["f0_hz"]) - PITCH_F0_RTOL * b["f0_hz"] for a, b in pairs
                       if a["f0_hz"] is not None and b["f0_hz"] is not None)
            ap_d = max(abs(a["aperiodicity"] - b["aperiodicity"]) for a, b in pairs)
            check(same_v >= PITCH_VOICING and f0_d <= 0.0101 and ap_d <= 0.0011,
                  f"pitch --method {method}: voicing {same_v}, f0 {f0_d}, aperiodicity {ap_d}")
        out["launches_pitch_cli"] = paths["pitch pyin"]["viterbi"]
        check(paths["pitch pyin"] == {"melspec": 0, "timestretch": 0, "griffinlim": 0, "viterbi": 1},
              f"pitch --method pyin launched {paths['pitch pyin']}")
        # DTW between two 30 s files at 16 kHz (13 MFCCs, n_fft 1024, hop 256):
        # the second another noise draw, its middle third at double speed
        pa, pb = os.path.join(tmp, "a.wav"), os.path.join(tmp, "b.wav")
        xa = vibrato_batch(1, 30.0, PVOC_RATE, SEED)[0]
        xb = vibrato_batch(1, 30.0, PVOC_RATE, SEED + 1)[0]
        xb = np.concatenate([xb[: 10 * PVOC_RATE], xb[10 * PVOC_RATE : 20 * PVOC_RATE : 2], xb[20 * PVOC_RATE :],
                             xb[: 5 * PVOC_RATE]])
        write_wav(pa, xa, PVOC_RATE, bits=32)
        write_wav(pb, xb, PVOC_RATE, bits=32)
        zero()
        align, align_ms, align_mb = peak_mb(lambda: run_cli(["align", "-a", pa, "-b", pb])[-1])
        paths["align"] = counts()
        walign = run_cli(["align", "-a", pa, "-b", pb, "--device", "cpu"])[-1]
        from audioflow_torch.cli import _analysis_features

        fa, fb = (_analysis_features(s, PVOC_RATE, 1024, 256, dev) for s in (xa, xb))
        wfa, wfb = (_analysis_features(s, PVOC_RATE, 1024, 256, "cpu") for s in (xa, xb))
        (acc, path), dtw_ms, dtw_mb = peak_mb(lambda: ops.dtw(fa, fb, metric="cosine"))
        wacc, wpath = ops.dtw(wfa, wfb, metric="cosine")
        dtw_d = (acc.cpu() - wacc).abs().max().item()
        check(dtw_d <= DTW_TOL * wacc[-1, -1].item(), f"DTW card vs CPU {dtw_d} of {wacc[-1, -1].item()}")
        # the paths share every cell back from the end to a near tie, if any
        common = dtw_common_suffix(wacc, wpath, path, 2 * dtw_d)
        # the wavefront alone: one cost on both devices, the sums in one order
        cost = 1.0 - (wfa / wfa.norm(dim=-1, keepdim=True)) @ (wfb / wfb.norm(dim=-1, keepdim=True)).T
        cacc, cpath = ops.dtw(cost=cost.clamp_min(0.0).to(dev))
        ccacc, ccpath = ops.dtw(cost=cost.clamp_min(0.0))
        check(torch.equal(cacc.cpu(), ccacc) and np.array_equal(cpath, ccpath), "DTW from one cost: card != CPU")
        check(align["frames_a"] == walign["frames_a"] and align["frames_b"] == walign["frames_b"]
              and abs(align["cost"] - walign["cost"]) <= dtw_d + 0.001, "align: the card's JSON != the CPU's")
        check(common < len(wpath) or align["anchors"] == walign["anchors"], "align: equal paths, unequal anchors")
        # segments on a 180 s music-like file at 44.1 kHz (n_fft 2048, hop 512)
        pm = os.path.join(tmp, "music.wav")
        xm = _music_like(SEGMENT_SECONDS, RATE, SEED)
        write_wav(pm, xm, RATE, bits=32)
        zero()
        seg, seg_ms, seg_mb = peak_mb(lambda: run_cli(["segments", "-i", pm])[-1])
        paths["segments"] = counts()
        wseg = run_cli(["segments", "-i", pm, "--device", "cpu"])[-1]
        feats, wfeats = _analysis_features(xm, RATE, 2048, 512, dev), _analysis_features(xm, RATE, 2048, 512, "cpu")
        t_seg = feats.shape[0]
        (_, nov), ops_ms, ops_mb = peak_mb(lambda: ops.segment_boundaries(feats))
        _, wnov = ops.segment_boundaries(wfeats)
        nov_d = (nov.cpu() - wnov).abs().max().item()
        # the boundaries where the peak picker's decisions are alike on both
        # novelty curves (kernel 32: windows and wait of 16 frames)
        seg_clear = peak_pick_clear(wnov, nov.cpu(), 16, 16, 16, 16, 0.05, 16, SEG_MEAN_SLACK)
        hop_s = 512 / RATE

        def kept(bounds):
            return [b for b in bounds if seg_clear[int(round(b / hop_s))]]

        check(seg["frames"] == wseg["frames"] == t_seg and kept(seg["boundaries_s"]) == kept(wseg["boundaries_s"]),
              f"segments: the card's boundaries {seg['boundaries_s']} != the CPU's {wseg['boundaries_s']}")
        check(seg_clear.mean() > 0.5 and len(kept(wseg["boundaries_s"])) >= 2,
              f"segments: {seg_clear.mean():.3f} of frames clear, {len(kept(wseg['boundaries_s']))} boundaries kept")
        # the summed-area table alone: the same similarity on both devices,
        # the card's cumsums against the CPU's within the table's fp32 bound
        s_cpu = ops.self_similarity(wfeats)
        sat_d = (ops.novelty_curve(s_cpu.to(dev)).cpu() - ops.novelty_curve(s_cpu)).abs()
        bound = torch.from_numpy(2 * sat_bound(s_cpu, 16))
        check(bool((sat_d <= bound).all()), f"novelty card vs CPU {sat_d.max().item()} past the table's bound")
        sat_top = float(s_cpu.double().abs().sum())
        # and against a float64 table: what storing the table in fp32 (the
        # reference's algorithm) costs at this T, and the boundaries the
        # picker finds on the float64 novelty
        exact = _novelty_f64(s_cpu.to(dev), 16)
        f64_err = (nov.cpu() - exact.float().cpu()).abs().max().item()
        f64_bounds = int((rhythm_ops.peak_pick(exact.float(), 16, 16, 16, 16, 0.05, 16)[16:-16]).sum())
        del s_cpu, exact
        # inspect -g logmel, and the dense Viterbi and LPC at the JAX tests' shapes
        zero()
        ins = run_cli(["inspect", "-g", "logmel"])[-1]
        paths["inspect"] = counts()
        wins = run_cli(["inspect", "-g", "logmel", "--device", "cpu"])[-1]
        check(set(ins) == set(wins) and ins["collectives"] == 0 and ins["fusions"] > 0, f"inspect {ins}")
        rng = np.random.default_rng(SEED)
        lo = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
        la = np.log(rng.dirichlet(np.ones(4), 4)).astype(np.float32)
        zero()
        sv, lp = ops.viterbi(lo, la)
        wsv, wlp = ops.viterbi(lo, la, device="cpu")
        check(torch.equal(sv.cpu(), wsv) and torch.equal(lp.cpu(), wlp), "dense viterbi card != CPU")
        xl = rng.standard_normal((3, 5, 1024)).astype(np.float32)
        lpc_d = max(((ops.lpc(xl, o).cpu() - ops.lpc(xl, o, device="cpu")).abs().max()
                     / ops.lpc(xl, o, device="cpu").abs().max()).item() for o in (2, 8, 16))
        check(lpc_d <= 1e-4, f"lpc card vs CPU {lpc_d}")
        paths["viterbi, lpc"] = counts()
    # every new path but inspect -g logmel (the log-mel graph: melspec once a
    # call) and pitch --method pyin launches no kernel
    for name, c in paths.items():
        if name not in ("pitch pyin", "inspect"):
            check(not any(c.values()), f"{name} launched {c}")
    check(paths["inspect"]["melspec"] > 0 and not any(v for k, v in paths["inspect"].items() if k != "melspec"),
          f"inspect -g logmel launched {paths['inspect']}")
    out["launches"] = {k: launches_online[k] + sum(c[k] for n, c in paths.items() if n not in ("pitch pyin", "inspect"))
                       for k in kernels}
    out["launches_inspect"] = paths["inspect"]
    out["seconds"]["35"] = time.perf_counter() - t_phase
    out["dtw"] = {"frames": [int(fa.shape[0]), int(fb.shape[0])], "ms": dtw_ms, "peak_mb": dtw_mb,
                  "cli_ms": align_ms, "cli_peak_mb": align_mb, "acc_diff": dtw_d, "path_shared": common,
                  "path_len": len(wpath)}
    out["segments"] = {"frames": t_seg, "ms": ops_ms, "peak_mb": ops_mb, "cli_ms": seg_ms, "cli_peak_mb": seg_mb,
                       "novelty_diff": nov_d, "sat_diff": sat_d.max().item(), "sat_top": sat_top,
                       "boundaries": len(seg["boundaries_s"]), "clear_share": float(seg_clear.mean()),
                       "f64_err": f64_err, "f64_boundaries": f64_bounds}
    print(f"phase 35 analysis CLI ({card}): pitch yin/pyin/pyin-online {lines['yin']['frames']}/"
          f"{lines['pyin']['frames']}/{lines['pyin-online']['frames']} frames, each equal to --device cpu within "
          f"its rounding (voicing >= {PITCH_VOICING}); pitch --method pyin launched viterbi "
          f"{out['launches_pitch_cli']} time; align of 30 s files ({fa.shape[0]} x {fb.shape[0]} frames) "
          f"{align_ms:.0f} ms, {align_mb:.0f} MB, the DTW alone {dtw_ms:.0f} ms, {dtw_mb:.1f} MB, acc card vs CPU "
          f"{dtw_d:.2e}, the paths share {common} of {len(wpath)} cells back from the end (to a near tie, if "
          f"fewer), from one cost equal; segments of {SEGMENT_SECONDS:.0f} s at {RATE} Hz (T = {t_seg}) "
          f"{seg_ms:.0f} ms, peak {seg_mb:.0f} MB, the ops alone {ops_ms:.0f} ms, {ops_mb:.0f} MB, "
          f"{len(seg['boundaries_s'])} boundaries, equal to the CPU's on the {seg_clear.mean():.4f} of frames where "
          f"the picker decides alike (novelty diff {nov_d:.2e}); the table alone card vs CPU "
          f"{sat_d.max().item():.3e} (bound from fp32 spacing at "
          f"{sat_top:.3e}); the novelty against a float64 table max|d| {f64_err:.3e} (the picker finds "
          f"{f64_bounds} boundaries on it); "
          f"inspect -g logmel {json.dumps(ins)} (CPU {json.dumps(wins)}); dense viterbi equal, lpc "
          f"{lpc_d:.2e}; kernel launches by path {json.dumps(paths)}")
    return out


def _kws_clips(n: int, rate: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` keyword-shaped clips of 1 s (Speech Commands' shape) in ten
    classes: class ``k`` a tone warbled around 200 + 150 k Hz, over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(rate) / rate
    y = np.arange(n) % 10
    f0 = 200.0 + 150.0 * y + rng.uniform(-20.0, 20.0, n)
    x = (0.3 * np.sin(2 * np.pi * (f0[:, None] + 30.0 * np.sin(2 * np.pi * 3.0 * t)) * t)
         + 0.05 * rng.standard_normal((n, rate)))
    return x.astype(np.float32), y.astype(np.int64)


def _lecture(n: int, rate: int, seed: int, gain: float = 1.0) -> np.ndarray:
    """One long speech-like recording ``[1, n]``: the phase-24 bursts and
    silences over a -45 dBFS floor, times ``gain``."""
    x = _speech_batch(1, n / rate + 1.0, rate, seed, floor_db=-45.0)[:, :n]
    return np.ascontiguousarray(gain * x, dtype=np.float32)


def _after_step_agree(got: dict, want: dict, g_want: dict, g_diff: dict, what: str) -> float:
    """The parameters after one Adam step against a reference: within
    TRAIN_STEP_TOL where the reference's gradient clears the margin (at least
    TRAIN_MARGIN times ``g_diff``, the two runs' difference in it), within
    2 lr elsewhere (Adam's first step is close to lr·sign(g); a ReLU unit
    that no clip reaches has a zero gradient). Returns the largest
    difference on the clear entries."""
    worst = 0.0
    for k, w in want.items():
        clear = np.abs(g_want[k]) >= TRAIN_MARGIN * g_diff[k]
        d = np.abs(got[k] - w)
        check(d.shape == w.shape and bool((d[~clear] <= 2 * TRAIN_LR).all()),
              f"{what}: {k} moved past 2 lr where its gradient is near zero")
        worst = max(worst, float(d[clear].max(initial=0.0)))
    check(worst < TRAIN_STEP_TOL, f"{what}: parameters after one step differ by {worst}")
    return worst


def training(dev: torch.device, card: str) -> dict:
    """Phase 36: the trainable frontend on the card. The example's
    assertions; at full width (the defaults, and ``hidden=256``, on 256
    clips of 1 s) one step on the card against the same step on the CPU,
    then ms per step, clips/s, peak memory and device launches per step,
    with ``remat`` off and on; and ``make_train_step(mesh=...)`` over an
    NCCL world of one rank, exactly the unsharded step."""
    import importlib.util
    import os

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from audioflow_torch.convert import trainable_to_numpy
    from audioflow_torch.models import TrainableFrontend, make_train_step
    from audioflow_torch.ops.kernels import griffinlim, melspec, timestretch, viterbi
    from audioflow_torch.parallel import make_mesh, multihost_init

    t_phase = time.perf_counter()
    kernels = {"melspec": melspec, "timestretch": timestretch, "griffinlim": griffinlim, "viterbi": viterbi}
    for k in kernels.values():
        k.COUNT.launches = 0
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "train_kws_torch.py")
    spec = importlib.util.spec_from_file_location("train_kws_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    check(example.main(60, None, "cuda") == 0, "examples/train_kws_torch.py on the card")

    x_np, y_np = _kws_clips(TRAIN_CLIPS, TRAIN_RATE, SEED)
    xd, yd = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    out = {"heads": {}}
    for hidden in (0, TRAIN_HIDDEN):
        grads, losses, after = {}, {}, {}
        for d in ("cuda", "cpu"):
            m = TrainableFrontend(hidden=hidden, device=d, seed=SEED)
            m.loss(xd.to(d), yd.to(d)).backward()
            grads[d] = {k: p.grad.cpu().numpy() for k, p in m.named_parameters()}
            m = TrainableFrontend(hidden=hidden, device=d, seed=SEED)
            step, _ = make_train_step(m)
            losses[d] = float(step(xd.to(d), yd.to(d)))
            after[d] = trainable_to_numpy(m)
        loss_d = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        check(loss_d <= TRAIN_LOSS_RTOL, f"hidden={hidden}: loss card vs CPU {loss_d}")
        grad_d = {k: float(np.abs(grads["cuda"][k] - g).max() / np.abs(g).max()) for k, g in grads["cpu"].items()}
        check(max(grad_d.values()) <= TRAIN_GRAD_RTOL, f"hidden={hidden}: gradients card vs CPU {grad_d}")
        g_diff = {k: np.abs(grads["cuda"][k] - g) for k, g in grads["cpu"].items()}
        step_d = _after_step_agree(after["cuda"], after["cpu"], grads["cpu"], g_diff, f"hidden={hidden} card vs CPU")
        timing = {}
        for remat in (False, True):
            m = TrainableFrontend(hidden=hidden, remat=remat, device="cuda", seed=SEED)
            step, _ = make_train_step(m)
            ms = cuda_ms(lambda: step(xd, yd), TRAIN_STEPS, warmup=2)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(xd, yd)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - held) / 1e6  # a step's own, beyond what is held
            dev_t = device_ms(lambda: step(xd, yd), TRAIN_STEPS)
            timing["remat" if remat else "plain"] = {
                "ms": ms, "clips_per_s": TRAIN_CLIPS / ms * 1e3, "peak_mb": peak, "device_ms": dev_t[0],
                "device_readings": dev_t[1], "launches_per_step": dev_t[2]}
        out["heads"][f"hidden={hidden}"] = {"loss": losses, "grad_rel": grad_d, "step_diff": step_d,
                                            "timing": timing}
        print(f"phase 36 training ({card}): TrainableFrontend(hidden={hidden}) at its defaults on {TRAIN_CLIPS} x "
              f"1 s: loss card {losses['cuda']:.6f} vs CPU {losses['cpu']:.6f}, gradients within "
              f"{max(grad_d.values()):.2e} of each parameter's largest, one Adam step {step_d:.2e} on the entries "
              f"that clear the margin; " + "; ".join(
                  f"{name}: {t['ms']:.3f} ms a step (CUDA events, {TRAIN_STEPS} steps after 2), "
                  f"{t['clips_per_s']:.0f} clips/s, a step's peak {t['peak_mb']:.0f} MB beyond what is held, "
                  f"{t['launches_per_step']:g} device "
                  f"launches a step, device time {t['device_ms']:.3f} ms" for name, t in timing.items()))

    # the step over an NCCL world of one rank: every collective is NCCL's on
    # the card, and the result is the unsharded step's exactly
    check(multihost_init(num_processes=1, backend="nccl", timeout=300) is True, "an NCCL world of one rank")
    try:
        mesh = make_mesh(devices="cuda")
        ma = TrainableFrontend(hidden=TRAIN_HIDDEN, device="cuda", seed=SEED)
        mb = TrainableFrontend(hidden=TRAIN_HIDDEN, device="cuda", seed=SEED)
        step_a, _ = make_train_step(ma, mesh=mesh)
        step_b, _ = make_train_step(mb)
        la, lb = float(step_a(xd, yd)), float(step_b(xd, yd))
        pa, pb = trainable_to_numpy(ma), trainable_to_numpy(mb)
        check(la == lb and all(np.array_equal(pa[k], pb[k]) for k in pa),
              "the step over an NCCL world of one rank differs from the unsharded step")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_a(xd, yd)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if "nccl" in e.key.lower()]
        nccl = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
        nccl_calls = {e.key: e.count for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
        check(sum(nccl_calls.values()) > 0, "no NCCL collective in the step over the NCCL world")
        nccl_ms = cuda_ms(lambda: step_a(xd, yd), TRAIN_STEPS, warmup=1)
    finally:
        dist.destroy_process_group()
    launches = {name: k.COUNT.launches for name, k in kernels.items()}
    check(not any(launches.values()), f"the training path launched {launches}: it has no kernel of the port")
    out.update(nccl={"loss": la, "nccl_kernels": nccl, "nccl_calls": nccl_calls, "ms": nccl_ms}, launches=launches,
               seconds=time.perf_counter() - t_phase)
    print(f"phase 36 training ({card}): make_train_step(mesh=...) over an NCCL world of one rank equals the "
          f"unsharded step exactly (loss {la:.6f}), NCCL calls a step {json.dumps(nccl_calls)}, {nccl} NCCL "
          f"kernels on the card a step, {nccl_ms:.3f} ms a step; the "
          f"example converged on the card; kernel launches on the path {launches} (none: cuFFT and matmuls)")
    return out


def _gloo_cuda_collectives(mesh, n: int) -> None:
    """gloo's all-reduce and all-gather take CUDA tensors as they are: the
    port hands them over unstaged (``parallel/_comm.py``), so a refusal or a
    wrong value here fails the phase."""
    from audioflow_torch.parallel import _comm

    group = mesh.get_group("data")
    t = torch.full((4,), float(mesh.get_local_rank("data") + 1), device="cuda")
    s, g = _comm.all_reduce(t, group), _comm.all_gather(t, group)
    check(s.is_cuda and torch.equal(s.cpu(), torch.full((4,), n * (n + 1) / 2)), f"gloo all-reduce on the card: {s}")
    check(g.is_cuda and torch.equal(g[:, 0].cpu(), torch.arange(1.0, n + 1)), f"gloo all-gather on the card: {g}")


def _phase37_rank(rank: int, n: int) -> dict:
    """One rank of a gloo world on the shared card (phase 37): the batch and
    time modes of ``compile_sharded`` and, on 4 ranks, the DP x TP step on a
    (2, 2) mesh. Every input is made here from its seed."""
    from audioflow_torch.convert import trainable_to_numpy
    from audioflow_torch.models import TrainableFrontend, log_mel_frontend, make_train_step, master_chain_graph
    from audioflow_torch.ops.kernels import melspec
    from audioflow_torch.parallel import compile_sharded, make_mesh, mesh_device, shard_batch
    from audioflow_torch.profiling import tone_batch

    mesh = make_mesh(devices="cuda")
    dev = mesh_device(mesh)
    i = mesh.get_local_rank("data")
    _gloo_cuda_collectives(mesh, n)
    out = {}

    def run(name, fn, x):
        melspec.COUNT.launches = 0
        y = fn(x)
        torch.cuda.synchronize()
        launches = melspec.COUNT.launches
        out[name] = {"out": y.cpu().numpy(), "launches": launches, "ms": cuda_ms(lambda: fn(x), 3, warmup=1)}

    g = log_mel_frontend(RATE, 16000, 1024, 256, 128)
    run("batch", compile_sharded(g, mesh), shard_batch(tone_batch(SHARD_BATCH, SECONDS, RATE, SEED), mesh))
    part = LECTURE_SAMPLES // n
    lec = _lecture(LECTURE_SAMPLES, RATE, SEED + 37)[:, i * part : (i + 1) * part]
    run("time_logmel", compile_sharded(g, mesh, shard="time"), torch.from_numpy(np.ascontiguousarray(lec)).to(dev))
    part = MASTER_LECTURE_SAMPLES // n
    lec = _lecture(MASTER_LECTURE_SAMPLES, 16000, SEED + 38, gain=4.0)[:, i * part : (i + 1) * part]
    run("time_master", compile_sharded(master_chain_graph(16000), mesh, shard="time"),
        torch.from_numpy(np.ascontiguousarray(lec)).to(dev))
    if n == 4:
        mesh2 = make_mesh(axes=("data", "model"), shape=(2, 2), devices="cuda")
        model = TrainableFrontend(hidden=TRAIN_HIDDEN, device="cuda", seed=SEED)
        step, _ = make_train_step(model, mesh=mesh2, model_axis="model")
        x_np, y_np = _kws_clips(TRAIN_CLIPS, TRAIN_RATE, SEED)
        xs, ys = shard_batch(x_np, mesh2), shard_batch(y_np, mesh2)
        loss = float(step(xs, ys))
        out["tp"] = {"loss": loss, "params": trainable_to_numpy(model),
                     "coords": (mesh2.get_local_rank("data"), mesh2.get_local_rank("model")),
                     "ms": cuda_ms(lambda: step(xs, ys), TRAIN_STEPS, warmup=1)}
    return out


def sharding(dev: torch.device, card: str) -> dict:
    """Phase 37: gloo worlds of 2 and 4 ranks on the one card (NCCL refuses
    two ranks on a device), each rank a process with a deadline: the batch
    and time modes against the unsharded card run, the DP x TP step against
    the single-process step, and ``run --sharded`` under
    ``torch.distributed.run`` against ``run``."""
    import os
    import tempfile

    from audioflow_torch.convert import trainable_to_numpy
    from audioflow_torch.io import write_wav
    from audioflow_torch.models import TrainableFrontend, log_mel_frontend, make_train_step, master_chain_graph
    from audioflow_torch.parallel._worlds import run_world
    from audioflow_torch.profiling import tone_batch

    t_phase = time.perf_counter()
    g = log_mel_frontend(RATE, 16000, 1024, 256, 128)
    inputs = {
        "batch": (g, torch.from_numpy(tone_batch(SHARD_BATCH, SECONDS, RATE, SEED)).to(dev)),
        "time_logmel": (g, torch.from_numpy(_lecture(LECTURE_SAMPLES, RATE, SEED + 37)).to(dev)),
        "time_master": (master_chain_graph(16000),
                        torch.from_numpy(_lecture(MASTER_LECTURE_SAMPLES, 16000, SEED + 38, gain=4.0)).to(dev)),
    }
    # the unsharded runs on the card, the references and their times
    ref = {name: gr.chain(x).cpu().numpy() for name, (gr, x) in inputs.items()}
    one_ms = {name: cuda_ms(lambda gr=gr, x=x: gr.chain(x), 3, warmup=1) for name, (gr, x) in inputs.items()}
    # the plain log-mel graph on the same inputs, which the melspec kernel is
    # held to at the shapes the sharded paths give it (the fused graph is the
    # same kernel unsharded, and so checks the sharding only)
    plain = log_mel_frontend(RATE, 16000, 1024, 256, 128, fused=False)
    ref_plain = {name: plain.chain(inputs[name][1]).cpu().numpy() for name in ("batch", "time_logmel")}
    del inputs
    # the single-process step the DP x TP step is held to, and its gradients
    x_np, y_np = _kws_clips(TRAIN_CLIPS, TRAIN_RATE, SEED)
    xd, yd = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    m = TrainableFrontend(hidden=TRAIN_HIDDEN, device="cuda", seed=SEED)
    m.loss(xd, yd).backward()
    g_one = {k: p.grad.cpu().numpy() for k, p in m.named_parameters()}
    m = TrainableFrontend(hidden=TRAIN_HIDDEN, device="cuda", seed=SEED)
    step, _ = make_train_step(m)
    loss_one, p_one = float(step(xd, yd)), trainable_to_numpy(m)
    # the envelope's fp32 bound on the long master chain (see LECTURE_TOL's note)
    log_r = 1.0 / (50.0 * 1e-3 * 16000)
    env_rel = 4 * float(np.spacing(np.float32(MASTER_LECTURE_SAMPLES * log_r)))
    master_tol = SAMPLE_TOL + env_rel * float(np.abs(ref["time_master"]).max())
    thresh = 10 ** (-1.0 / 20)
    out = {"worlds": {}}
    for n in (2, 4):
        t0 = time.perf_counter()
        ranks = run_world(_phase37_rank, n, timeout=WORLD_TIMEOUT)
        world_s = time.perf_counter() - t0
        res = {"seconds": world_s}
        for name, axis in (("batch", 0), ("time_logmel", 1), ("time_master", 1)):
            got = np.concatenate([r[name]["out"] for r in ranks], axis=axis)
            want = ref[name]
            if name == "time_logmel":  # the unsharded frames, all of them covered
                check(got.shape[1] == LECTURE_SAMPLES * 160 // 441 // 256 and got.shape[0] == 1, f"{got.shape}")
                got = got[:, : want.shape[1]]
            check(got.shape == want.shape and bool(np.isfinite(got).all()), f"{n} ranks {name}: {got.shape}")
            d = float(np.abs(got - want).max())
            if name in ref_plain:  # the kernel at these shapes against its plain version
                d_plain = float(np.abs(got - ref_plain[name]).max())
                excess = float((np.abs(got - ref_plain[name]) - SLICE_TOL * np.abs(ref_plain[name])).max())
                check(excess <= SLICE_TOL, f"{n} ranks {name} vs the plain graph: max|d| {d_plain}")
            if name == "batch":
                check(d <= SHARD_BATCH_TOL, f"{n} ranks batch mode vs graph.chain: {d}")
            elif name == "time_logmel":
                excess = float((np.abs(got - want) - LECTURE_TOL * np.abs(want)).max())
                check(excess <= LECTURE_TOL, f"{n} ranks time mode log-mel vs the unsharded run: {d}")
            else:
                check(d <= master_tol, f"{n} ranks time mode master chain: {d} > {master_tol}")
                check(float(np.abs(got).max()) <= thresh * (1 + env_rel) + SAMPLE_TOL, "limiter peak")
            res[name] = {"max_abs_err": d, "vs_plain": d_plain if name in ref_plain else None,
                         "ms": [r[name]["ms"] for r in ranks], "unsharded_ms": one_ms[name],
                         "melspec_launches": [r[name]["launches"] for r in ranks]}
        check(all(r["batch"]["launches"] == 1 and r["time_logmel"]["launches"] == 1 for r in ranks),
              "melspec launches per rank, batch and time modes")
        check(all(r["time_master"]["launches"] == 0 for r in ranks), "the master chain launched melspec")
        if n == 4:
            by = {r["tp"]["coords"]: r["tp"] for r in ranks}
            for r in ranks:  # the replicated parameters alike on every rank
                for k in ("mel_gain", "pcen_alpha", "pcen_delta", "pcen_r", "b2"):
                    d_rep = float(np.abs(r["tp"]["params"][k] - by[(0, 0)]["params"][k]).max())
                    check(d_rep <= TRAIN_STEP_TOL, f"DP x TP: {k} differs between ranks by {d_rep}")
            for r in ranks:
                rel = abs(r["tp"]["loss"] - loss_one) / abs(loss_one)
                check(rel <= TRAIN_LOSS_RTOL, f"DP x TP loss {r['tp']['loss']} vs {loss_one}")
            got = dict(by[(0, 0)]["params"])
            for k, dim in (("w1", 1), ("b1", 0), ("w2", 0)):
                got[k] = np.concatenate([by[(0, mi)]["params"][k] for mi in range(2)], axis=dim)
            # the DP x TP gradients are the single step's summed in another
            # order: a reassociation of fp32 sums, bounded by 1e-6 of each
            # parameter's largest gradient
            g_diff = {k: np.full(v.shape, 1e-6 * np.abs(v).max()) for k, v in g_one.items()}
            res["tp"] = {"loss": by[(0, 0)]["loss"], "step_diff": _after_step_agree(
                got, p_one, g_one, g_diff, "DP x TP on (2, 2) vs one process"), "ms": [r["tp"]["ms"] for r in ranks]}
        out["worlds"][n] = res
        print(f"phase 37 sharding ({card}): a gloo world of {n} ranks on the card in {world_s:.1f} s; gloo's "
              f"all-reduce and all-gather took CUDA tensors as they are; "
              + "; ".join(f"{name} max|d| {res[name]['max_abs_err']:.3e}"
                          + (f" (vs the plain graph {res[name]['vs_plain']:.3e})" if res[name]["vs_plain"] is not None
                             else "")
                          + f", ms per rank {res[name]['ms']} (one "
                          f"process, unsharded: {one_ms[name]:.3f}), melspec launches per rank "
                          f"{res[name]['melspec_launches']}"
                          for name in ("batch", "time_logmel", "time_master"))
              + (f"; DP x TP (2, 2) step: loss {res['tp']['loss']:.6f} vs {loss_one:.6f}, parameters "
                 f"{res['tp']['step_diff']:.2e} on the clear entries, ms per rank {res['tp']['ms']}" if n == 4 else ""))

    # run --sharded under torch.distributed.run over phase 19's files: the
    # ranks' halves of each 32-file batch are the unsharded run's batches of
    # 16, at the same shapes, so exactly equal; against batches of 32 within
    # SHARD_BATCH_TOL
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        for i, row in enumerate(tone_batch(FILES, SECONDS, RATE, SEED)):
            write_wav(os.path.join(tmp, f"f{i:03d}.wav"), row, RATE)
        with open(os.path.join(tmp, CORRUPT), "wb") as f:
            f.write(b"RIFF\x24\x00\x00\x00WAVEfmt \x10\x00\x00\x00truncated")
        write_wav(os.path.join(tmp, OFF_RATE), tone_batch(1, SECONDS, 48000, SEED + 1)[0], 48000)
        glob = os.path.join(tmp, "*.wav")
        lines = {}
        for b in (16, FILE_BATCH):
            lines[b] = run_cli(["run", "-i", glob, "-g", "logmel", "--batch-size", str(b), "-o",
                                os.path.join(tmp, f"o{b}.npy"), "--stats", os.path.join(tmp, "s.json")])[-1]
        root = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
               "-m", "audioflow_torch.cli", "run", "-i", glob, "-g", "logmel", "--batch-size", str(FILE_BATCH),
               "--sharded", "--dist-backend", "gloo", "-o", os.path.join(tmp, "sharded.npy"),
               "--stats", os.path.join(tmp, "s.json")]
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root, env=env, timeout=WORLD_TIMEOUT)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"run --sharded under torch.distributed.run: {proc.stderr[-2000:]}")
        line = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
        got = np.load(os.path.join(tmp, "sharded.npy"))
        want16, want32 = np.load(os.path.join(tmp, "o16.npy")), np.load(os.path.join(tmp, f"o{FILE_BATCH}.npy"))
        check(line["n_devices"] == 2 and line["files"] == lines[16]["files"]
              and line["failed_files"] == lines[16]["failed_files"], f"{line} vs {lines[16]}")
        check(got.shape == want16.shape and np.array_equal(got, want16), "run --sharded vs run --batch-size 16")
        d32 = float(np.abs(got - want32).max())
        check(d32 <= SHARD_BATCH_TOL, f"run --sharded vs run --batch-size {FILE_BATCH}: {d32}")
    out["cli"] = {"line": line, "seconds": cli_s, "vs_batches_of_32": d32}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 37 run --sharded ({card}): torch.distributed.run --nproc-per-node 2 over {line['files']} files "
          f"({line['failed_files']} failed) in {cli_s:.1f} s ({line['batches']} batches, wall "
          f"{line['wall_seconds']:.3f} s on rank 0, {line['realtime_factor']:.0f}x realtime): exactly run "
          f"--batch-size 16's output, and within {d32:.2e} of run --batch-size {FILE_BATCH}'s (cuBLAS sums the "
          f"resampler's products by shape); unsharded run wall {lines[16]['wall_seconds']:.3f} s (16), "
          f"{lines[FILE_BATCH]['wall_seconds']:.3f} s ({FILE_BATCH}); phase 37 took {out['seconds']:.1f} s")
    return out


def _phase38_rank(rank: int, n: int) -> list:
    """One rank of phase 38's gloo world on the shared card: ``audioflow
    bench streaming --sharded``, its JSON rows (rank 0 prints them)."""
    return run_cli(["bench", "streaming", "--sharded"])


def _bench_line(row: dict) -> str:
    ms = row["wall_seconds"] / max(row["batches"], 1) * 1e3
    return f"{ms:.3f} ms/iter, {row['realtime_factor_per_chip']:.0f} audio-s/s per card"


def bench(dev: torch.device, card: str) -> dict:
    """Phase 38: ``audioflow bench all`` in the process under its profiler
    trace and report, the launches of the bench's kernel paths counted from
    0 around ``run_benchmark``, config 2's chunked log-mel (a shape no other
    phase gives the melspec kernel) against the plain graph, and ``bench
    streaming --sharded`` in an NCCL world of one rank and a gloo world of 2
    ranks. Returns the launches and the seconds."""
    import os
    import tempfile

    import torch.distributed as dist

    from audioflow_torch import bench as bench_mod
    from audioflow_torch.models import log_mel_frontend
    from audioflow_torch.ops.kernels import griffinlim, melspec, timestretch, viterbi
    from audioflow_torch.parallel._worlds import run_world

    t_phase = time.perf_counter()
    kernels = {"melspec": melspec, "timestretch": timestretch, "griffinlim": griffinlim, "viterbi": viterbi}

    def counts():
        return {k: m.COUNT.launches for k, m in kernels.items()}

    # the launches each path should make: BENCH_CALLS calls of one stream
    # over whole chunks (logmel_stream), of compile()'s chunked form
    # (logmel: as many chunks as the offline frames need), one kernel call
    # (pvoc, pitch); the session's open steps one chunk and a block of each
    # drain bucket, then every chunk four times (a warm and a timed pass,
    # three latency passes)
    g = log_mel_frontend(RATE, 16000, 1024, 256, 128)
    chunk = bench_mod._chunk(g)
    t = int(SECONDS * RATE)
    n_out = g.chain(torch.empty((1, t), device="meta")).shape[-2]
    chunks2 = max(-(-t // chunk), -(-(g.stream_latency(chunk) + n_out) // g.chunk_lens(chunk)[-1]))
    opened = 1 + sum(b for b in (8, 4, 2) if b * chunk <= 4 * chunk + 1)
    want = {"logmel_stream": {"melspec": BENCH_CALLS * (t // chunk)}, "logmel": {"melspec": BENCH_CALLS * chunks2},
            "pvoc": {"timestretch": BENCH_CALLS}, "pitch": {"timestretch": BENCH_CALLS},
            "session": {"melspec": opened + 4 * (t // chunk)}, "master": {}, "stft": {}}
    want = {name: {k: w.get(k, 0) for k in kernels} for name, w in want.items()}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        report, prof_dir = os.path.join(tmp, "bench.md"), os.path.join(tmp, "trace")
        for m in kernels.values():
            m.COUNT.launches = 0
        t0 = time.perf_counter()
        rows = run_cli(["bench", "all", "--report", report, "--profile-dir", prof_dir])
        torch.cuda.synchronize()
        all_s, all_launches = time.perf_counter() - t0, counts()
        check([r.get("benchmark") for r in rows] == list(BENCH_ALL), f"bench all rows {rows}")
        for r in rows:
            check(sorted(r) == sorted(BENCH_KEYS[r["benchmark"]]), f"bench {r['benchmark']} keys {sorted(r)}")
            if r["benchmark"] != "roofline":
                v = r["realtime_factor_per_chip"]
                check(math.isfinite(v) and v > 0, f"bench {r['benchmark']} realtime factor {v}")
        all_want = {k: want["logmel"][k] + want["session"][k] + want["pvoc"][k] for k in kernels}
        check(all_launches == all_want, f"bench all launches {all_launches} != {all_want}")
        with open(report) as f:
            lines = f.read().splitlines()
        check(lines[:4] == BENCH_REPORT_HEAD and [ln.split(" | ")[0] for ln in lines[4:]]
              == [f"| {n}" for n in BENCH_ALL[1:]], f"bench report {lines}")
        traces = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
        check(len(traces) == 1, f"profile dir holds {os.listdir(prof_dir)}")
        trace_mb = os.path.getsize(traces[0]) / 1e6
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        n_kernel_events = sum(1 for e in events if e.get("cat") == "kernel")
        check(any("melspec_fft_kernel" in k for k in names), "the trace names no melspec kernel")
        check(any("fft_analysis_kernel" in k for k in names) and any("phase_kernel" in k for k in names),
              "the trace names no timestretch kernel")
        del events
    roof = rows[0]
    print(f"phase 38 bench all ({card}): exit 0, {len(rows)} rows with the JAX rows' keys, the report's "
          f"{len(lines) - 4} table rows, a {trace_mb:.1f} MB trace ({n_kernel_events} kernel events; melspec and "
          f"timestretch named), in {all_s:.1f} s; launches {json.dumps(all_launches)} = logmel + session + pvoc; "
          f"roofline {roof['hbm_gbps']} GB/s of {HBM_BYTES_S / 1e9:.0f}, {roof['mxu_tflops_bf16']} bf16 TFLOP/s "
          f"of {BF16_FLOPS / 1e12:.0f} (triad {roof['triad_ms']} ms, matmul {roof['matmul_ms']} ms); traced rows: "
          + "; ".join(f"{r['benchmark']} {_bench_line(r)}" for r in rows[1:]))

    # untraced, launches counted from 0 around each run_benchmark
    counted = {}
    for name in want:
        for m in kernels.values():
            m.COUNT.launches = 0
        row = bench_mod.run_benchmark(name)
        torch.cuda.synchronize()
        counted[name] = {"row": row, "launches": counts()}
        check(counted[name]["launches"] == want[name], f"bench {name} launches {counted[name]['launches']} "
              f"!= {want[name]}")
        check(sorted(row) == sorted(BENCH_KEYS[name]), f"bench {name} keys {sorted(row)}")

    # config 2 at its full shape: compile()'s chunked form through the
    # melspec kernel against the plain two-node graph on the same input
    fn, x, _ = bench_mod._case("logmel")
    xt = torch.from_numpy(x).to(dev)
    got = fn.compile()(xt)
    plain = log_mel_frontend(RATE, 16000, 1024, 256, 128, fused=False).compile()(xt)
    err2 = (got - plain).abs().max().item()
    check(got.shape == plain.shape and bool(torch.isfinite(got).all()), f"config 2 {tuple(got.shape)}")
    check(err2 <= SLICE_TOL, f"config 2 kernel vs plain graph max|d| {err2} > {SLICE_TOL}")
    del xt, got, plain

    # bench streaming --sharded: a world of one NCCL rank in this process, then
    # a gloo world of 2 ranks on the card, whose rank 0 prints
    one = run_cli(["bench", "streaming", "--sharded"])
    check(len(one) == 1 and one[0]["n_devices"] == 1 and not dist.is_initialized(), f"sharded bench {one}")
    t0 = time.perf_counter()
    two = run_world(_phase38_rank, 2, timeout=WORLD_TIMEOUT)
    world_s = time.perf_counter() - t0
    check(len(two[0]) == 1 and two[1] == [] and two[0][0]["n_devices"] == 2, f"sharded bench, 2 ranks: {two}")
    for name, c in counted.items():
        print(f"phase 38 bench {name} ({card}): {_bench_line(c['row'])}, launches {json.dumps(c['launches'])} "
              f"(want {json.dumps(want[name])}); PERF.md section 5: {BENCH_PERF5.get(name, 'none')}")
    print(f"phase 38 bench streaming --sharded ({card}): NCCL, 1 rank: {_bench_line(one[0])}; gloo, 2 ranks on "
          f"the card: {_bench_line(two[0][0])} (world {world_s:.1f} s); PERF.md section 5: {BENCH_PERF5['streaming']}")
    seconds = time.perf_counter() - t_phase
    print(f"phase 38 config 2 ({card}): log_mel_frontend(...).compile() on {tuple(x.shape)}, {chunks2} chunks a "
          f"call through the melspec kernel, vs the plain graph: max|d| {err2:.3e} (tol {SLICE_TOL}); the shapes of "
          f"logmel_stream (phase 3), pvoc and pitch (phase 6) and session (phase 23) are held there; phase 38 took "
          f"{seconds:.1f} s")
    return {"seconds": seconds,
            "launches": {k: {name: c["launches"][k] for name, c in counted.items() if c["launches"][k]}
                         for k in kernels},
            "launches_all": all_launches}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke test runs only on one", file=sys.stderr)
        return 1
    from audioflow_torch.graph import GriffinLim, Graph, PitchShift, Pyin, Spectrogram, TimeStretch
    from audioflow_torch.models import log_mel_frontend
    from audioflow_torch.obs import trace
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
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda}; SM clock, max: {clocks}")
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
        nvcc_s = trace.snapshot()["first"].get(f"kernels.build.{name}")
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
    k_t = device_ms(lambda: melspec.mel_spectrogram(xs, cosb, sinb, win, fb, 256), 20, kernels=1)
    p_t = device_ms(lambda: melspec.mel_spectrogram_reference(xs, cosb, sinb, fb, 256), 20)
    c_t = device_ms(mel_cufft, 20)
    k_ms, p_ms, c_ms = k_t[0], p_t[0], c_t[0]
    fb_nnz = int((fb != 0).sum())
    print(f"phase 3 kernel vs plain at [{BATCH}, 5888] -> [{BATCH}, 20, 128], path {ms_path}: max|d| "
          f"{kernel_err:.3e} (tol {KERNEL_TOL}); dense path at n_fft 400, hop 160 on 8 rows: max|d| "
          f"{dense_err:.3e}; kernel {timed(k_t)}, plain {timed(p_t)}, cuFFT composition {timed(c_t)} "
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

    ts_path = timestretch.kernel_path(n_fft, 256)
    check(ts_path == "fft", f"timestretch takes the {ts_path} path at n_fft 1024, hop 256")
    ts_err, ts_rel = stretch_err(x, 1.25)
    check(ts_rel <= STRETCH_TOL, f"timestretch vs plain at rate 1.25: rel {ts_rel} > {STRETCH_TOL}")
    half_rel = stretch_err(x, 0.5)[1]  # the PitchShift(12.0) path's shape
    check(half_rel <= STRETCH_TOL, f"timestretch vs plain at rate 0.5: rel {half_rel} > {STRETCH_TOL}")
    rels = {}
    for rate in (0.8, 2.0 / 3.0, 0.5, 2.0):
        rels[f"{rate:.4f}"] = stretch_err(x[:8].contiguous(), rate)[1]
        check(rels[f"{rate:.4f}"] <= STRETCH_TOL, f"timestretch vs plain at rate {rate}: {rels}")
    # the dense path at n_fft 960, hop 240 on 8 rows
    check(timestretch.kernel_path(960, 240) == "dense", "timestretch at 960/240 does not take the dense path")
    xd = x[:8].contiguous()
    dense_want = timestretch.time_stretch_reference(xd, 1.25, 960, 240)
    ts_dense_rel = ((timestretch.time_stretch_fused(xd, 1.25, 960, 240) - dense_want).abs().max()
                    / dense_want.abs().max()).item()
    check(ts_dense_rel <= STRETCH_TOL, f"dense timestretch vs plain: rel {ts_dense_rel} > {STRETCH_TOL}")
    # two launches on the same input: bitwise equal
    check(torch.equal(timestretch.time_stretch_fused(x, 1.25), timestretch.time_stretch_fused(x, 1.25)),
          "two timestretch launches on the same input differ")
    del xd, dense_want
    # by device time, as melspec and griffinlim: the kernel, its plain
    # version, and the cuFFT composition (time_stretch(impl="fft"), a
    # yardstick the kernel path never calls)
    ts_t = device_ms(lambda: timestretch.time_stretch_fused(x, 1.25), 10, kernels=3)  # three passes
    tp_t = device_ms(lambda: timestretch.time_stretch_reference(x, 1.25), 2)
    tc_t = device_ms(lambda: time_stretch(x, 1.25, impl="fft"), 10)
    ts_ms, tp_ms, tc_ms = ts_t[0], tp_t[0], tc_t[0]
    plan = timestretch.make_plan(t, 1.25, n_fft, 256)
    # per input frame: window, rFFT, magnitude and unit increment phasor
    # (14 per bin); per output frame: magnitude interpolation, phase
    # product, renormalisation and scaling (18 per bin), inverse rFFT,
    # synthesis window and overlap-add; per output sample, the WOLA divide
    ts_flops = PVOC_BATCH * (
        plan.n_in * (n_fft + rfft_flops(n_fft) + 14 * n_bins)
        + plan.n_out * (18 * n_bins + rfft_flops(n_fft) + 2 * n_fft) + plan.out_len
    )
    ts_bound, ts_by = bound_ms(ts_flops, 4 * PVOC_BATCH * (t + plan.out_len))
    print(f"phase 6 timestretch vs plain at [{PVOC_BATCH}, {t}] rate 1.25, path {ts_path}: max|d| {ts_err:.3e}, "
          f"rel {ts_rel:.3e}; rate 0.5 on all rows: rel {half_rel:.3e}; on 8 rows at other rates: "
          f"rel {json.dumps(rels)} (tol {STRETCH_TOL}); dense path at 960/240 on 8 rows: rel {ts_dense_rel:.3e}; "
          f"two launches bitwise equal; kernel {timed(ts_t)}, plain {timed(tp_t)}, cuFFT composition "
          f"{timed(tc_t)}, bound {ts_bound:.4f} ms ({ts_by}: {ts_flops / 1e9:.3f} GFLOP with FFTs; "
          f"{ts_bound / ts_ms:.1%} of it); {plan.n_in} input, {plan.n_out} output frames ({card})")

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
    ref = time_stretch(xs, 1.25, impl="fft").cpu().numpy()  # the same path through cuFFT
    gate_fft = float(np.abs(ref[:n] - got[:n]).max() / np.abs(ref).max())
    check(gate_fft < PVOC_GATE, f"kernel vs cuFFT composition rel {gate_fft} >= {PVOC_GATE}")
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * tt)).astype(np.float32)
    shifted = pitch(tone).cpu().numpy()
    peak_hz = float(np.argmax(np.abs(np.fft.rfft(shifted * np.hanning(shifted.size))))) * PVOC_RATE / shifted.size
    check(abs(peak_hz - 880.0) <= PVOC_RATE / shifted.size, f"pitch +12 of 440 Hz peaks at {peak_hz} Hz")
    print(f"phase 7 slice: TimeStretch(1.25) {PVOC_BATCH} x {t} -> ({PVOC_BATCH}, 128000), "
          f"PitchShift(12.0) -> {tuple(y.shape)}, finite, timestretch launches {ts_launches} for 2 "
          f"calls; kernel vs matmul path on 1 s 440 Hz + noise: rel {gate:.3e}, vs the cuFFT composition "
          f"(impl='fft') {gate_fft:.3e} (gate {PVOC_GATE}); "
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
          f"{ts_ms:.4f} ms vs plain {tp_ms:.4f} ms and cuFFT composition {tc_ms:.4f} ms, bound {ts_bound:.4f} ms "
          f"({ts_by}; {ts_bound / ts_ms:.1%} of it)")

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
    gk_t = device_ms(lambda: griffinlim.griffin_lim_iteration(mag, zeros, mag, zeros, mag, 0.99), 10, kernels=1)
    gp_t = device_ms(lambda: griffinlim.griffin_lim_iteration_reference(mag, zeros, mag, zeros, mag, 0.99, gd), 10)
    gc_t = device_ms(lambda: gl_cufft(0.99), 10)
    gk_ms, gp_ms, gc_ms = gk_t[0], gp_t[0], gc_t[0]
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
          f"kernel {timed(gk_t)} per iteration, plain {timed(gp_t)}, cuFFT composition {timed(gc_t)} "
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
    vit_cluster = viterbi.kernel_path(PYIN_BATCH, n_bins, k_taps)
    check(vit_cluster > 1, f"viterbi takes clusters of {vit_cluster} blocks at the pyin shape")
    got = viterbi.pyin_viterbi_forward(lv, lu, *vargs)
    want = viterbi.pyin_viterbi_forward_reference(lv, lu, *vargs)
    torch.cuda.synchronize()
    for name, g, w in zip(("dv", "du", "off", "pick"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), f"viterbi {name} differs from plain")
    vit_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    raw_max = int(got[2].max()) + half
    # batch 1 (clusters of 8) on the first row, and a small band (20 bins,
    # 29 taps) whose margins span more than one neighbour
    small = {}
    for name, (ov, ou, tk) in {
        "row0": (lv[:, :1], lu[:, :1], lk),
        "narrow": (lv[:, :3, 300:320], lu[:, :3, 300:320], lk[55:84]),
    }.items():
        ov, ou = ov.contiguous(), ou.contiguous()
        small[name] = viterbi.kernel_path(ov.shape[1], ov.shape[2], tk.shape[0])
        pair = (viterbi.pyin_viterbi_forward(ov, ou, tk, *vargs[1:]),
                viterbi.pyin_viterbi_forward_reference(ov, ou, tk, *vargs[1:]))
        for label, g, w in zip(("dv", "du", "off", "pick"), *pair):
            check(torch.equal(g, w), f"viterbi {label} differs from plain on {name} ({small[name]} blocks)")
    # 8 blocks for one row; under 14 bins (half the 29 taps) a block for the narrow band
    check(small["row0"] == 8 and -(-20 // small["narrow"]) < 14, f"viterbi clusters {small}")
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
    del got, want, tie, tv, tu, pair
    vk_t = device_ms(lambda: viterbi.pyin_viterbi_forward(lv, lu, *vargs), 10, kernels=1)
    vp_t = device_ms(lambda: viterbi.pyin_viterbi_forward_reference(lv, lu, *vargs), 2)
    vk_ms, vp_ms = vk_t[0], vp_t[0]
    # an add and a max per tap, state and frame past the first, and the
    # merge's 2 adds, compare, select and add per state; bytes: the two
    # observation tensors in, the final messages and the int8 backpointers out
    vit_states = 2 * PYIN_BATCH * n_bins
    vit_flops = (n_frames - 1) * vit_states * (2 * k_taps + 5) + vit_states
    vit_bytes = 4 * 2 * n_frames * PYIN_BATCH * n_bins + 4 * vit_states + 2 * n_frames * vit_states + 4 * k_taps
    vit_bound, vit_by = bound_ms(vit_flops, vit_bytes)
    print(f"phase 12 viterbi vs plain at [{n_frames}, {PYIN_BATCH}, {n_bins}], {k_taps} taps, clusters of "
          f"{vit_cluster} blocks: dv, du, off, pick exactly equal (max|d| {vit_err}; raw offsets up to {raw_max}); "
          f"at batch 1 and on 3 rows of 20 bins with 29 taps (clusters {json.dumps(small)}) and on the 255-tap "
          f"tie case [64, 8, 700] exactly equal; kernel {timed(vk_t)}, plain {timed(vp_t)}, bound "
          f"{vit_bound:.4f} ms ({vit_by}: "
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

    launches5 = configs_3_and_5(dev, card)
    files = file_path(dev, card)
    dict_out = dictation(dev, card)
    lv = dict_out["launches_validate"]
    mastering(dev, card)
    cqt_out = cqt_rhythm(dev, card)
    ana = analysis(dev, card)
    la = ana["launches"]
    train = training(dev, card)
    shard = sharding(dev, card)
    sharded_launches = {f"{n}_ranks": {mode: w[mode]["melspec_launches"] for mode in ("batch", "time_logmel")}
                        for n, w in shard["worlds"].items()}
    bench_out = bench(dev, card)

    print(json.dumps({"seconds": {"phase_34": ana["seconds"]["34"], "phase_35": ana["seconds"]["35"],
                                  "phase_36": train["seconds"], "phase_37": shard["seconds"],
                                  "phase_38": bench_out["seconds"],
                                  "whole_run": time.perf_counter() - t_start}}))

    print(json.dumps({"kernels": [
        {
            "name": "melspec", "route": "cuda", "source": "audioflow_torch/csrc/melspec.cu",
            "replaces": "audioflow_tpu/ops/pallas/melspec.py:137", "launches": launches,
            "launches_config5": launches5, **files, "launches_session": dict_out["launches_session"],
            "launches_dictation": dict_out["launches_dictation"], "launches_validate": lv["melspec"],
            "launches_cqt_rhythm": cqt_out["launches"]["melspec"], "launches_analysis": la["melspec"],
            "launches_inspect": ana["launches_inspect"]["melspec"], "launches_training": train["launches"]["melspec"],
            "launches_sharded_per_rank": sharded_launches, "launches_bench": bench_out["launches"]["melspec"],
            "launches_bench_all": bench_out["launches_all"]["melspec"],
            "max_abs_err": kernel_err, "ms": k_ms, "ms_readings": k_t[1], "plain_ms": p_ms,
            "bound_ms": ms_bound, "bound_by": ms_by, "library_ms": None, "path": ms_path, "cufft_ms": c_ms,
        },
        {
            "name": "timestretch", "route": "cuda", "source": "audioflow_torch/csrc/timestretch.cu",
            "replaces": "audioflow_tpu/ops/pallas/timestretch.py:358", "launches": ts_launches,
            "launches_validate": lv["timestretch"], "launches_cqt_rhythm": cqt_out["launches"]["timestretch"],
            "launches_analysis": la["timestretch"], "launches_bench": bench_out["launches"]["timestretch"],
            "launches_bench_all": bench_out["launches_all"]["timestretch"],
            "max_abs_err": ts_err, "ms": ts_ms, "ms_readings": ts_t[1], "plain_ms": tp_ms,
            "bound_ms": ts_bound, "bound_by": ts_by, "library_ms": None, "path": ts_path, "cufft_ms": tc_ms,
        },
        {
            "name": "griffinlim", "route": "cuda", "source": "audioflow_torch/csrc/griffinlim.cu",
            "replaces": "audioflow_tpu/ops/pallas/griffinlim.py:216", "launches": gl_launches,
            "launches_validate": lv["griffinlim"], "launches_cqt_rhythm": cqt_out["launches"]["griffinlim"],
            "launches_analysis": la["griffinlim"],
            "max_abs_err": gl_err, "ms": gk_ms, "ms_readings": gk_t[1], "plain_ms": gp_ms,
            "bound_ms": gl_bound, "bound_by": gl_by, "library_ms": None, "path": gl_path, "cufft_ms": gc_ms,
        },
        {
            "name": "viterbi", "route": "cuda", "source": "audioflow_torch/csrc/viterbi.cu",
            "replaces": "audioflow_tpu/ops/pallas/viterbi.py:124", "launches": vit_launches,
            "launches_validate": lv["viterbi"], "launches_cqt_rhythm": cqt_out["launches"]["viterbi"],
            "launches_analysis": la["viterbi"], "launches_pitch_cli": ana["launches_pitch_cli"],
            "max_abs_err": vit_err, "ms": vk_ms, "ms_readings": vk_t[1], "plain_ms": vp_ms,
            "bound_ms": vit_bound, "bound_by": vit_by, "library_ms": None, "cluster": vit_cluster,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
