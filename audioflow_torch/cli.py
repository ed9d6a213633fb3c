"""audioflow CLI of the port — the framework's command surface on the card.

Mirrors ``audioflow_tpu/cli.py``:

  devices            device enumeration (the CUDA cards, or the CPU)
  info               version/platform info
  config show|path|set  config inspection/persistence
  run                offline graph over audio files -> sink   (the DSP path)
  stream             streaming session over a file, npy/wire egress
  key                API-key storage (env or secrets file)
  egress             a file through the dictation path to a WebSocket ASR endpoint
  vad                VAD segments of a file
  pitch              YIN / pYIN / streaming pYIN f0 track of a file
  align              DTW alignment of two files over MFCC or log-mel frames
  segments           structural section boundaries (Foote novelty)
  separate           blind NMF source separation -> one WAV per component
  loudness           BS.1770/R128 loudness meter (and optional normalizer)
  validate           numerics against float64 oracles, the JAX package's budgets
  inspect            cost counts of one call of a graph
  bench              throughput benchmarks (the JAX bench's cases)

Every command that computes takes ``--device`` ("cuda" unless given;
without a card it fails with DEVICE_NOT_FOUND rather than carry on on the
CPU). The output is the JAX CLI's JSON; every JAX subcommand is here.

Usage: python -m audioflow_torch.cli <command> [options]
"""

from __future__ import annotations

import argparse
import contextlib
import glob as _glob
import json
import os
import sys

import numpy as np

from . import __version__
from .config import ConfigManager, default_config_path, graph_from_spec
from .errors import AudioFlowError
from .obs import StatsFile, get_logger, setup_logging
from .sinks import auto_sink

_log = get_logger("cli")

# the JAX CLI's graph names, each built by _build_graph
_GRAPHS = (
    "logmel", "stft", "eq", "master", "vad", "wire", "fbank", "kws",
    "deltafbank", "denoise", "features", "chroma", "cqt", "cqtroundtrip",
    "onset", "beats", "contrast", "tonnetz",
)


def _build_graph(name: str, input_rate: int, cfg, streaming: bool = False, multirate: bool = False):
    from .graph import (
        Chroma,
        Cqt,
        CqtRoundTripMultirate,
        Icqt,
        SpectralContrast,
        SpectralFeatures,
        Spectrogram,
        Tonnetz,
        chain,
    )
    from .models import (
        beat_graph,
        cqt_frontend,
        delta_fbank_frontend,
        denoise_master_chain,
        eq_chain_graph,
        kaldi_fbank_frontend,
        kws_frontend,
        log_mel_frontend,
        master_chain_graph,
        onset_frontend,
        stft_magnitude_graph,
        vad_graph,
        wire_egress_graph,
    )

    a = cfg.audio
    if name == "logmel":
        return log_mel_frontend(input_rate, a.target_rate, a.n_fft, a.hop, a.n_mels, a.resample_mode)
    if name == "stft":
        return stft_magnitude_graph(input_rate, a.n_fft, a.hop, center=not streaming)
    if name == "eq":
        return eq_chain_graph(input_rate)
    if name == "master":
        return master_chain_graph(input_rate)
    if name == "vad":
        return vad_graph(input_rate, a.chunk_ms)
    if name == "wire":
        return wire_egress_graph(input_rate, a.target_rate)
    if name == "fbank":
        return kaldi_fbank_frontend(input_rate, n_mels=a.n_mels)
    if name == "kws":
        return kws_frontend(input_rate, a.n_fft, a.hop)
    if name == "deltafbank":
        return delta_fbank_frontend(input_rate)
    if name == "denoise":
        return denoise_master_chain(input_rate)
    if name == "features":
        return chain(
            Spectrogram(a.n_fft, a.hop, center=False, power=False),
            SpectralFeatures(("centroid", "bandwidth", "rolloff", "flatness", "flux"), n_bins=a.n_fft // 2 + 1),
            input_rate=input_rate,
        )
    if name == "chroma":
        return chain(Spectrogram(a.n_fft, a.hop, center=False, power=True), Chroma(), input_rate=input_rate)
    if name == "cqt":
        return cqt_frontend(input_rate, a.hop)
    if name == "cqtroundtrip":
        # audio -> complex CQT -> audio: the fixed-hop transform and its
        # hybrid inverse (tonal content only past the painless cliff), or with
        # --multirate the broadband-invertible per-octave-hop variant
        if multirate:
            return chain(CqtRoundTripMultirate(hop=a.hop), input_rate=input_rate)
        return chain(Cqt(hop=a.hop, output="complex", impl="onedot"), Icqt(hop=a.hop), input_rate=input_rate)
    if name == "onset":
        return onset_frontend(input_rate, a.n_fft, a.hop)
    if name == "beats":
        return beat_graph(input_rate, a.n_fft, a.hop)
    if name == "contrast":
        return chain(Spectrogram(a.n_fft, a.hop, center=False, power=False), SpectralContrast(), input_rate=input_rate)
    if name == "tonnetz":
        return chain(
            Spectrogram(a.n_fft, a.hop, center=False, power=True), Chroma(), Tonnetz(), input_rate=input_rate
        )
    raise SystemExit(f"unknown graph {name!r}; known: {_GRAPHS}")


def _expand_inputs(patterns: list[str]) -> list[str]:
    files: list[str] = []
    for p in patterns:
        hits = sorted(_glob.glob(p))
        files.extend(hits if hits else [p])
    if not files:
        raise SystemExit("no input files")
    return files


def cmd_devices(args) -> int:
    import torch

    if torch.cuda.is_available():
        rows = [
            {"id": i, "platform": "gpu", "kind": torch.cuda.get_device_name(i), "process": 0}
            for i in range(torch.cuda.device_count())
        ]
    else:
        rows = [{"id": 0, "platform": "cpu", "kind": "cpu", "process": 0}]
    print(json.dumps(rows, indent=None if args.json else 2))
    return 0


def cmd_info(args) -> int:
    import torch

    cuda = torch.cuda.is_available()
    info = {
        "name": "audioflow-torch",
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "config_path": str(default_config_path()),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_config(args) -> int:
    mgr = ConfigManager(args.file)
    if args.action == "path":
        print(mgr.path)
        return 0
    mgr.load()
    if args.action == "show":
        print(json.dumps(mgr.current().to_dict(), indent=2))
        return 0
    if args.action == "set":
        section, _, key = args.key.partition(".")

        def apply(cfg):
            obj = getattr(cfg, section, None)
            if obj is None or not hasattr(obj, key):
                raise SystemExit(f"unknown config key {args.key!r}")
            cur = getattr(obj, key)
            typ = type(cur) if cur is not None else str
            val = typ(args.value) if typ is not bool else args.value.lower() in ("1", "true", "yes")
            setattr(obj, key, val)

        mgr.update(apply)
        mgr.save()
        print(f"saved {args.key} to {mgr.path}")
        return 0
    raise SystemExit(f"unknown config action {args.action}")


def _load_batch(files, pad_multiple):
    from .io import decode_batch

    batch = decode_batch(files, pad_multiple=pad_multiple)
    if not batch.valid.any():
        raise SystemExit("all input files failed to decode")
    bad = [str(p) for p, v in zip(batch.paths, batch.valid) if not v]
    if bad:
        _log.warning("failed lanes (masked, not fatal): %s", bad)
    return batch


def _probe_head(path):
    """The WAV header of ``path``: fmt/data chunks usually sit in the first
    4 KB, but LIST/bext metadata can push them far deeper — grow the head
    until the header parses (full read as the last resort)."""
    from .io import wav

    for head in (4096, 1 << 16, None):
        with open(path, "rb") as fh:
            buf = fh.read(head) if head else fh.read()
        try:
            return wav.probe(buf, truncated=True)
        except Exception:
            if head is None:
                raise
    raise AssertionError  # unreachable


def _graph_for(args, input_rate, cfg):
    if args.spec:
        with open(args.spec) as f:
            return graph_from_spec(json.load(f))
    return _build_graph(args.graph, input_rate, cfg, multirate=args.multirate)


def _user_config(args):
    return ConfigManager(args.config).load() if args.config else ConfigManager().current()


@contextlib.contextmanager
def _sharded_world(args, device):
    """The world of ranks of ``--sharded``: one rank under a plain call, or
    the ranks ``torch.distributed.run`` starts (``--dist-backend gloo`` for
    ranks that share a card); a process group that exists already is used
    as it is. One made here is destroyed on exit."""
    import torch.distributed as dist

    from .parallel import multihost_init

    one = "WORLD_SIZE" not in os.environ
    created = multihost_init(
        num_processes=1 if one else None, process_id=0 if one else None,
        backend=args.dist_backend or ("nccl" if device.type == "cuda" else "gloo"),
    )
    try:
        yield
    finally:
        if created:
            dist.destroy_process_group()


def cmd_run(args) -> int:
    """``run``; with ``--sharded``, over the world of ranks."""
    from .utils import resolve_device

    device = resolve_device(args.device)
    if not args.sharded:
        return _run(args, device, None)
    from .parallel import make_mesh

    with _sharded_world(args, device):
        return _run(args, device, make_mesh(devices=device.type))


def _run(args, device, mesh) -> int:
    from .obs import RunMetrics, Timer
    from .obs.metrics import sync
    from .utils import as_tensor, round_up

    root = True
    if mesh is not None:
        import torch.distributed as dist

        from .parallel import mesh_device

        device, root = mesh_device(mesh), dist.get_rank() == 0
    cfg = _user_config(args)
    files = _expand_inputs(args.input)

    def _finish(sink, metrics):
        res = sink.close()
        stats = StatsFile(args.stats) if args.stats else StatsFile()
        stats.record_run(metrics.audio_seconds)
        stats.save()
        out_name = str(res) if isinstance(res, (str, os.PathLike)) else "array"
        print(json.dumps({"output": out_name, **metrics.to_dict()}))

    if args.batch_size:
        # multi-batch pipelined runner: per-lane masking handles bad files
        # and wrong rates, so no up-front whole-input decode is needed —
        # just probe headers for the stride and the input rate
        from .io import BatchLoader
        from .runner import run_batches

        max_frames, rate_votes = 1, {}
        for f in files:
            try:
                size = os.path.getsize(f)
                info = _probe_head(f)
            except Exception:
                continue
            # clamp the declared size against the actual file size: streaming
            # encoders often leave 0xFFFFFFFF placeholders that would explode
            # the staging allocation
            frame_bytes = max(1, info.channels * (info.bits // 8))
            n = min(info.n_frames, max(0, size - info.data_offset) // frame_bytes)
            max_frames = max(max_frames, n)
            rate_votes[info.sample_rate] = rate_votes.get(info.sample_rate, 0) + 1
        input_rate = args.input_rate or (
            max(rate_votes, key=rate_votes.get) if rate_votes else cfg.audio.sample_rate
        )
        g = _graph_for(args, input_rate, cfg)
        stride = round_up(int(max_frames), 1024)
        sink = auto_sink(args.output, sample_rate=g.output_rate) if root else None
        loader = BatchLoader(files, batch_size=args.batch_size, stride=stride)
        m = run_batches(g, loader, sinks=[sink] if root else [], mesh=mesh, expect_rate=input_rate, device=device)
        if root:
            _finish(sink, m)
        return 0

    batch = _load_batch(files, pad_multiple=1024)
    rates = set(batch.rates[batch.valid].tolist())
    if len(rates) > 1:
        raise SystemExit(
            f"mixed sample rates in batch: {sorted(rates)} "
            "(use --batch-size with --input-rate to mask off-rate lanes)"
        )
    input_rate = args.input_rate or (rates.pop() if rates else cfg.audio.sample_rate)
    g = _graph_for(args, input_rate, cfg)

    if mesh is None:
        fn = g.compile()
        x = as_tensor(batch.samples, device)
    else:
        from .parallel import _comm, compile_sharded, pad_batch, shard_batch

        padded, _ = pad_batch(batch.samples, mesh)
        x = shard_batch(padded, mesh)
        local = compile_sharded(g, mesh)

        def fn(xl):
            out = local(xl)
            return _comm.all_gather(out, mesh.get_group("data")).reshape(-1, *out.shape[1:])

    with Timer() as tc:  # first call: kernel builds at first use
        sync(fn(x))
    with Timer() as tr:
        out = fn(x)
        sync(out)
    if not root:
        return 0
    host = out.cpu().numpy()[: len(files)]

    m = RunMetrics(
        audio_seconds=batch.audio_seconds,
        wall_seconds=tr.elapsed,
        compile_seconds=tc.elapsed,
        files=len(files),
        failed_files=int((~batch.valid).sum()),
        batches=1,
        n_devices=1 if mesh is None else mesh.size(),
    )
    sink = auto_sink(args.output, sample_rate=g.output_rate)
    sink.write(host)
    _finish(sink, m)
    return 0


def _read_mono(path):
    from .io import read_audio

    data, rate = read_audio(path)
    if data.ndim == 2:
        data = data.mean(axis=1).astype(np.float32)
    return data, rate


def cmd_stream(args) -> int:
    from .session import StreamSession

    cfg = _user_config(args)
    data, rate = _read_mono(args.input)
    g = _build_graph(args.graph, rate, cfg, streaming=True)
    sinks = [auto_sink(args.output, sample_rate=g.output_rate)] if args.output else []
    # a file source outruns the card: push 8-chunk blocks, which the
    # session's multi-chunk drain steps as one block each
    gran = g.chunk_granularity()
    chunk = args.chunk or gran * max(1, 4096 // gran)
    sess = StreamSession(g, chunk_in=chunk, sinks=sinks, ring_capacity=17 * chunk, device=args.device)
    with sess:
        step = args.push_size or 8 * sess.chunk_in
        for i in range(0, len(data), step):
            sess.push(data[i : i + step])
        sess.flush()
        results = sess.poll_all()
    print(
        json.dumps(
            {
                "chunks": len(results),
                "latency": g.stream_latency(sess.chunk_in),
                "audio_seconds": len(data) / rate,
                "output": str(args.output) if args.output else None,
            }
        )
    )
    return 0


def cmd_key(args) -> int:
    """API-key storage: set, get (the environment wins) and delete."""
    from .config import EnvKeyStorage, FileKeyStorage
    from .errors import ConfigError

    file_store = FileKeyStorage(args.file) if args.file else FileKeyStorage()
    if args.action == "set":
        if not args.value:
            raise SystemExit("key set needs a value")
        # env vars die with this process; a persistent set always uses the file
        file_store.store(args.account, args.value)
        print(f"stored key for {args.account} in {file_store.path}")
    elif args.action == "get":
        try:
            print(EnvKeyStorage().retrieve(args.account))
        except ConfigError:
            print(file_store.retrieve(args.account))
    elif args.action == "delete":
        file_store.delete(args.account)
        print(f"deleted key for {args.account}")
    return 0


def cmd_egress(args) -> int:
    """The dictation egress end to end: a file -> (VAD gate) -> 16 kHz
    resample -> i16 wire chunks -> WebSocket, printing transcript events as
    they arrive, through a ScribeSession (receive thread, keepalive
    pings, reconnect with session resume). The graph runs on ``--device``."""
    from .graph import Resample, VadGate, chain
    from .session import ScribeConfig, ScribeSession
    from .sinks import WebSocketConfig

    data, rate = _read_mono(args.input)
    nodes = []
    if args.vad_gate:
        nodes.append(VadGate(frame_len=rate * 20 // 1000))
    if rate != 16000:
        nodes.append(Resample(rate, 16000, "cubic"))
    g = chain(*nodes, input_rate=rate) if nodes else None

    cfg = _user_config(args)
    api_key = args.api_key or ""
    if not api_key and cfg.api.api_key_env:
        api_key = os.environ.get(cfg.api.api_key_env, "")
    session = ScribeSession(
        ScribeConfig(
            model_id=cfg.api.model_id,
            language_code=cfg.api.language_code,
            ws=WebSocketConfig(
                url=args.url,
                api_key=api_key,
                connect_timeout_s=cfg.api.connect_timeout_s,
                reconnect_delay_ms=cfg.api.reconnect_delay_ms,
                max_reconnect_attempts=cfg.api.max_reconnect_attempts,
            ),
        )
    )
    pcm = g.compile()(data, device=args.device).cpu().numpy() if g else data
    chunk = args.chunk or 16000 // 5  # 200 ms
    results = []

    def print_new():
        while (out := session.poll()) is not None:
            results.append(out)
            print(json.dumps(out))

    with session:
        for i in range(0, len(pcm), chunk):
            session.send_audio(pcm[i : i + chunk], wait_reconnect_s=args.receive_timeout)
            print_new()  # results arrive on the receive thread; show them as they come
        if not any(r["is_final"] for r in results):
            for out in session.drain(timeout=args.receive_timeout):
                results.append(out)
                print(json.dumps(out))
    print(json.dumps({"chunks_sent": session.chunks_sent, "results": len(results)}))
    return 0


def cmd_vad(args) -> int:
    from .models import vad_graph

    data, rate = _read_mono(args.input)
    # --level (a named preset) wins over --threshold-db; with neither, the
    # config's audio.vad_level applies
    level = args.level
    if level is None and args.threshold_db is None:
        level = _user_config(args).audio.vad_level
    g = vad_graph(
        rate,
        threshold_db=args.threshold_db if args.threshold_db is not None else -50.0,
        level=level or "",
    )
    states = g.compile()(np.asarray(data, np.float32), device=args.device).cpu().numpy()
    frame_s = g.nodes[0].frame_len / rate
    segments = []
    start = None
    for i, s in enumerate(states):
        if s == 1 and start is None:
            start = i
        elif s != 1 and start is not None:
            segments.append({"start_s": round(start * frame_s, 3), "end_s": round(i * frame_s, 3)})
            start = None
    if start is not None:
        segments.append({"start_s": round(start * frame_s, 3), "end_s": round(len(states) * frame_s, 3)})
    print(json.dumps({"frames": len(states), "speech_segments": segments}))
    return 0


def cmd_validate(args) -> int:
    from .validate import run_validation

    report = run_validation(device=args.device)
    print(json.dumps(report, indent=2))
    # pass also needs vad_state_mismatches == 0 and quantize_i16 == 0: gate
    # on the whole verdict, not on max_abs_err alone
    return 0 if report["pass"] else 1


def cmd_pitch(args) -> int:
    """f0 track of an audio file: frame times, f0 (Hz), voiced flag.

    ``--method yin`` (default) thresholds the CMND aperiodicity; ``pyin``
    runs the probabilistic tracker with its HMM decode (on the card, one
    launch of the viterbi kernel); ``pyin-online`` the fixed-lag streaming
    tracker (``ops.pyin_online``, the ``OnlinePyin`` node's algorithm),
    ``--lag`` frames of decode delay. The online tracker frames without
    centering, so its ``t`` adds half a frame to share the centered
    methods' timeline, and the file's last ``lag`` frames are not emitted
    (they need audio past the end)."""
    from . import ops
    from .utils import as_tensor

    data, rate = _read_mono(args.input)
    x = as_tensor(data, args.device)
    if args.method == "pyin-online":
        lag = args.lag
        f0, vflag, vprob = ops.pyin_online(x, rate, args.fmin, args.fmax, args.frame_length, args.hop, lag)
        # emission j decodes frame j - lag: report on the frame timeline
        f0, vflag, vprob = f0[lag:], vflag[lag:], vprob[lag:]
    elif args.method == "pyin":
        f0, vflag, vprob = ops.pyin(x, rate, args.fmin, args.fmax, args.frame_length, args.hop)
    if args.method in ("pyin", "pyin-online"):
        f0, voiced = f0.cpu().numpy(), vflag.cpu().numpy()
        ap = 1.0 - vprob.cpu().numpy()  # reported as an aperiodicity-like score
    else:
        f0, ap = ops.yin_voicing(x, rate, args.fmin, args.fmax, args.frame_length, args.hop)
        f0, ap = f0.cpu().numpy(), ap.cpu().numpy()
        voiced = ap < args.voiced_threshold
    hop_s = args.hop / rate
    t0 = args.frame_length / (2.0 * rate) if args.method == "pyin-online" else 0.0
    track = [
        {"t": round(t0 + i * hop_s, 4), "f0_hz": round(float(f), 2) if v else None, "aperiodicity": round(float(a), 3)}
        for i, (f, a, v) in enumerate(zip(f0, ap, voiced))
    ]
    med = float(np.median(f0[voiced])) if voiced.size and voiced.any() else None
    print(json.dumps({
        "frames": len(track),
        # an empty track (a file shorter than lag frames) prints 0.0, not nan
        "voiced_fraction": round(float(voiced.mean()), 3) if voiced.size else 0.0,
        "median_f0_hz": round(med, 2) if med else None,
        "track": track,
    }))
    return 0


def _analysis_features(data: np.ndarray, rate: int, n_fft: int, hop: int, device, feature: str = "mfcc"):
    """13 MFCCs (or the 64-band log-mel) of a mono file ``[T, D]``, the
    JAX CLI's features for ``align`` and ``segments``."""
    from . import ops
    from .utils import as_tensor

    x = as_tensor(data, device)
    fb = ops.mel_filterbank(n_fft // 2 + 1, 64, rate)
    # the power of the power spectrogram, as the JAX CLI computes it
    lm = ops.log_mel(ops.power(ops.spectrogram(x, n_fft, hop)), fb)
    return ops.mfcc(lm, 13) if feature == "mfcc" else lm


def cmd_align(args) -> int:
    """DTW-align two audio files over MFCC (or log-mel) features: the
    alignment cost and a time-to-time warp map of about 100 anchors."""
    from . import ops

    feats = []
    for path in (args.a, args.b):
        data, rate = _read_mono(path)
        feats.append((_analysis_features(data, rate, args.n_fft, args.hop, args.device, args.feature), rate))
    (fa, rate_a), (fb, rate_b) = feats
    acc, path = ops.dtw(fa, fb, metric=args.metric)
    cost = float(acc[-1, -1])
    hop_a, hop_b = args.hop / rate_a, args.hop / rate_b
    stride = max(1, len(path) // 100)
    anchors = [{"t_a": round(float(i) * hop_a, 3), "t_b": round(float(j) * hop_b, 3)} for i, j in path[::stride]]
    print(json.dumps({
        "frames_a": int(fa.shape[0]),
        "frames_b": int(fb.shape[0]),
        "cost": round(cost, 3),
        "cost_per_step": round(cost / len(path), 5),
        "path_len": int(len(path)),
        "anchors": anchors,
    }))
    return 0


def cmd_segments(args) -> int:
    """Structural section boundaries of an audio file: MFCC self-similarity
    -> Foote novelty (summed-area checkerboard) -> peak-picked boundaries;
    prints the boundary times and the novelty's peak."""
    from . import ops

    data, rate = _read_mono(args.input)
    feats = _analysis_features(data, rate, args.n_fft, args.hop, args.device)
    mask, nov = ops.segment_boundaries(feats, kernel_width=args.kernel, delta=args.delta)
    mask, nov = mask.cpu().numpy(), nov.cpu().numpy()
    hop_s = args.hop / rate
    print(json.dumps({
        "frames": int(mask.shape[0]),
        "duration_s": round(data.shape[-1] / rate, 3),
        "boundaries_s": [round(float(i) * hop_s, 3) for i in np.where(mask)[0]],
        "novelty_peak": round(float(nov.max()), 5),
    }))
    return 0


def cmd_inspect(args) -> int:
    """Cost counts of one call of a graph (``Graph.inspect``)."""
    g = _build_graph(args.graph, args.input_rate, _user_config(args))
    shape = (args.batch, int(args.input_rate * args.seconds))
    report = g.inspect(shape, device=args.device)
    report.update({"graph": args.graph, "input_shape": list(shape)})
    print(json.dumps(report))
    return 0


def cmd_bench(args) -> int:
    """Throughput benchmarks: one JSON row per case (``all``: the JAX CLI's
    seven), under a torch.profiler trace with ``--profile-dir`` and as a
    markdown table with ``--report``. With ``--sharded`` the cases run over
    the world of ranks, and rank 0 prints."""
    from .bench import run_benchmark
    from .obs import profile_trace
    from .utils import resolve_device

    device = resolve_device(args.device)
    names = (
        ["roofline", "stft", "logmel", "master", "pvoc", "streaming", "session"]
        if args.benchmark == "all"
        else [args.benchmark]
    )
    results = []
    with _sharded_world(args, device) if args.sharded else contextlib.nullcontext():
        import torch.distributed as dist

        root = not args.sharded or dist.get_rank() == 0
        with profile_trace(args.profile_dir):
            for name in names:
                r = run_benchmark(name, batch=args.batch, seconds=args.seconds, sharded=args.sharded, device=device)
                results.append(r)
                if root:
                    print(json.dumps(r))
    if not root:
        return 0
    if args.profile_dir:
        _log.info("profiler trace written to %s", args.profile_dir)
    if args.report:
        lines = [
            "# Benchmarks",
            "",
            "| config | batch | clip s | ms/iter | x realtime/chip |",
            "|---|---|---|---|---|",
        ]
        for r in results:
            if "wall_seconds" not in r:  # calibration rows (roofline)
                continue
            lines.append(
                f"| {r['benchmark']} | {r['batch']} | {r['clip_seconds']} | "
                f"{r['wall_seconds'] / max(r['batches'], 1) * 1000:.2f} | "
                f"{r['realtime_factor_per_chip']:.0f} |"
            )
        with open(args.report, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def cmd_separate(args) -> int:
    """Blind NMF source separation: one WAV per component. STFT -> NMF of
    the magnitude -> soft masks -> ISTFT (``ops.nmf_separate``); the
    components sum back to the input."""
    from . import ops
    from .io import write_wav
    from .utils import as_tensor

    data, rate = _read_mono(args.input)
    comps, _, w = ops.nmf_separate(
        as_tensor(data, args.device), args.components, args.n_fft, args.hop, n_iter=args.iterations
    )
    comps, w = comps.cpu().numpy(), w.cpu().numpy()
    base, _ = os.path.splitext(args.output or args.input)
    outs = []
    for k in range(comps.shape[0]):
        path = f"{base}.comp{k}.wav"
        write_wav(path, comps[k].astype(np.float32), rate)
        outs.append(path)
    peak_bins = [int(np.argmax(w[k])) for k in range(comps.shape[0])]
    print(json.dumps({
        "components": outs,
        "template_peak_hz": [round(b * rate / args.n_fft, 1) for b in peak_bins],
        "residual_rel": round(float(
            np.linalg.norm(comps.sum(0) - data[: comps.shape[1]]) / max(np.linalg.norm(data), 1e-9)), 6),
    }))
    return 0


def cmd_loudness(args) -> int:
    """BS.1770-4 / EBU R128 loudness meter (and optional normalizer). Per
    file: integrated LUFS (gated), loudness range (LU), true peak (dBTP),
    max momentary and short-term. With --normalize-to, writes a
    gain-normalized copy next to each input (or into --out-dir)."""
    from . import ops
    from .io import write_wav
    from .utils import as_tensor

    results = []
    for p in _expand_inputs(args.inputs):
        data, rate = _read_mono(p)
        x = as_tensor(data, args.device)
        long = data.shape[-1] >= 3 * rate
        row = {
            "file": p,
            "sample_rate": rate,
            "seconds": round(data.shape[-1] / rate, 3),
            "integrated_lufs": round(float(ops.integrated_loudness(x, rate)), 2),
            "lra_lu": round(float(ops.loudness_range(x, rate)), 2) if long else None,
            "true_peak_dbtp": round(float(ops.true_peak(x, rate)), 2),
            "max_momentary_lufs": round(float(ops.momentary_loudness(x, rate).max()), 2),
        }
        if long:
            row["max_shortterm_lufs"] = round(float(ops.shortterm_loudness(x, rate).max()), 2)
        if args.normalize_to is not None:
            y = ops.normalize_loudness(x, rate, args.normalize_to, args.true_peak_max)
            stem, _ = os.path.splitext(os.path.basename(p))
            out = os.path.join(args.out_dir or os.path.dirname(p) or ".", f"{stem}.normalized.wav")
            write_wav(out, y.cpu().numpy(), rate)
            row["normalized"] = out
            row["normalized_lufs"] = round(float(ops.integrated_loudness(y, rate)), 2)
        results.append(row)
        print(json.dumps(row))
    return 0 if results else 1


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="audioflow", description=__doc__.split("\n")[0])
    p.add_argument("--log-level", default="info")
    p.add_argument(
        "--precision",
        choices=["highest", "high", "default"],
        help="accepted for the JAX CLI's sake: the port computes every "
        "product in full fp32 with TF32 off, whatever the name",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("devices", help="list compute devices")
    d.add_argument("--json", action="store_true")
    d.set_defaults(fn=cmd_devices)

    i = sub.add_parser("info", help="framework/platform info")
    i.set_defaults(fn=cmd_info)

    c = sub.add_parser("config", help="show/set/persist config")
    c.add_argument("action", choices=["show", "set", "path"])
    c.add_argument("key", nargs="?")
    c.add_argument("value", nargs="?")
    c.add_argument("--file")
    c.set_defaults(fn=cmd_config)

    r = sub.add_parser("run", help="run a graph over audio files")
    r.add_argument("--input", "-i", nargs="+", required=True)
    r.add_argument("--output", "-o")
    r.add_argument("--graph", "-g", default="logmel", choices=_GRAPHS)
    r.add_argument("--spec", help="JSON GraphSpec file (overrides --graph)")
    r.add_argument("--input-rate", type=int)
    r.add_argument("--batch-size", type=int, default=0, help="pipeline files in batches of this size")
    r.add_argument("--sharded", action="store_true",
                   help="shard the batch over the world's ranks (one rank unless started by torch.distributed.run)")
    r.add_argument("--dist-backend", choices=("nccl", "gloo"),
                   help="--sharded's process-group backend (default: nccl on the card, gloo on the CPU; gloo for "
                        "ranks that share one card)")
    r.add_argument("--multirate", action="store_true",
                   help="cqtroundtrip only: the broadband-invertible per-octave-hop CQT variant (ops.cqt_multirate)")
    r.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    r.add_argument("--config")
    r.add_argument("--stats")
    r.set_defaults(fn=cmd_run)

    s = sub.add_parser("stream", help="streaming session over one audio file")
    s.add_argument("--input", "-i", required=True)
    s.add_argument("--output", "-o")
    s.add_argument("--graph", "-g", default="logmel", choices=_GRAPHS)
    s.add_argument("--chunk", type=int)
    s.add_argument("--push-size", type=int)
    s.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    s.add_argument("--config")
    s.set_defaults(fn=cmd_stream)

    k = sub.add_parser("key", help="API-key storage (env or secrets file)")
    k.add_argument("action", choices=["set", "get", "delete"])
    k.add_argument("account", nargs="?", default="elevenlabs")
    k.add_argument("value", nargs="?")
    k.add_argument("--file", help="use a secrets file instead of env vars")
    k.set_defaults(fn=cmd_key)

    e = sub.add_parser("egress", help="stream an audio file to a WebSocket ASR endpoint")
    e.add_argument("--input", "-i", required=True)
    e.add_argument("--url", required=True)
    e.add_argument("--api-key")
    e.add_argument("--chunk", type=int, default=0, help="samples per wire chunk")
    e.add_argument("--vad-gate", action="store_true", help="mute non-speech before sending")
    e.add_argument("--receive-timeout", type=float, default=5.0)
    e.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    e.add_argument("--config")
    e.set_defaults(fn=cmd_egress)

    v = sub.add_parser("vad", help="voice-activity segments of an audio file")
    v.add_argument("--input", "-i", required=True)
    v.add_argument("--threshold-db", type=float, default=None)
    v.add_argument(
        "--level",
        choices=["aggressive", "balanced", "relaxed"],
        default=None,
        help="named sensitivity preset (overrides --threshold-db; default: config audio.vad_level)",
    )
    v.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    v.add_argument("--config")
    v.set_defaults(fn=cmd_vad)

    val = sub.add_parser("validate", help="numerics validation report")
    val.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    val.set_defaults(fn=cmd_validate)

    pt = sub.add_parser("pitch", help="YIN/pYIN f0 track of an audio file")
    pt.add_argument("-i", "--input", required=True)
    pt.add_argument(
        "--method", choices=("yin", "pyin", "pyin-online"), default="yin",
        help="yin: CMND + aperiodicity threshold; pyin: probabilistic candidates + HMM Viterbi voicing/pitch "
        "decode; pyin-online: the fixed-lag streaming tracker",
    )
    pt.add_argument("--fmin", type=float, default=65.0)
    pt.add_argument("--fmax", type=float, default=2093.0)
    pt.add_argument("--frame-length", type=int, default=2048)
    pt.add_argument("--hop", type=int, default=256)
    pt.add_argument("--voiced-threshold", type=float, default=0.3,
                    help="aperiodicity (CMND depth) below this counts as voiced")
    pt.add_argument("--lag", type=int, default=25,
                    help="pyin-online only: fixed-lag decode delay in frames, the streaming tracker's "
                    "latency/accuracy knob")
    pt.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    pt.set_defaults(fn=cmd_pitch)

    al = sub.add_parser("align", help="DTW-align two audio files (MFCC/log-mel)")
    al.add_argument("-a", required=True, help="first audio file")
    al.add_argument("-b", required=True, help="second audio file")
    al.add_argument("--feature", choices=("mfcc", "logmel"), default="mfcc")
    al.add_argument("--metric", choices=("euclidean", "cosine"), default="cosine")
    al.add_argument("--n-fft", type=int, default=1024)
    al.add_argument("--hop", type=int, default=256)
    al.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    al.set_defaults(fn=cmd_align)

    sg = sub.add_parser("segments", help="structural section boundaries (Foote novelty)")
    sg.add_argument("-i", "--input", required=True)
    sg.add_argument("--n-fft", type=int, default=2048)
    sg.add_argument("--hop", type=int, default=512)
    sg.add_argument("--kernel", type=int, default=32, help="checkerboard width (frames)")
    sg.add_argument("--delta", type=float, default=0.05, help="novelty peak threshold")
    sg.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    sg.set_defaults(fn=cmd_segments)

    sp = sub.add_parser("separate", help="blind NMF source separation -> per-component wavs")
    sp.add_argument("-i", "--input", required=True)
    sp.add_argument("-o", "--output", default=None, help="output basename (default: input)")
    sp.add_argument("-k", "--components", type=int, default=2)
    sp.add_argument("--n-fft", type=int, default=1024)
    sp.add_argument("--hop", type=int, default=256)
    sp.add_argument("--iterations", type=int, default=200)
    sp.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    sp.set_defaults(fn=cmd_separate)

    lo = sub.add_parser("loudness", help="BS.1770/R128 loudness meter (+ optional normalize)")
    lo.add_argument("inputs", nargs="+", help="audio files or globs")
    lo.add_argument("--normalize-to", type=float, default=None, metavar="LUFS",
                    help="write a gain-normalized copy at this integrated loudness")
    lo.add_argument("--true-peak-max", type=float, default=-1.0, metavar="DBTP",
                    help="ceiling for --normalize-to (default -1 dBTP; R128)")
    lo.add_argument("--out-dir", default=None, help="directory for normalized copies")
    lo.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    lo.set_defaults(fn=cmd_loudness)

    ins = sub.add_parser("inspect", help="cost counts of one call of a graph (flops/launches)")
    ins.add_argument("--graph", "-g", default="logmel", choices=_GRAPHS)
    ins.add_argument("--input-rate", type=int, default=44100)
    ins.add_argument("--seconds", type=float, default=10.0)
    ins.add_argument("--batch", type=int, default=1)
    ins.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    ins.add_argument("--config")
    ins.set_defaults(fn=cmd_inspect)

    b = sub.add_parser("bench", help="throughput benchmarks ('all' runs the JAX CLI's seven)")
    b.add_argument("benchmark", nargs="?", default="logmel")
    b.add_argument("--batch", type=int, default=0)
    b.add_argument("--seconds", type=float, default=10.0)
    b.add_argument("--sharded", action="store_true",
                   help="shard the batch over the world's ranks (one rank unless started by torch.distributed.run)")
    b.add_argument("--dist-backend", choices=("nccl", "gloo"),
                   help="--sharded's process-group backend (default: nccl on the card, gloo on the CPU)")
    b.add_argument("--report", help="write a markdown table to this path")
    b.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace here (TensorBoard, Perfetto)")
    b.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    setup_logging(args.log_level)
    try:
        return args.fn(args)
    except AudioFlowError as e:
        _log.error("%s (%s, %s)", e.message, e.code.value, e.strategy.value)
        return 2


if __name__ == "__main__":
    sys.exit(main())
