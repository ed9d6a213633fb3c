"""Benchmark harness: the JAX bench's cases on the card, measured in
audio-seconds per second per card (the north-star metric).

Mirrors ``audioflow_tpu/bench.py``: the same case names and aliases,
default batches, rates, chunking, iteration counts and row keys
(``RunMetrics.to_dict()`` plus ``benchmark``, ``batch``, ``clip_seconds``).
A case runs on ``device`` ("cuda" unless the caller names the CPU). Each
case's function is the port's entry point, so on the card ``logmel``,
``logmel_stream`` and ``session`` launch the melspec kernel and ``pvoc``
and ``pitch`` the timestretch kernel; ``streaming`` is the JAX bench's
explicit node composition, plain torch.

Where the JAX package differs: the cost columns count what
``torch.utils.flop_counter.FlopCounterMode`` sees in one call (matmuls and
convolutions; not a hand-written kernel's work), with ``bytes_accessed``
-1.0, so ``achieved_gbps`` appears only with a byte count; ``--sharded``
runs one process a rank over ``torch.distributed`` (the caller makes the
process group), each rank timing its own rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .models import log_mel_frontend, master_chain_graph, stft_magnitude_graph
from .obs import measure_throughput
from .ops import time_stretch
from .profiling import count_flops, tone_batch as _tone_batch
from .utils import resolve_device

# the roofline row's sizes: three 32 Mi-element fp32 streams, an 8192^3 product
ROOFLINE_ELEMENTS = 32 * 1024 * 1024
ROOFLINE_K = 8192

# the cases that --sharded shards, as in the JAX bench; the others run whole
_SHARDABLE = ("stft", "config1", "logmel", "config2", "master", "eq", "config3", "streaming", "config5")


def _cost_analysis(fn, x) -> dict:
    """Operation counts of ONE call of a case's function: ``flops`` as
    ``FlopCounterMode`` counts them (matmuls and convolutions; elementwise
    work, FFTs and the hand-written kernels' work are not seen), and
    ``bytes_accessed`` -1.0, the JAX package's value where a backend has no
    analysis."""
    return {"flops": count_flops(lambda: fn(x)), "bytes_accessed": -1.0}


def _measure(graph_fn, x, audio_seconds, iters=10, sharded=False, device=None):
    """Time ``iters`` calls of a case's function on the numpy batch ``x``:
    a Graph through ``compile()`` (which streams long signals in chunks, as
    the JAX package's does), or ``compile_sharded`` on the rank's rows over
    the world's mesh; a callable as it is. Returns the metrics and, unsharded,
    ``(fn, x)`` for the cost count."""
    dev = resolve_device(device)
    if sharded:
        from .parallel import compile_sharded, make_mesh, shard_batch

        mesh = make_mesh(devices=dev.type)
        x = shard_batch(x, mesh)
        fn = compile_sharded(graph_fn, mesh) if hasattr(graph_fn, "compile") else graph_fn
        n_dev = mesh.size()
    else:
        fn = graph_fn.compile() if hasattr(graph_fn, "compile") else graph_fn
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        n_dev = 1
    # the JAX package times one jitted scan whose carry perturbs each
    # iteration's input; here the same input goes through iters calls between
    # two CUDA events, which holds because no case caches its output
    m = measure_throughput(fn, x, audio_seconds, iters=iters)
    m.n_devices = n_dev
    return m, None if sharded else (fn, x)


def _chunk(g) -> int:
    """The bench's streaming chunk: the graph's granularity times as many as fit in 16,384."""
    gran = g.chunk_granularity()
    return gran * max(1, 16384 // gran)


def _case(name: str, batch: int = 0, seconds: float = 10.0):
    """``(fn, x, audio_seconds)`` of a case: ``fn`` a Graph (timed through
    ``compile()``; for ``session``, streamed through a ``StreamSession``) or
    a function of the batch, ``x`` the seeded numpy batch it takes, whose
    rows are the case's batch."""
    if name in ("stft", "config1"):
        batch = batch or 64
        rate = 16000
        return stft_magnitude_graph(rate, 1024, 256), _tone_batch(batch, seconds, rate), batch * seconds
    if name in ("logmel", "config2"):
        batch = batch or 256
        rate = 44100
        return log_mel_frontend(rate, 16000, 1024, 256, 128), _tone_batch(batch, seconds, rate), batch * seconds
    if name == "logmel_stream":
        # the headline: the same decode -> resample -> log-mel computation in
        # the framework's chunked streaming mode
        batch = batch or 512
        rate = 44100
        g = log_mel_frontend(rate, 16000, 1024, 256, 128, center=False)
        chunk = _chunk(g)
        x = _tone_batch(batch, seconds, rate)
        t = x.shape[-1] // chunk * chunk
        return (lambda b: g.scan_stream(b, chunk)), x[:, :t], batch * t / rate
    if name in ("master", "eq", "config3"):
        batch = batch or 64
        rate = 16000
        return master_chain_graph(rate), _tone_batch(batch, seconds, rate), batch * seconds
    if name in ("pvoc", "config4"):
        batch = batch or 64
        return (lambda z: time_stretch(z, 1.25, 1024, 256)), _tone_batch(batch, seconds, 16000), batch * seconds
    if name == "pitch":
        # the other half of config 4: +12 semitones is a stretch at rate
        # exactly 1/2, a rate the timestretch kernel takes, then the resampler
        from .ops import pitch_shift

        batch = batch or 64
        rate = 16000
        return (lambda z: pitch_shift(z, 12.0, rate, 1024, 256)), _tone_batch(batch, seconds, rate), batch * seconds
    if name in ("streaming", "config5"):
        from .graph import BiquadChain, MelProject, Resample, Spectrogram
        from .graph import chain as _chain
        from .models import eq_bands_default

        batch = batch or 256
        rate = 44100
        x = _tone_batch(batch, seconds, rate)
        g = _chain(
            Resample(rate, 16000, "kaiser"),
            BiquadChain(eq_bands_default(16000.0)),
            Spectrogram(1024, 256, center=False),
            MelProject(n_mels=128),
            input_rate=rate,
        )
        chunk = _chunk(g)
        t = x.shape[-1] // chunk * chunk
        return (lambda b: g.scan_stream(b, chunk)), x[:, :t], batch * t / rate
    if name in ("session", "session_drain"):
        batch = batch or 64
        rate = 44100
        return log_mel_frontend(rate, 16000, 1024, 256, 128), _tone_batch(batch, seconds, rate), batch * seconds
    raise ValueError(f"unknown benchmark {name!r}")


def _roofline(dev: torch.device) -> dict:
    """The calibration row: the device memory rate of an elementwise triad
    (three fp32 streams) and the tensor cores' bf16 product rate, under the
    JAX row's keys (``mxu_tflops_bf16`` names the card's bf16 rate)."""
    nels = ROOFLINE_ELEMENTS
    cvec = torch.full((nels,), 0.5, dtype=torch.float32, device=dev)
    # c + 1.0001·u as one kernel (torch.add's alpha), two streams read and
    # one written, as XLA fuses the JAX row's u * 1.0001 + c; eager torch
    # would run that as two kernels over five streams
    mt = measure_throughput(lambda u: torch.add(cvec, u, alpha=1.0001), torch.ones(nels, device=dev), 1.0, iters=10)
    gbps = 3 * nels * 4 * 10 / mt.wall_seconds / 1e9
    k = ROOFLINE_K
    w = torch.full((k, k), 0.001, dtype=torch.bfloat16, device=dev)

    def mm_fn(a):
        # bf16 operands, fp32 accumulation; ops/_mm.py's TF32 switch governs
        # fp32 products only. cuBLAS rounds the product to bf16 on output,
        # where the JAX row keeps it in fp32: the same multiply-adds
        return torch.mm(a.to(torch.bfloat16), w).float() * 1e-3

    mmt = measure_throughput(mm_fn, torch.full((k, k), 0.001, device=dev), 1.0, iters=10)
    tflops = 2 * k**3 * 10 / mmt.wall_seconds / 1e12
    return {
        "benchmark": "roofline",
        "hbm_gbps": round(gbps, 1),
        "mxu_tflops_bf16": round(tflops, 1),
        "triad_ms": round(mt.wall_seconds * 100, 3),
        "matmul_ms": round(mmt.wall_seconds * 100, 3),
        "compile_seconds": round(mt.compile_seconds + mmt.compile_seconds, 1),
    }


def _session(name: str, batch: int, seconds: float, dev: torch.device):
    """The live push path: a StreamSession over the log-mel graph, pushed a
    chunk at a time (``session``) or in 8-chunk blocks that the session
    drains as one (``session_drain``). Timed on the host clock, as in the
    JAX bench; each timed stretch ends in a host copy of a result, which
    waits for the card's work behind it."""
    from .obs import RunMetrics
    from .session import StreamSession

    g, x, _ = _case(name, batch, seconds)
    batch, rate = x.shape[0], g.input_rate
    chunk = _chunk(g)
    block = 8 * chunk if name == "session_drain" else chunk
    cap = 17 * chunk if name == "session_drain" else None
    n = x.shape[-1] // block * block
    sess = StreamSession(g, chunk_in=chunk, lead_shape=(batch,), ring_capacity=cap, device=dev).open(
        precompile="all"
    )
    sess.push(x[:, :block])  # warm the staging path at this shape
    sess.poll_all()
    t0 = time.perf_counter()
    for i in range(block, n, block):
        sess.push(x[:, i : i + block])
    sess.poll_all()[-1].data.sum()  # the host copy of the last chunk: the sync
    wall = time.perf_counter() - t0
    audio = batch * (n - block) / rate
    # latency: each block's wall with the host copy of its result, what a
    # live caller waiting on each chunk sees
    lat = []
    for _ in range(3):
        for i in range(0, n, block):
            tb = time.perf_counter()
            sess.push(x[:, i : i + block])
            sess.poll_all()[-1].data.sum()
            lat.append(time.perf_counter() - tb)
    sess.close()
    per_chunk = np.sort(np.asarray(lat)) / max(block // chunk, 1) * 1000.0
    p50 = float(np.percentile(per_chunk, 50))
    p99 = float(np.percentile(per_chunk, 99))
    m = RunMetrics(
        audio_seconds=audio, wall_seconds=wall, batches=(n - block) // chunk,
        extra={
            "latency_ms_p50": round(p50, 2),
            "latency_ms_p99": round(p99, 2),
            "latency_x_realtime_p50": round(batch * chunk / rate / (p50 / 1000.0), 1),
        },
    )
    return m, batch


def run_benchmark(
    name: str = "logmel", batch: int = 0, seconds: float = 10.0,
    sharded: bool = False, cost: bool = True, device=None,
) -> dict:
    """Run one named benchmark on ``device``; returns a JSON-ready dict.

    With ``cost=True`` (default) a row whose call the flop counter sees
    also carries ``flops``, ``bytes_accessed`` and ``achieved_tflops``;
    divide by the ``roofline`` calibration row to audit utilization.
    ``sharded`` shards the batch over the world's ranks (the process group
    must exist: ``parallel.multihost_init``)."""
    dev = resolve_device(device)
    if name == "roofline":
        return _roofline(dev)
    cost_args = None
    if name in ("session", "session_drain"):
        m, batch = _session(name, batch, seconds, dev)
    else:
        fn, x, audio = _case(name, batch, seconds)
        batch = x.shape[0]
        m, cost_args = _measure(fn, x, audio, sharded=sharded and name in _SHARDABLE, device=dev)
    out = m.to_dict()
    out.update({"benchmark": name, "batch": batch, "clip_seconds": seconds})
    if cost and cost_args is not None:
        ca = _cost_analysis(*cost_args)
        if ca["flops"] > 0:
            per_iter = out["wall_seconds"] / max(out["batches"], 1)
            out.update(ca)
            out["achieved_tflops"] = round(ca["flops"] / per_iter / 1e12, 3)
            if ca["bytes_accessed"] > 0:
                out["achieved_gbps"] = round(ca["bytes_accessed"] / per_iter / 1e9, 1)
    return out
