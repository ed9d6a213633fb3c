"""Small traffic for each cell, for runs on the CPU in the tests, and the
benchmark with the cells that ``BENCHMARK.json`` leaves out (the two live
cells and the file corpus: their host-bound metrics spread too widely on the
card's shared host to hold a bound; PERF.md), so that their drivers,
configuration and readers stay tested and ready."""

import copy

from flowbench.bench import ROOT, Bench

SMALL = {
    "logmel-stream-2048": {"clips": 3, "clip_seconds": 1.0, "compare_clips": 2},
    "dictation-live-64": {"streams": 3, "warm_seconds": 0.1},
    "logmel-files-32": {"files": 6, "clip_seconds": 1.0, "batch": 2, "sample_batches": 2, "laps_cap": 30},
    "logmel-live-64": {"streams": 3, "warm_seconds": 0.1},
}
SECONDS = 0.6

LIVE = ["dictation-live-64", "logmel-live-64"]
READY = {
    "configs": [
        {"name": "dictation48k", "source": "https://github.com/forfd8960/audio-flow-rs",
         "file": "flowbench/configs/dictation48k.json", "reduced": [], "why": "the dictation fork"},
    ],
    "workloads": [
        {"name": "dictation-live-64", "config": "dictation48k", "traffic": "live-64x20ms", "chips": 1,
         "why": "64 live streams at 48 kHz"},
        {"name": "logmel-live-64", "config": "logmel16k", "traffic": "live-64x20ms", "chips": 1,
         "why": "64 live streams at 44.1 kHz"},
        {"name": "logmel-files-32", "config": "logmel16k", "traffic": "files-256x10s-b32", "chips": 1,
         "why": "256 WAV files of 10 s at 44.1 kHz, run_batches in batches of 32"},
    ],
    "end_to_end": [
        {"name": "chunk_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
         "workloads": LIVE},
        {"name": "file_audio_s_per_s", "unit": "audio-s/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["logmel-files-32"]},
    ],
    "per_layer": [
        {"name": "device_busy_ms_per_chunk.live", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "chunk_ms_p95", "workloads": LIVE},
        {"name": "step_ops.live", "unit": "ops", "better": "lower", "source": "program_counter",
         "layer": "graph", "moves": "chunk_ms_p95", "workloads": LIVE},
        {"name": "session_host_ms_per_chunk", "unit": "ms", "better": "lower", "source": "host_clock",
         "layer": "session", "moves": "chunk_ms_p95", "workloads": LIVE},
        {"name": "device_idle_pct.file", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "file_audio_s_per_s", "workloads": ["logmel-files-32"]},
        {"name": "decode_ms_per_batch", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "ingest", "moves": "file_audio_s_per_s", "workloads": ["logmel-files-32"]},
    ],
}


def bench() -> Bench:
    """The benchmark, with the cells it leaves out added."""
    spec = copy.deepcopy(Bench().spec)
    for key, entries in READY.items():
        spec[key] += copy.deepcopy(entries)
    return Bench(ROOT, spec)


def small_traffic(b: Bench, workload: str) -> dict:
    t = b.traffic(b.workload(workload)["traffic"])
    t.update(SMALL[workload])
    t["trace_seconds"] = 0.3
    return t
