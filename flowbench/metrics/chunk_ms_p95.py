"""The 95th percentile of all chunks' latencies, from the moment the push that completed a chunk was due to the moment its results were in host memory, in ms."""

from flowbench.readers import p95_ms


def read(r):
    return p95_ms(r, "chunk_latency_s")
