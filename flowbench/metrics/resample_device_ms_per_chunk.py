"""The resampler's device time a chunk (the banded matmul and its carry, the graph's alignment left out): the CUDA-event intervals of the program's node.Resample spans over their count, in ms."""

from flowbench.program_spans import device_ms_per_span


def read(r):
    return device_ms_per_span(r, "node.Resample")
