"""The log-mel node's device time a chunk (the melspec kernel and the framing carry): the CUDA-event intervals of the program's node.LogMelSpec spans over their count, in ms."""

from flowbench.program_spans import device_ms_per_span


def read(r):
    return device_ms_per_span(r, "node.LogMelSpec")
