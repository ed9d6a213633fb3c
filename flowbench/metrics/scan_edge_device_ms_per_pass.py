"""The graph's own device time a scan_stream pass, outside its nodes' steps: graph.scan_stream's CUDA-event intervals less graph.stream_step's (init_state's fills, the output concat, idle at the edges) plus graph.align's (the steps' warmup zeroing and delay alignment), over the passes, in ms."""

from flowbench.program_spans import edge_device_ms_per_pass


def read(r):
    return edge_device_ms_per_pass(r)
