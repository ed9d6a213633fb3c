"""The graph's own host time a pass: the host self time of graph.scan_stream, graph.init_state and graph.stream_step (node spans and the concat left out) over the passes, in ms."""

from flowbench.program_spans import graph_host_self_ms_per_pass


def read(r):
    return graph_host_self_ms_per_pass(r)
