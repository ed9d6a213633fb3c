"""Seconds of the graph's first shape pass (Graph.init_state's step over meta tensors), from the program's one-time table, in s."""

from flowbench.program_spans import first_use_s


def read(r):
    return first_use_s(r, "graph.shape_pass")
