"""Aten ops in one steady stream step of the cell's graph, counted exactly by a dispatch mode."""

from flowbench.readers import step_ops


def read(r):
    return step_ops(r)
