"""Device busy time of the traced stretch over the chunks it completed, in ms."""

from flowbench.readers import busy_ms_per_unit


def read(r):
    return busy_ms_per_unit(r)
