"""The device's idle share of the traced stretch: 1 - kernel, copy and set time (their union) over its wall, in %."""

from flowbench.readers import idle_pct


def read(r):
    return idle_pct(r)
