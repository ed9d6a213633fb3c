"""The melspec kernel's share of its roofline: the least time of its call over its mean device time per recorded launch, in %."""

from flowbench.readers import melspec_roofline_pct


def read(r):
    return melspec_roofline_pct(r)
