"""Audio seconds processed per second over the whole window, for audio that sits on the card (CUDA events around the window)."""

from flowbench.readers import rate


def read(r):
    return rate(r)
