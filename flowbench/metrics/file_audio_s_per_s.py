"""Audio seconds per second over the whole window of a run over a corpus of files, decode included (host clock)."""

from flowbench.readers import rate


def read(r):
    return rate(r)
