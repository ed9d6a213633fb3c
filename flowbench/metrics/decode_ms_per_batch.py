"""The mean of the loader's DecodedBatch.decode_seconds over the window's untraced batches, in ms."""

from flowbench.readers import mean_ms


def read(r):
    return mean_ms(r, "decode_s")
