"""Host time inside StreamSession.push and poll_all for the pushes that complete a chunk, before the host copy, a chunk, over the untraced pushes, in ms."""

from flowbench.readers import mean_ms


def read(r):
    return mean_ms(r, "session_host_s")
