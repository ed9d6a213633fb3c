"""Ring buffers for the streaming session, as functional tensor code.

Mirrors ``audioflow_tpu/ops/ring.py``. :class:`Ring` is the parity
component of the reference's capture ring: a ``[..., capacity]`` buffer
with read and write cursors, one slot reserved (usable capacity
``capacity - 1``), writes partial on overflow and returning the count
written, reads returning up to ``size`` values zero-padded and the count
read. Leading axes ride along with shared cursors. :class:`Staging` is the
linear accumulator the session uses: the buffer and a fill count, appended
to and read from the front, never wrapped, because the session drains every
full chunk as it arrives.

Every function returns new tensors and leaves its arguments as they were,
as the JAX package's do, so a state can be kept, copied or snapshot at any
point. The cursors and counts are host ints: the session tracks them on the
host anyway, and a device scalar would make every read wait on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Ring(NamedTuple):
    buf: torch.Tensor  # [..., capacity]
    read_pos: int
    write_pos: int


def ring_init(
    capacity: int, lead_shape: tuple = (), dtype: torch.dtype = torch.float32, device=None
) -> Ring:
    if capacity < 2:
        raise ValueError("capacity must be >= 2 (one slot is reserved)")
    return Ring(torch.zeros((*lead_shape, capacity), dtype=dtype, device=device), 0, 0)


def ring_available(ring: Ring) -> int:
    """Samples available to read."""
    return (ring.write_pos - ring.read_pos) % ring.buf.shape[-1]


def ring_free(ring: Ring) -> int:
    """Writable space: ``capacity - 1 - available``."""
    return ring.buf.shape[-1] - 1 - ring_available(ring)


def ring_write(ring: Ring, data: torch.Tensor, n: int | None = None) -> tuple[Ring, int]:
    """Write up to ``n`` (default ``data.shape[-1]``) samples of ``data``,
    partially on overflow. Returns the ring and the count written.

    The data, zero-padded or cut to the capacity, is rotated so that element
    ``j`` of the buffer pairs with ``data[(j - write_pos) mod cap]``, then
    the written window is selected: it never overlaps itself, because at
    most ``capacity - 1`` samples are written."""
    cap = ring.buf.shape[-1]
    if n is None:
        n = data.shape[-1]
    n_write = min(n, ring_free(ring))
    data = data.to(ring.buf.dtype)
    width = data.shape[-1]
    data = torch.nn.functional.pad(data, (0, cap - width)) if width < cap else data[..., :cap]
    src = torch.roll(data, ring.write_pos, dims=-1)
    rel = torch.arange(cap, device=ring.buf.device) - ring.write_pos
    take = torch.where(rel >= 0, rel < n_write, rel + cap < n_write)
    buf = torch.where(take, src, ring.buf)
    return Ring(buf, ring.read_pos, (ring.write_pos + n_write) % cap), n_write


def ring_read(ring: Ring, size: int) -> tuple[Ring, torch.Tensor, int]:
    """Read up to ``size``: the ring, the values ``[..., size]`` zero-padded,
    and the count read (0 when empty)."""
    cap = ring.buf.shape[-1]
    n_read = min(size, ring_available(ring))
    rot = torch.roll(ring.buf, -ring.read_pos, dims=-1)
    head = rot[..., :size] if size <= cap else torch.nn.functional.pad(rot, (0, size - cap))
    vals = torch.where(torch.arange(size, device=head.device) < n_read, head, 0)
    return Ring(ring.buf, (ring.read_pos + n_read) % cap, ring.write_pos), vals, n_read


def ring_clear(ring: Ring) -> Ring:
    return Ring(ring.buf, 0, 0)


class Staging(NamedTuple):
    """A linear accumulator: ``buf [..., size]`` and the count of valid
    samples at its front."""

    buf: torch.Tensor  # [..., size]
    count: int


def staging_init(
    size: int, lead_shape: tuple = (), dtype: torch.dtype = torch.float32, device=None
) -> Staging:
    return Staging(torch.zeros((*lead_shape, size), dtype=dtype, device=device), 0)


def staging_push(st: Staging, data: torch.Tensor, n: int | None = None) -> Staging:
    """Append ``n`` (default the full width) samples of ``data``.

    The caller keeps ``count + width <= size`` (the session's headroom
    split). Samples of ``data`` past ``n`` land in the buffer and are
    masked by the count on reads."""
    if n is None:
        n = data.shape[-1]
    start = st.count
    buf = torch.slice_scatter(
        st.buf, data.to(st.buf.dtype), dim=-1, start=start, end=start + data.shape[-1]
    )
    return Staging(buf, st.count + n)


def staging_take(st: Staging, size: int) -> tuple[Staging, torch.Tensor, int]:
    """Read up to ``size`` samples from the front, zero-padded past the
    count (the flush semantics), and shift the rest down.

    Returns the staging, the values ``[..., size]`` and the count read. The
    values may be a view of the old buffer, which no function here writes."""
    n_read = min(size, st.count)
    vals = st.buf[..., :size]
    if n_read < size:
        vals = torch.nn.functional.pad(vals[..., :n_read], (0, size - n_read))
    shifted = torch.nn.functional.pad(st.buf[..., size:], (0, min(size, st.buf.shape[-1])))
    return Staging(shifted, max(st.count - n_read, 0)), vals, n_read
