"""The flow-graph: a chain of nodes run eagerly on tensors.

Mirrors ``audioflow_tpu/graph/graph.py::Graph``. Two execution modes:

* ``compile()`` — offline: ``fn(batch [..., T]) -> features``; long inputs
  run through the streaming machinery (``_chunked_chain``), which equals the
  whole-array chain up to f32 rounding;
* ``init_state`` / ``stream_step`` — streaming: fixed-shape steps with an
  explicit ``(carries, pendings, k)`` state; ``scan_stream`` runs a whole
  signal as a Python loop over chunks (the JAX package's ``lax.scan``).

The chunk counter ``k`` is a plain int, so the state converts both ways with
the JAX package's checkpoint pytree (:mod:`audioflow_torch.convert`).
Streamed output equals offline output shifted by ``stream_latency``: the
delay alignment (``_delays``) and warmup zeroing (``_warmups``) are ported
line for line.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable

import torch

from ..errors import AudioError, ConfigError, ErrorCode
from ..ops.stft import pad_center
from ..utils import as_tensor
from .nodes import Node, Spectrogram


def _domains_compatible(out_d: str, in_d: str) -> bool:
    return out_d == in_d or "any" in (out_d, in_d)


def _granularity(nodes) -> int:
    """Smallest input chunk that every node of ``nodes`` takes in whole multiples."""
    gran = 1
    ratio = Fraction(1)
    for node in nodes:
        m = node.chunk_multiple()
        # need (chunk_in * ratio) % m == 0  ->  chunk_in multiple of:
        need = (m * ratio.denominator) // math.gcd(ratio.numerator, m * ratio.denominator)
        gran = math.lcm(gran, need)
        ratio *= Fraction(node.out_len(m), m)
    return gran


@dataclass(frozen=True)
class Graph:
    """An immutable chain of nodes with rate/domain metadata resolved."""

    nodes: tuple[Node, ...]
    input_rate: int | None = None
    name: str = "graph"
    output_rate: int | None = field(init=False, default=None)

    def __post_init__(self):
        if not self.nodes:
            raise ConfigError("graph needs at least one node")
        bound = []
        rate = self.input_rate
        domain = "samples"
        for i, node in enumerate(self.nodes):
            if not _domains_compatible(domain, node.domain_in):
                raise ConfigError(
                    f"node {i} ({type(node).__name__}) expects domain "
                    f"{node.domain_in!r} but receives {domain!r}"
                )
            node = node.bind(rate)
            bound.append(node)
            rate = node.rate_out(rate)
            if node.domain_out != "any":
                domain = node.domain_out
        object.__setattr__(self, "nodes", tuple(bound))
        object.__setattr__(self, "output_rate", rate)

    # ------------------------------------------------------------------ chain
    def chain(self, x: torch.Tensor) -> torch.Tensor:
        """Apply all nodes, whole-array."""
        for node in self.nodes:
            x = node.apply(x)
        return x

    def __call__(self, x):
        return self.chain(x)

    # auto-chunk threshold in input samples, as in the JAX package
    _CHUNKED_MIN_T = 65536

    def compile(self, chunked: bool | str = "auto") -> Callable:
        """The offline function ``fn(x, device=None) -> output``.

        ``x [..., T]`` is a tensor, or a numpy array that goes to ``device``
        ("cuda" unless given; see :func:`audioflow_torch.utils.as_tensor`).
        ``chunked`` — long-signal execution strategy: the same chain run as a
        loop over fixed chunks through the streaming machinery, trimmed to
        the offline output. ``"auto"`` (default) picks the chunked form when
        the graph is streamable and the input is long; ``True``/``False``
        force it.
        """
        chunkable = chunked is not False and (self.streamable or self._decentered() is not None)
        if chunked is True and not chunkable:
            self._check_streamable()

        def run(x, device=None):
            x = as_tensor(x, device)
            use = chunkable and (chunked is True or x.shape[-1] >= self._CHUNKED_MIN_T)
            return self._chunked_chain(x) if use else self.chain(x)

        return run

    def _decentered(self):
        """``(pad, graph)`` when the only barrier to the chunked form is a
        center=True leading Spectrogram; None otherwise. center=True framing
        of ``x`` is center=False framing of ``pad(x, n_fft//2, 'reflect')``,
        so the pad happens once and the rest of the chain streams."""
        n0 = self.nodes[0]
        if not isinstance(n0, Spectrogram) or not n0.center:
            return None
        if not all(n.streamable for n in self.nodes[1:]):
            return None
        g = dataclasses.replace(
            self,
            nodes=(dataclasses.replace(n0, center=False),) + tuple(self.nodes[1:]),
        )
        return n0.n_fft // 2, g

    @property
    def _out_domain(self) -> str:
        domain = "samples"
        for n in self.nodes:
            if n.domain_out != "any":
                domain = n.domain_out
        return domain

    def _chunked_chain(self, x: torch.Tensor) -> torch.Tensor:
        """Offline semantics via the streaming machinery (see compile)."""
        if not self.streamable:
            pad, g = self._decentered()  # compile() guarantees it exists
            return g._chunked_chain(pad_center(x, 2 * pad))
        t = x.shape[-1]
        # output shape of the whole-array chain, from a pass over meta tensors
        out_shape = self.chain(torch.empty(x.shape, dtype=x.dtype, device="meta")).shape
        axis = (-2 if self._out_domain == "frames" else -1) % len(out_shape)
        n_out = out_shape[axis]
        gran = self.chunk_granularity()
        chunk = gran * max(1, 16384 // gran)
        lat = self.stream_latency(chunk)
        m = self.chunk_lens(chunk)[-1]
        # enough zero-padded chunks that the trimmed window [lat, lat+n_out)
        # is fully produced
        n_chunks = -(-t // chunk)
        while n_chunks * m < lat + n_out:
            n_chunks += 1
        pad = n_chunks * chunk - t
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        streamed = self.scan_stream(x, chunk)
        return streamed.narrow(axis, lat, n_out)

    # -------------------------------------------------------------- streaming
    @property
    def streamable(self) -> bool:
        return all(n.streamable for n in self.nodes)

    def _check_streamable(self):
        bad = [type(n).__name__ for n in self.nodes if not n.streamable]
        if bad:
            raise AudioError(
                f"nodes not streamable: {bad}", code=ErrorCode.CONFIG_VALIDATION_ERROR
            )

    def chunk_granularity(self) -> int:
        """Smallest valid streaming chunk (in input samples); any multiple works.

        Each node needs its incoming chunk to be a multiple of
        ``node.chunk_multiple()``; the incoming length is the input chunk
        scaled by the exact rational ratios of the preceding nodes.
        """
        return _granularity(self.nodes)

    def chunk_lens(self, chunk_in: int) -> list[int]:
        """Per-node streaming chunk lengths [n_0=chunk_in, ..., n_out]."""
        lens = [chunk_in]
        n = chunk_in
        for node in self.nodes:
            node.validate_chunk(n)
            n = node.out_len(n)
            lens.append(n)
        return lens

    def _downstream_granularity(self, i: int) -> int:
        """Chunk granularity of nodes[i+1:] in units of node i's output."""
        return _granularity(self.nodes[i + 1 :])

    def _delays(self, chunk_in: int) -> list[int]:
        """Per-node aligned streaming delay (in that node's output units).

        A node's intrinsic latency (e.g. a resampler's filter lookahead) is a
        shift in its *output sample grid*; if it is not a whole multiple of
        the downstream chain's granularity (e.g. an STFT hop), downstream
        frames would land on a shifted grid and streaming would only
        approximate offline. Padding the delay up to that granularity makes
        the streamed output an exact (whole-unit) shift of the offline one.
        """
        lens = self.chunk_lens(chunk_in)
        out = []
        for i, node in enumerate(self.nodes):
            lat = node.latency(lens[i])
            align = self._downstream_granularity(i)
            pad = (-lat) % align if lat else 0
            out.append(lat + pad)
        return out

    def _warmups(self, chunk_in: int) -> list[int]:
        """Cumulative upstream warmup per node, in that node's INPUT units.

        The first ``warmups[i]`` units node i receives are upstream *preroll*
        — outputs a latency-bearing ancestor computed from zero history that
        correspond to nothing in the offline run. ``stream_step`` zeros the
        warmup region, which reproduces exactly what each node sees offline
        (zero prehistory): zero input is a fixpoint of every carried state.
        """
        lens = self.chunk_lens(chunk_in)
        delays = self._delays(chunk_in)
        warm = []
        for i in range(len(self.nodes)):
            u = Fraction(0)
            for j in range(i):
                u += Fraction(delays[j] * lens[i], lens[j + 1])
            if u.denominator != 1:
                raise AudioError(f"warmup of node {i} is not whole: {u}", code=ErrorCode.INTERNAL)
            warm.append(int(u))
        return warm

    def stream_latency(self, chunk_in: int) -> int:
        """Total streaming latency in final-output units (exact integer)."""
        lens = self.chunk_lens(chunk_in)
        delays = self._delays(chunk_in)
        total = 0
        for i, d in enumerate(delays):
            if (d * lens[-1]) % lens[i + 1]:
                raise AudioError(f"delay of node {i} is not whole", code=ErrorCode.INTERNAL)
            total += d * lens[-1] // lens[i + 1]
        return total

    def _stream_axis(self, node: Node) -> int:
        return -2 if node.domain_out == "frames" else -1

    def init_state(
        self, chunk_in: int, lead_shape: tuple = (), dtype=torch.float32, device=None,
    ):
        """Initial stream state: ``(carries, pendings, k)``.

        ``pendings[i]`` is the zero-filled delay-alignment buffer for node i
        (None when no alignment is needed); shapes come from one step over
        meta tensors, so nothing is computed. ``k`` is the int chunk counter.
        """
        self._check_streamable()
        lens = self.chunk_lens(chunk_in)
        delays = self._delays(chunk_in)

        def carries_on(dev):
            out, n = [], chunk_in
            for node in self.nodes:
                out.append(node.init_carry(lead_shape, n, dtype, dev))
                n = node.out_len(n)
            return out

        # shape pass: per-node step outputs over meta tensors
        x = torch.empty((*lead_shape, chunk_in), dtype=dtype, device="meta")
        out_specs = []
        for node, carry in zip(self.nodes, carries_on("meta")):
            _, x = node.step(carry, x)
            out_specs.append(x)
        pendings = []
        for i, node in enumerate(self.nodes):
            pad = delays[i] - node.latency(lens[i])
            if pad == 0:
                pendings.append(None)
                continue
            spec = out_specs[i]
            shape = list(spec.shape)
            shape[self._stream_axis(node) % len(shape)] = pad
            pendings.append(torch.zeros(shape, dtype=spec.dtype, device=device))
        return carries_on(device), pendings, 0

    def stream_step(self, state, chunk: torch.Tensor):
        """One fixed-shape streaming step through every node.

        The carried ``k`` (chunk index) drives warmup zeroing (see
        :meth:`_warmups`): node i's input positions below ``warmups[i]`` are
        forced to zero so its state matches the offline zero-prehistory run.
        """
        carries, pendings, k = state
        lens = self.chunk_lens(chunk.shape[-1])
        warmups = self._warmups(chunk.shape[-1])
        new_carries, new_pendings = [], []
        x = chunk
        domain = "samples"
        for i, (node, carry, pending) in enumerate(zip(self.nodes, carries, pendings)):
            n_zero = min(lens[i], warmups[i] - k * lens[i])
            if n_zero > 0:
                axis = (-2 if domain == "frames" else -1) % x.ndim
                x = x.clone()
                x.narrow(axis, 0, n_zero).zero_()
            if node.domain_out != "any":
                domain = node.domain_out
            carry, x = node.step(carry, x)
            if pending is not None:
                axis = self._stream_axis(node) % x.ndim
                n_out = x.shape[axis]
                buf = torch.cat([pending, x], dim=axis)
                x = buf.narrow(axis, 0, n_out)
                pending = buf.narrow(axis, n_out, buf.shape[axis] - n_out)
            new_carries.append(carry)
            new_pendings.append(pending)
        return (new_carries, new_pendings, k + 1), x

    def scan_stream(self, x, chunk_in: int, device=None) -> torch.Tensor:
        """Stream a whole signal: a loop of :meth:`stream_step` over chunks.

        ``x [..., T]`` with T a multiple of chunk_in, a tensor or a numpy
        array that goes to ``device`` (as in :meth:`compile`). Output chunks
        are concatenated along the streamed axis.
        """
        self._check_streamable()
        x = as_tensor(x, device)
        t = x.shape[-1]
        if t % chunk_in:
            raise AudioError(
                f"signal length {t} not a multiple of chunk_in {chunk_in}; pad first",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        state = self.init_state(chunk_in, x.shape[:-1], x.dtype, x.device)
        outs = []
        for c in range(t // chunk_in):
            state, out = self.stream_step(state, x[..., c * chunk_in : (c + 1) * chunk_in])
            outs.append(out)
        return torch.cat(outs, dim=-2 if self._out_domain == "frames" else -1)


def chain(*nodes: Node, input_rate: int | None = None, name: str = "graph") -> Graph:
    """Convenience constructor: ``chain(Resample(...), Spectrogram(...), ...)``."""
    return Graph(tuple(nodes), input_rate=input_rate, name=name)
