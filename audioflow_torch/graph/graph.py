"""The flow-graph: a chain of nodes run eagerly on tensors.

Mirrors ``audioflow_tpu/graph/graph.py::Graph``. Two execution modes:

* ``compile()`` — offline: ``fn(batch [..., T]) -> features``; long inputs
  run through the streaming machinery (``_chunked_chain``), which equals the
  whole-array chain up to f32 rounding;
* ``init_state`` / ``stream_step`` — streaming: fixed-shape steps with an
  explicit ``(carries, pendings, k)`` state; ``scan_stream`` runs a whole
  signal as a Python loop over chunks (the JAX package's ``lax.scan``).

:class:`Fork` feeds one trunk graph into named branch graphs, each with its
own output and streaming latency.

The chunk counter ``k`` is a plain int, so the state converts both ways with
the JAX package's checkpoint pytree (:mod:`audioflow_torch.convert`).
Streamed output equals offline output shifted by ``stream_latency``: the
delay alignment (``_delays``), the warmup zeroing (``_warmups``) and the
nodes' two hooks into it (``wants_first_index``, ``warmup_passthrough``) are
ported line for line. The schedule is a :class:`StreamPlan`, resolved once
a chunk size; the step output shapes once a chunk size, lead shape and
dtype. ``Graph``, ``Fork`` and ``Mix`` share one :func:`delay_line`.

A ``scan_stream`` pass, its ``init_state``, each step, each node's step,
the warmup zeroing and delay alignment around it (``graph.align``) and the
output concat are spans of :mod:`audioflow_torch.obs.trace` (``graph.*``,
``node.<Type>``): one flag check each while tracing is off.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable

import torch

from ..errors import AudioError, ConfigError, ErrorCode
from ..obs import trace
from ..ops.stft import pad_center
from ..utils import as_tensor
from .nodes import Node, Spectrogram


def _domains_compatible(out_d: str, in_d: str) -> bool:
    return out_d == in_d or "any" in (out_d, in_d)


def _input_multiple(m: int, ratio: Fraction) -> int:
    """Smallest input chunk whose length scaled by ``ratio`` is a multiple of ``m``."""
    return (m * ratio.denominator) // math.gcd(ratio.numerator, m * ratio.denominator)


def _granularity(nodes, tails=()) -> int:
    """Smallest input chunk that every node of ``nodes`` takes in whole
    multiples, and after them every graph of ``tails`` (a Fork's branches)."""
    gran = 1
    ratio = Fraction(1)
    for node in nodes:
        m = node.chunk_multiple()
        gran = math.lcm(gran, _input_multiple(m, ratio))
        ratio *= Fraction(node.out_len(m), m)
    for g in tails:
        gran = math.lcm(gran, _input_multiple(g.chunk_granularity(), ratio))
    return gran


def stream_axis(domain: str) -> int:
    """The axis a stream in ``domain`` runs along: frames ``[..., n, bins]``, anything else ``[..., n]``."""
    return -2 if domain == "frames" else -1


def zero_preroll(x: torch.Tensor, n_zero: int, axis: int) -> torch.Tensor:
    """A copy of ``x`` whose first ``n_zero`` positions along ``axis`` are
    zeros: the warmup zeroing (see :meth:`Graph._warmups`)."""
    x = x.clone()
    x.narrow(axis % x.ndim, 0, n_zero).zero_()
    return x


def delay_line(pending: torch.Tensor, x: torch.Tensor, axis: int):
    """``x`` delayed along ``axis`` by the width of ``pending``: ``(out,
    new_pending)``, the first ``x.shape[axis]`` positions of ``[pending |
    x]`` and the rest."""
    axis %= x.ndim
    n_out = x.shape[axis]
    buf = torch.cat([pending, x], dim=axis)
    return buf.narrow(axis, 0, n_out), buf.narrow(axis, n_out, buf.shape[axis] - n_out)


def delay_buffer(spec, width: int, axis: int, device):
    """The zero-filled ``pending`` of a :func:`delay_line` ``width`` wide along
    ``axis``, for outputs of ``spec`` ``(shape, dtype)``; None for width 0."""
    if width == 0:
        return None
    shape, dtype = spec
    shape = list(shape)
    shape[axis % len(shape)] = width
    return torch.zeros(shape, dtype=dtype, device=device)


_MEMO = 8  # chunk sizes, and keys of output shapes, a graph keeps resolved


def _memo(table: dict, key, make):
    """``table[key]``, made by ``make()`` on a miss; the oldest of ``_MEMO`` entries makes way."""
    hit = table.get(key)
    if hit is None:
        hit = make()
        if len(table) >= _MEMO:
            table.pop(next(iter(table)), None)
        table[key] = hit
    return hit


@dataclass(frozen=True)
class StreamPlan:
    """The streaming schedule of a graph at one input chunk, a pure function
    of its nodes and ``chunk_in``, resolved once (:meth:`Graph._plan`)."""

    lens: tuple[int, ...]  # per-node chunk lengths [n_0 = chunk_in, ..., n_out]
    delays: tuple[int, ...]  # per-node aligned delay, in that node's output units
    warmups: tuple[int, ...]  # per-node upstream warmup, in that node's input units
    latency: int  # in final-output units
    widths: tuple[int, ...]  # per-node delay-line width: its delay less its own latency
    axes: tuple[int, ...]  # the streamed axis of each node's output (its delay line)


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
        domains = ["samples"]  # the domain entering each node, then the chain's output
        for i, node in enumerate(self.nodes):
            if not _domains_compatible(domains[-1], node.domain_in):
                raise ConfigError(
                    f"node {i} ({type(node).__name__}) expects domain "
                    f"{node.domain_in!r} but receives {domains[-1]!r}"
                )
            node = node.bind(rate)
            bound.append(node)
            rate = node.rate_out(rate)
            domains.append(domains[-1] if node.domain_out == "any" else node.domain_out)
        object.__setattr__(self, "nodes", tuple(bound))
        object.__setattr__(self, "output_rate", rate)
        object.__setattr__(self, "_domains", tuple(domains))
        # resolved once and kept: the plan by chunk_in, the step output
        # specs by (chunk_in, lead_shape, dtype)
        object.__setattr__(self, "_plans", {})
        object.__setattr__(self, "_specs", {})

    # ------------------------------------------------------------------ chain
    def chain(self, x: torch.Tensor, taps: tuple[int, ...] = ()):
        """Apply all nodes, whole-array.

        ``taps`` are node indices whose outputs are also returned; with taps
        the return is ``(final, {idx: tapped_output, ...})``.
        """
        tapped = {}
        for i, node in enumerate(self.nodes):
            x = node.apply(x)
            if i in taps:
                tapped[i] = x
        return (x, tapped) if taps else x

    def __call__(self, x):
        return self.chain(x)

    # auto-chunk threshold in input samples, as in the JAX package
    _CHUNKED_MIN_T = 65536

    def compile(
        self, donate: bool = False, taps: tuple[int, ...] = (), chunked: bool | str = "auto",
    ) -> Callable:
        """The offline function ``fn(x, device=None) -> output``.

        ``x [..., T]`` is a tensor, or a numpy array that goes to ``device``
        ("cuda" unless given; see :func:`audioflow_torch.utils.as_tensor`).
        ``donate`` is the JAX package's buffer-donation flag, accepted for
        parity and ignored: the chain never writes its input. ``taps`` are
        node indices whose outputs are also returned, as in :meth:`chain`;
        a tapped function is never chunked. ``chunked`` — long-signal
        execution strategy: the same chain run as a loop over fixed chunks
        through the streaming machinery, trimmed to the offline output.
        ``"auto"`` (default) picks the chunked form when the graph is
        streamable, untapped, and the input is long; ``True``/``False``
        force it.
        """
        del donate
        if taps:
            bad = [i for i in taps if not 0 <= i < len(self.nodes)]
            if bad:
                raise ConfigError(f"tap indices out of range: {bad}")
            taps = tuple(taps)
            return lambda x, device=None: self.chain(as_tensor(x, device), taps=taps)
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
        return self._domains[-1]

    def _chunked_chain(self, x: torch.Tensor) -> torch.Tensor:
        """Offline semantics via the streaming machinery (see compile)."""
        if not self.streamable:
            pad, g = self._decentered()  # compile() guarantees it exists
            return g._chunked_chain(pad_center(x, 2 * pad))
        t = x.shape[-1]
        # output shape of the whole-array chain, from a pass over meta tensors
        out_shape = self.chain(torch.empty(x.shape, dtype=x.dtype, device="meta")).shape
        axis = stream_axis(self._out_domain) % len(out_shape)
        n_out = out_shape[axis]
        gran = self.chunk_granularity()
        chunk = gran * max(1, 16384 // gran)
        plan = self._plan(chunk)
        lat, m = plan.latency, plan.lens[-1]
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

    def inspect(self, input_shape: tuple, dtype=torch.float32, device=None) -> dict:
        """Cost counts of one call of :meth:`chain` on ``device`` ("cuda"
        unless given), under the JAX package's keys (there XLA's cost
        analysis of the compiled program):

        * ``flops``: what ``torch.utils.flop_counter.FlopCounterMode``
          counts, the matmuls and convolutions (elementwise work and FFTs
          are not counted);
        * ``fusions``: the kernel launches, the CUDA launch calls that
          ``torch.profiler`` records on the card, the aten ops
          (``profiling.aten_ops``, views left out) on the CPU;
        * ``collectives``: 0 (one device);
        * ``bytes_accessed``, ``hlo_bytes``: -1.0, the JAX package's value
          where a backend has no analysis.

        The input is seeded noise of ``input_shape`` (a call needs data);
        a first call builds what the graph's kernels need, and is not
        counted.
        """
        from ..profiling import aten_ops, count_flops
        from ..utils import resolve_device

        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(0)
        x = (0.1 * torch.randn(tuple(input_shape), generator=gen)).to(dtype=dtype, device=dev)
        self.chain(x)
        flops = count_flops(lambda: self.chain(x))
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                self.chain(x)
                torch.cuda.synchronize(dev)
            launches = sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)
        else:
            launches = aten_ops(lambda: self.chain(x))
        return {
            "flops": flops,
            "bytes_accessed": -1.0,
            "fusions": int(launches),
            "collectives": 0,
            "hlo_bytes": -1.0,
        }

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

    def _plan(self, chunk_in: int) -> StreamPlan:
        """The streaming schedule at ``chunk_in``, resolved once."""
        return _memo(self._plans, chunk_in, lambda: self._resolve(chunk_in))

    def _resolve(self, chunk_in: int) -> StreamPlan:
        nodes = self.nodes
        lens = [chunk_in]
        for node in nodes:
            node.validate_chunk(lens[-1])
            lens.append(node.out_len(lens[-1]))
        # a node's intrinsic latency is padded up to the downstream chain's
        # granularity (see _delays)
        own = [node.latency(lens[i]) for i, node in enumerate(nodes)]
        widths = [(-lat) % _granularity(nodes[i + 1 :]) if lat else 0 for i, lat in enumerate(own)]
        delays = [lat + w for lat, w in zip(own, widths)]
        warmups = []
        for i in range(len(nodes)):
            u = sum((Fraction(delays[j] * lens[i], lens[j + 1]) for j in range(i)), Fraction(0))
            if u.denominator != 1:
                raise AudioError(f"warmup of node {i} is not whole: {u}", code=ErrorCode.INTERNAL)
            warmups.append(int(u))
        latency = 0
        for i, d in enumerate(delays):
            if (d * lens[-1]) % lens[i + 1]:
                raise AudioError(f"delay of node {i} is not whole", code=ErrorCode.INTERNAL)
            latency += d * lens[-1] // lens[i + 1]
        axes = tuple(stream_axis(node.domain_out) for node in nodes)
        return StreamPlan(tuple(lens), tuple(delays), tuple(warmups), latency, tuple(widths), axes)

    def chunk_lens(self, chunk_in: int) -> list[int]:
        """Per-node streaming chunk lengths [n_0=chunk_in, ..., n_out]."""
        return list(self._plan(chunk_in).lens)

    def _delays(self, chunk_in: int) -> list[int]:
        """Per-node aligned streaming delay (in that node's output units).

        A node's intrinsic latency (e.g. a resampler's filter lookahead) is a
        shift in its *output sample grid*; if it is not a whole multiple of
        the downstream chain's granularity (e.g. an STFT hop), downstream
        frames would land on a shifted grid and streaming would only
        approximate offline. Padding the delay up to that granularity makes
        the streamed output an exact (whole-unit) shift of the offline one.
        """
        return list(self._plan(chunk_in).delays)

    def _warmups(self, chunk_in: int) -> list[int]:
        """Cumulative upstream warmup per node, in that node's INPUT units.

        The first ``warmups[i]`` units node i receives are upstream *preroll*
        — outputs a latency-bearing ancestor computed from zero history that
        correspond to nothing in the offline run. ``stream_step`` zeros the
        warmup region, which reproduces exactly what each node sees offline
        (zero prehistory): zero input is a fixpoint of every carried state.
        """
        return list(self._plan(chunk_in).warmups)

    def stream_latency(self, chunk_in: int) -> int:
        """Total streaming latency in final-output units (exact integer)."""
        return self._plan(chunk_in).latency

    def _carries(self, chunk_in: int, lead_shape, dtype, device) -> list:
        lens = self._plan(chunk_in).lens
        return [node.init_carry(lead_shape, n, dtype, device) for node, n in zip(self.nodes, lens)]

    def _out_specs(self, chunk_in: int, lead_shape: tuple = (), dtype=torch.float32) -> tuple:
        """Per-node step output ``(shape, dtype)``, from one pass over meta
        tensors per ``(chunk_in, lead_shape, dtype)``, so nothing is computed."""

        def shape_pass():
            with trace.first("graph.shape_pass"):
                x = torch.empty((*lead_shape, chunk_in), dtype=dtype, device="meta")
                specs = []
                for node, carry in zip(self.nodes, self._carries(chunk_in, lead_shape, dtype, "meta")):
                    _, x = node.step(carry, x)
                    specs.append((x.shape, x.dtype))
                return tuple(specs)

        return _memo(self._specs, (chunk_in, tuple(lead_shape), dtype), shape_pass)

    def init_state(
        self, chunk_in: int, lead_shape: tuple = (), dtype=torch.float32, device=None,
    ):
        """Initial stream state: ``(carries, pendings, k)``.

        ``pendings[i]`` is the zero-filled delay-alignment buffer for node i
        (None when no alignment is needed); shapes come from one step over
        meta tensors per key (:meth:`_out_specs`). ``k`` is the int chunk
        counter.
        """
        self._check_streamable()
        with trace.span("graph.init_state", device):
            plan = self._plan(chunk_in)
            specs = self._out_specs(chunk_in, lead_shape, dtype)
            pendings = [delay_buffer(spec, w, axis, device) for spec, w, axis in zip(specs, plan.widths, plan.axes)]
            return self._carries(chunk_in, lead_shape, dtype, device), pendings, 0

    def stream_step(self, state, chunk: torch.Tensor):
        """One fixed-shape streaming step through every node.

        The carried ``k`` (chunk index) drives warmup zeroing (see
        :meth:`_warmups`): node i's input positions below ``warmups[i]`` are
        forced to zero so its state matches the offline zero-prehistory run,
        unless the node sets ``warmup_passthrough``. A node that sets
        ``wants_first_index`` gets ``first_index = warmups[i] - k * lens[i]``,
        the chunk-relative position of its first real sample.
        """
        carries, pendings, k = state
        # the step launches nothing outside its nodes' spans and its
        # alignment's, so it takes its device interval from theirs and
        # records no events of its own
        with trace.span("graph.stream_step", index=k):
            plan = self._plan(chunk.shape[-1])
            new_carries, new_pendings = [], []
            x = chunk
            for i, (node, carry, pending) in enumerate(zip(self.nodes, carries, pendings)):
                first = plan.warmups[i] - k * plan.lens[i]
                n_zero = min(plan.lens[i], first)
                if n_zero > 0 and not node.warmup_passthrough:
                    with trace.span("graph.align", x, i):
                        x = zero_preroll(x, n_zero, stream_axis(self._domains[i]))
                with trace.span(node.trace_name, x, i):
                    if node.wants_first_index:
                        carry, x = node.step(carry, x, first_index=first)
                    else:
                        carry, x = node.step(carry, x)
                if pending is not None:
                    with trace.span("graph.align", x, i):
                        x, pending = delay_line(pending, x, plan.axes[i])
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
        x = _signal(x, chunk_in, device)
        with trace.span("graph.scan_stream", x):
            outs = _scan(self, x, chunk_in)
            with trace.span("graph.concat", x):
                return _cat_chunks(outs, x)

    def compile_stream(self, donate: bool = True) -> Callable:
        """``step(state, chunk) -> (state, out)``: :meth:`stream_step`.
        ``donate`` is the JAX package's flag, accepted for parity: the step
        allocates new state tensors and never writes the ones it is given."""
        return self.stream_step


def chain(*nodes: Node, input_rate: int | None = None, name: str = "graph") -> Graph:
    """Convenience constructor: ``chain(Resample(...), Spectrogram(...), ...)``."""
    return Graph(tuple(nodes), input_rate=input_rate, name=name)


@dataclass(frozen=True)
class Fork:
    """A trunk graph feeding N named branch graphs: VAD-gated wire egress and
    ungated features from one capture stream, the trunk computed once.

    Unlike :class:`~audioflow_torch.graph.nodes.Mix`, which merges same-shape
    branches back into the chain, the branches are whole graphs with their
    own output domains, lengths and streaming latencies; outputs are a
    ``{name: tensor}`` dict.

    Streaming: the state is ``(trunk_state, {name: branch_state},
    {name: pending})``; each branch's streamed output equals its offline
    output shifted by that branch's ``stream_latency``.
    """

    trunk: Graph
    branches: tuple  # ((name, Graph), ...)
    name: str = "fork"

    def __post_init__(self):
        if not self.branches:
            raise ConfigError("Fork needs at least one branch")
        bs = tuple((str(k), g) for k, g in self.branches)
        names = [k for k, _ in bs]
        if len(set(names)) != len(names):
            raise ConfigError(f"duplicate Fork branch names: {names}")
        out_rate = self.trunk.output_rate
        out_domain = self.trunk._out_domain
        for k, g in bs:
            if not _domains_compatible(out_domain, g.nodes[0].domain_in):
                raise ConfigError(
                    f"Fork branch {k!r} expects domain {g.nodes[0].domain_in!r} "
                    f"but trunk produces {out_domain!r}"
                )
            if g.input_rate is not None and out_rate is not None and g.input_rate != out_rate:
                raise ConfigError(
                    f"Fork branch {k!r} input_rate {g.input_rate} != trunk output rate {out_rate}"
                )
        object.__setattr__(self, "branches", bs)

    @property
    def input_rate(self):
        return self.trunk.input_rate

    @property
    def streamable(self) -> bool:
        return self.trunk.streamable and all(g.streamable for _, g in self.branches)

    # ------------------------------------------------------------- offline
    def chain(self, x: torch.Tensor) -> dict:
        y = self.trunk.chain(x)
        return {k: g.chain(y) for k, g in self.branches}

    def __call__(self, x):
        return self.chain(x)

    def compile(self, donate: bool = False) -> Callable:
        """``fn(x, device=None) -> {name: output}``, every branch from one
        trunk run; numpy input goes to ``device`` as in :meth:`Graph.compile`."""

        def run(x, device=None):
            return self.chain(as_tensor(x, device))

        return run

    # ----------------------------------------------------------- streaming
    def chunk_granularity(self) -> int:
        # a branch's granularity maps back through the trunk's rate ratio
        return _granularity(self.trunk.nodes, [g for _, g in self.branches])

    def _branch_pads(self, chunk_in: int) -> dict:
        """The trunk's latency padded up to each branch's granularity, so
        each branch's streamed output is a whole-unit shift of its offline
        output (the alignment ``Graph._delays`` applies within a chain)."""
        trunk_lat = self.trunk.stream_latency(chunk_in)
        return {k: (-trunk_lat) % g.chunk_granularity() if trunk_lat else 0 for k, g in self.branches}

    def stream_latency(self, chunk_in: int) -> dict:
        """Per-branch streaming latency in that branch's output units."""
        mid = self.trunk.chunk_lens(chunk_in)[-1]
        trunk_lat = self.trunk.stream_latency(chunk_in)
        pads = self._branch_pads(chunk_in)
        out = {}
        for k, g in self.branches:
            lens = g.chunk_lens(mid)
            aligned = trunk_lat + pads[k]
            if (aligned * lens[-1]) % mid:
                raise AudioError(f"Fork branch {k!r}: latency is not whole", code=ErrorCode.INTERNAL)
            out[k] = aligned * lens[-1] // mid + g.stream_latency(mid)
        return out

    def init_state(self, chunk_in: int, lead_shape: tuple = (), dtype=torch.float32, device=None):
        mid = self.trunk.chunk_lens(chunk_in)[-1]
        pads = self._branch_pads(chunk_in)
        trunk_state = self.trunk.init_state(chunk_in, lead_shape, dtype, device)
        spec = self.trunk._out_specs(chunk_in, lead_shape, dtype)[-1]
        axis = stream_axis(self.trunk._out_domain)
        return (
            trunk_state,
            {k: g.init_state(mid, lead_shape, dtype, device) for k, g in self.branches},
            {k: delay_buffer(spec, pads[k], axis, device) for k, _ in self.branches},
        )

    def stream_step(self, state, chunk: torch.Tensor):
        trunk_state, branch_states, pend = state
        step_idx = trunk_state[2]  # the trunk's chunk counter drives the preroll zeroing
        trunk_state, y = self.trunk.stream_step(trunk_state, chunk)
        axis = stream_axis(self.trunk._out_domain) % y.ndim
        y_zeroed = y
        n_zero = min(y.shape[axis], self.trunk.stream_latency(chunk.shape[-1]) - step_idx * y.shape[axis])
        if n_zero > 0:
            # zero the trunk's own preroll so that no branch carry sees it
            # (Graph._warmups within a chain); a branch whose head node
            # consumes the preroll (warmup_passthrough) gets the raw output
            y_zeroed = zero_preroll(y, n_zero, axis)
        new_states, new_pend, outs = {}, {}, {}
        for k, g in self.branches:
            yk, pk = (y if g.nodes[0].warmup_passthrough else y_zeroed), pend[k]
            if pk is not None:
                # the JAX package's order: a padded branch takes the raw
                # trunk output, its preroll not zeroed
                yk, pk = delay_line(pk, y, axis)
            new_states[k], outs[k] = g.stream_step(branch_states[k], yk)
            new_pend[k] = pk
        return (trunk_state, new_states, new_pend), outs

    def compile_stream(self, donate: bool = True) -> Callable:
        """:meth:`stream_step`, as :meth:`Graph.compile_stream`."""
        return self.stream_step

    def scan_stream(self, x, chunk_in: int, device=None) -> dict:
        """Stream a whole signal; a dict of each branch's concatenated output."""
        x = _signal(x, chunk_in, device)
        outs = _scan(self, x, chunk_in)
        return {k: _cat_chunks([o[k] for o in outs], x) for k, _ in self.branches}


def _signal(x, chunk_in: int, device) -> torch.Tensor:
    """``x`` as a tensor (see :func:`~audioflow_torch.utils.as_tensor`), checked to stream in whole chunks."""
    x = as_tensor(x, device)
    if x.shape[-1] % chunk_in:
        raise AudioError(
            f"signal length {x.shape[-1]} not a multiple of chunk_in {chunk_in}; pad first",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    return x


def _scan(stream, x: torch.Tensor, chunk_in: int) -> list:
    """The outputs of a :class:`Graph`'s or :class:`Fork`'s ``stream_step``
    over ``x [..., T]`` chunk by chunk, from its ``init_state``."""
    state = stream.init_state(chunk_in, x.shape[:-1], x.dtype, x.device)
    outs = []
    for c in range(x.shape[-1] // chunk_in):
        state, out = stream.stream_step(state, x[..., c * chunk_in : (c + 1) * chunk_in])
        outs.append(out)
    return outs


def _cat_chunks(outs: list, x: torch.Tensor) -> torch.Tensor:
    # the streamed axis follows the lead axes, whatever the domain (a Vad's
    # states are [..., n_frames])
    return torch.cat(outs, dim=x.ndim - 1)


def fork(trunk: Graph, name: str = "fork", **branches: Graph) -> Fork:
    """Convenience constructor: ``fork(trunk, wire=g1, features=g2)``."""
    return Fork(trunk, tuple(branches.items()), name=name)
