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
ported line for line.

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
        with trace.span("graph.init_state", device):
            lens = self.chunk_lens(chunk_in)
            delays = self._delays(chunk_in)

            def carries_on(dev):
                out, n = [], chunk_in
                for node in self.nodes:
                    out.append(node.init_carry(lead_shape, n, dtype, dev))
                    n = node.out_len(n)
                return out

            # shape pass: per-node step outputs over meta tensors
            with trace.first("graph.shape_pass"):
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
            lens = self.chunk_lens(chunk.shape[-1])
            warmups = self._warmups(chunk.shape[-1])
            new_carries, new_pendings = [], []
            x = chunk
            domain = "samples"
            for i, (node, carry, pending) in enumerate(zip(self.nodes, carries, pendings)):
                n_zero = min(lens[i], warmups[i] - k * lens[i])
                if n_zero > 0 and not node.warmup_passthrough:
                    with trace.span("graph.align", x, i):
                        axis = (-2 if domain == "frames" else -1) % x.ndim
                        x = x.clone()
                        x.narrow(axis, 0, n_zero).zero_()
                if node.domain_out != "any":
                    domain = node.domain_out
                with trace.span(node.trace_name, x, i):
                    if node.wants_first_index:
                        carry, x = node.step(carry, x, first_index=warmups[i] - k * lens[i])
                    else:
                        carry, x = node.step(carry, x)
                if pending is not None:
                    with trace.span("graph.align", x, i):
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
        with trace.span("graph.scan_stream", x):
            state = self.init_state(chunk_in, x.shape[:-1], x.dtype, x.device)
            outs = []
            for c in range(t // chunk_in):
                state, out = self.stream_step(state, x[..., c * chunk_in : (c + 1) * chunk_in])
                outs.append(out)
            # the streamed axis follows the lead axes, whatever the domain (a
            # Vad's states are [..., n_frames])
            with trace.span("graph.concat", x):
                return torch.cat(outs, dim=x.ndim - 1)

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
        gran = self.trunk.chunk_granularity()
        # a branch's granularity maps back through the trunk's rate ratio
        ratio = Fraction(1)
        for node in self.trunk.nodes:
            m = node.chunk_multiple()
            ratio *= Fraction(node.out_len(m), m)
        for _, g in self.branches:
            m = g.chunk_granularity()
            need = (m * ratio.denominator) // math.gcd(ratio.numerator, m * ratio.denominator)
            gran = math.lcm(gran, need)
        return gran

    def _trunk_out_len(self, chunk_in: int) -> int:
        return self.trunk.chunk_lens(chunk_in)[-1]

    def _branch_pads(self, chunk_in: int) -> dict:
        """The trunk's latency padded up to each branch's granularity, so
        each branch's streamed output is a whole-unit shift of its offline
        output (the alignment ``Graph._delays`` applies within a chain)."""
        trunk_lat = self.trunk.stream_latency(chunk_in)
        return {k: (-trunk_lat) % g.chunk_granularity() if trunk_lat else 0 for k, g in self.branches}

    def _trunk_axis(self) -> int:
        return -2 if self.trunk._out_domain == "frames" else -1

    def stream_latency(self, chunk_in: int) -> dict:
        """Per-branch streaming latency in that branch's output units."""
        mid = self._trunk_out_len(chunk_in)
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
        mid = self._trunk_out_len(chunk_in)
        pads = self._branch_pads(chunk_in)
        trunk_state = self.trunk.init_state(chunk_in, lead_shape, dtype, device)
        spec = self.trunk.stream_step(
            self.trunk.init_state(chunk_in, lead_shape, dtype, "meta"),
            torch.empty((*lead_shape, chunk_in), dtype=dtype, device="meta"),
        )[1]
        pend = {}
        for k, _ in self.branches:
            if pads[k] == 0:
                pend[k] = None
                continue
            shape = list(spec.shape)
            shape[self._trunk_axis() % len(shape)] = pads[k]
            pend[k] = torch.zeros(shape, dtype=spec.dtype, device=device)
        return (
            trunk_state,
            {k: g.init_state(mid, lead_shape, dtype, device) for k, g in self.branches},
            pend,
        )

    def stream_step(self, state, chunk: torch.Tensor):
        trunk_state, branch_states, pend = state
        step_idx = trunk_state[2]  # the trunk's chunk counter drives the preroll zeroing
        trunk_state, y = self.trunk.stream_step(trunk_state, chunk)
        axis = self._trunk_axis() % y.ndim
        trunk_lat = self.trunk.stream_latency(chunk.shape[-1])
        y_zeroed = y
        n_zero = min(y.shape[axis], trunk_lat - step_idx * y.shape[axis])
        if n_zero > 0:
            # zero the trunk's own preroll so that no branch carry sees it
            # (Graph._warmups within a chain); a branch whose head node
            # consumes the preroll (warmup_passthrough) gets the raw output
            y_zeroed = y.clone()
            y_zeroed.narrow(axis, 0, n_zero).zero_()
        new_states, new_pend, outs = {}, {}, {}
        for k, g in self.branches:
            yk = y if g.nodes[0].warmup_passthrough else y_zeroed
            pk = pend[k]
            if pk is not None:
                # the JAX package's order: a padded branch takes the raw
                # trunk output, its preroll not zeroed
                n_out = y.shape[axis]
                buf = torch.cat([pk, y], dim=axis)
                yk = buf.narrow(axis, 0, n_out)
                pk = buf.narrow(axis, n_out, buf.shape[axis] - n_out)
            new_states[k], outs[k] = g.stream_step(branch_states[k], yk)
            new_pend[k] = pk
        return (trunk_state, new_states, new_pend), outs

    def compile_stream(self, donate: bool = True) -> Callable:
        """:meth:`stream_step`, as :meth:`Graph.compile_stream`."""
        return self.stream_step

    def scan_stream(self, x, chunk_in: int, device=None) -> dict:
        """Stream a whole signal; a dict of each branch's concatenated output."""
        x = as_tensor(x, device)
        t = x.shape[-1]
        if t % chunk_in:
            raise AudioError(
                f"signal length {t} not a multiple of chunk_in {chunk_in}; pad first",
                code=ErrorCode.SHAPE_MISMATCH,
            )
        state = self.init_state(chunk_in, x.shape[:-1], x.dtype, x.device)
        outs = {k: [] for k, _ in self.branches}
        for c in range(t // chunk_in):
            state, out = self.stream_step(state, x[..., c * chunk_in : (c + 1) * chunk_in])
            for k, v in out.items():
                outs[k].append(v)
        return {k: torch.cat(v, dim=x.ndim - 1) for k, v in outs.items()}


def fork(trunk: Graph, name: str = "fork", **branches: Graph) -> Fork:
    """Convenience constructor: ``fork(trunk, wire=g1, features=g2)``."""
    return Fork(trunk, tuple(branches.items()), name=name)
