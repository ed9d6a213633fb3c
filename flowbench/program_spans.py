"""Arithmetic that the readers of the program's own spans share
(``flowbench/metrics/``): the newest recording of
``audioflow_torch.obs.trace``, which a ``--trace 1`` run makes over its
traced stretch (the profiler the harness runs there turns the program's
spans on), and the program's table of one-time work.

Each function returns None where there is nothing to read: an untraced run,
a program without the tracer, a span that was not recorded, or device
intervals where no CUDA events were recorded (the CPU).
"""

from __future__ import annotations


def snapshot(r) -> dict | None:
    """The program's snapshot of a traced run, None for an untraced one or
    a program without the tracer."""
    if r.trace is None or r.traced_units <= 0:
        return None
    try:
        from audioflow_torch.obs import trace
    except ImportError:
        return None
    return trace.snapshot()


def _span(r, name) -> dict | None:
    s = snapshot(r)
    return None if s is None else s["spans"].get(name)


def device_ms_per_span(r, name):
    """The device total of the span ``name`` over its count, in ms."""
    st = _span(r, name)
    if st is None or not st["device_count"]:
        return None
    return 1e3 * st["device_s"] / st["device_count"]


def edge_device_ms_per_pass(r):
    """The graph's own device time a pass, outside its nodes' steps, over the
    passes, in ms: the pass less its steps (``init_state``'s fills, the
    output concat, any idle at a pass's edges) and the steps' warmup zeroing
    and delay alignment (``graph.align``)."""
    scan, step = _span(r, "graph.scan_stream"), _span(r, "graph.stream_step")
    if scan is None or step is None or not scan["device_count"] or not step["device_count"]:
        return None
    align = _span(r, "graph.align")  # none where no node's output is delayed
    align_s = (align["device_s"] or 0.0) if align is not None else 0.0
    return 1e3 * (scan["device_s"] - step["device_s"] + align_s) / scan["device_count"]


GRAPH_SPANS = ("graph.scan_stream", "graph.init_state", "graph.stream_step")


def graph_host_self_ms_per_pass(r):
    """The host self time of the graph's own spans (the node spans and the
    output concat left out) over the passes, in ms."""
    spans = [_span(r, name) for name in GRAPH_SPANS]
    if any(s is None for s in spans):
        return None
    return 1e3 * sum(s["self_s"] for s in spans) / spans[0]["count"]


def first_use_s(r, name):
    """The seconds of the program's first run of ``name`` in the process."""
    s = snapshot(r)
    return None if s is None else s["first"].get(name)
