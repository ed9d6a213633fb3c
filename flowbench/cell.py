"""One run of one cell: set-up, the window, the comparison, the metrics.

:func:`run_cell` is the whole run except the look for a card, which
``flowbench/run.py`` makes first; tests call it on the CPU at small sizes.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import torch

from . import checks, reference
from .bench import Bench
from .case import Context, Window
from .devtrace import NoTracer, Summary, Tracer


@dataclass
class Readings:
    """What a metric's reader reads (``flowbench/metrics/<name>.py``:
    ``read(r) -> float | None``, None where it finds nothing to read)."""

    workload: str
    config: dict
    traffic: dict
    device_kind: str
    setup_s: float
    window: Window
    trace: Summary | None
    traced_units: int
    counts: dict


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
        }
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def _cpu_times() -> tuple[list[int], float]:
    """The machine's CPU time by kind (``/proc/stat``, empty where there is
    none) and this process's CPU seconds."""
    try:
        with open("/proc/stat") as f:
            fields = [int(v) for v in f.readline().split()[1:]]
    except OSError:
        fields = []
    return fields, time.process_time()


def _host_note(before, after, wall: float) -> str:
    (a, pa), (b, pb) = before, after
    note = f"this process used {pb - pa:.2f} CPU s over {wall:.2f} s"
    if a and b:
        d = [y - x for x, y in zip(a, b)]
        note += f"; the machine's CPU time: {100 * d[7] / max(1, sum(d[:8])):.1f}% stolen, " \
                f"{100 * d[3] / max(1, sum(d[:8])):.1f}% idle"
    return note


NAME_CHARS = 96  # device op names (C++ templates) are cut to this many characters


def _breakdown(s: Summary) -> dict:
    """The device ops that took most time and the device's idle time by
    the span the host was inside, ten of each."""
    ops = sorted(s.ops.items(), key=lambda kv: -kv[1][0])[:10]
    idle = sorted(s.idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:NAME_CHARS], v[0]] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def run_cell(
    bench: Bench,
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    device: torch.device,
    t_start: float,
    traffic: dict | None = None,
) -> tuple[dict, list[str]]:
    """``(result, notes)``: the result line's object and the lines for
    standard error. ``traffic`` overrides the cell's traffic file (tests run
    smaller mixes). ``t_start`` is the host clock at the process's start."""
    w = bench.workload(workload)
    config = bench.config(w["config"])
    traffic = traffic if traffic is not None else bench.traffic(w["traffic"])
    limits = bench.limits(workload)
    ctx = Context(workload, config, traffic, seed, seconds, device)
    case = bench.driver(traffic["driver"]).Case(ctx)
    notes = []
    try:
        case.setup()
        setup_s = time.perf_counter() - t_start
        if device.type == "cuda":  # the peak of the window, not of making the inputs
            torch.cuda.reset_peak_memory_stats(device)
        tracer = Tracer(traffic["trace_seconds"], device) if trace else NoTracer()
        cpu0, t0 = _cpu_times(), time.perf_counter()
        win = case.window(seconds, tracer)
        host = _host_note(cpu0, _cpu_times(), time.perf_counter() - t0)
        tracer.end()
        counts = {"step_ops": case.step_ops()} if trace else {}
        info = device_info(device)
        signal, rate, prog = case.outputs()
    finally:
        case.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference.run(config, signal, rate)
    values, left_out = checks.numbers(ref, prog)
    results = checks.against(values, limits)
    t_ref = time.perf_counter() - t_ref
    readings = Readings(workload, config, traffic, info["kind"], setup_s, win, tracer.summary, tracer.units, counts)
    metrics = {}
    for m in bench.metrics(workload, trace):
        v = bench.reader(m["name"]).read(readings)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": all(c.ok for c in results) and win.failed == 0,
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": metrics,
        "device": info,
    }
    parts = ", ".join(f"{k} {v:.3f}" for k, v in ctx.setup_parts.items())
    notes.append(f"setup_s {setup_s:.3f} ({parts}); window: {win.notes}; host: {host}; "
                 f"the reference and the comparison took {t_ref:.3f} s")
    if left_out:
        notes.append(f"rows left out of state and wire comparisons (a VAD decision within the margin): {left_out}")
    s = tracer.summary
    if s is not None:
        info["busy_s"], info["window_s"] = s.busy_s, s.window_s
        result["breakdown"] = _breakdown(s)
        notes.append(
            f"trace: {s.window_s:.3f} s traced, {s.events} device events recorded over {tracer.units} units "
            f"of work; exact counts: aten ops of one step {counts.get('step_ops')}, the program's kernel "
            f"launches in the stretch {s.launches}"
        )
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in results}
    notes += [f"check {c.name}: {c.value!r} (limit {c.limit!r})" for c in results]
    return result, notes


def run_control(bench: Bench, workload: str, seed: int, seconds: float, device, traffic: dict | None = None) -> dict:
    """The control's compared numbers for ``seed``: the plain reference in
    TF32 put in the program's place, on the inputs a run of ``seconds``
    compares, read by the same comparison against the float64 reference."""
    w = bench.workload(workload)
    config = bench.config(w["config"])
    traffic = traffic if traffic is not None else bench.traffic(w["traffic"])
    ctx = Context(workload, config, traffic, seed, seconds, device)
    signal, rate = bench.driver(traffic["driver"]).Case(ctx).inputs()
    ref = reference.run(config, signal, rate)
    low = reference.run(config, signal, rate, "tf32")
    return checks.numbers(ref, {k: v.value for k, v in low.items()})[0]
