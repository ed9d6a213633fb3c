"""The metrics' arithmetic: percentiles over all samples, spreads, the
roofline counted from shapes, and the busy and idle shares and idle gaps
reduced from a synthetic trace."""

import math
import statistics

import numpy as np
import pytest

from flowbench import devtrace, readers, roofline, stats
from flowbench.bench import Bench
from flowbench.case import Window
from flowbench.cell import Readings


def test_p95_is_over_all_samples_by_linear_interpolation():
    rng = np.random.default_rng(0)
    for n in (1, 2, 20, 375, 1001):
        v = rng.exponential(size=n).tolist()
        assert stats.percentile(v, 95) == pytest.approx(float(np.percentile(v, 95)), rel=1e-12)
    assert stats.percentile(list(range(101)), 95) == 95


def test_quartile_spread_is_statistics_quartiles_over_the_median():
    v = [10.0, 11.0, 9.5, 10.2, 10.8, 9.9]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.quartile_spread(v) == pytest.approx((q3 - q1) / statistics.median(v))


def test_the_melspec_roofline_is_counted_from_the_calls_shapes():
    flops, nbytes = roofline.melspec_work(512, 5888, 1024, 256, 128, 1000)
    frames = 20
    assert nbytes == 4 * (512 * 5888 + 2 * 1024 + 3 * 128 + 1000 + 512 * frames * 128)
    assert flops == 512 * frames * (1024 + 2.5 * 1024 * 10 + 3 * 513 + 2000 + 256)
    least = roofline.least_seconds("NVIDIA H100 80GB HBM3", flops, nbytes)
    assert least == pytest.approx(max(flops / 67e12, nbytes / 3.35e12))
    assert least == pytest.approx(nbytes / 3.35e12)  # the call is bound by its bytes
    assert roofline.least_seconds("some other card", flops, nbytes) is None


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace():
    return [
        _ev("user_annotation", devtrace.WINDOW, 100.0, 1000.0),
        _ev("user_annotation", "flowbench.graph.scan_stream", 100.0, 500.0),
        _ev("user_annotation", "flowbench.session.push", 700.0, 300.0),
        _ev("user_annotation", "flowbench.result.host_copy", 800.0, 50.0),  # nested in the push
        _ev("kernel", "melspec_fft_kernel", 150.0, 100.0),
        _ev("kernel", "gemm", 200.0, 100.0),  # overlaps the first: busy is their union
        _ev("gpu_memcpy", "Memcpy HtoD", 820.0, 10.0),
        _ev("kernel", "melspec_fft_kernel", 1050.0, 100.0),  # half outside the stretch
        _ev("cpu_op", "aten::mm", 200.0, 5.0),
    ]


def test_a_trace_reduces_to_busy_time_ops_and_idle_gaps_by_span():
    s = devtrace.reduce(_trace())
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((150 + 10 + 50) * 1e-6)
    assert s.ops["melspec_fft_kernel"] == [pytest.approx(150e-6), 2]
    assert s.events == 4
    idle = {k: v * 1e6 for k, v in s.idle.items()}
    assert idle["graph.scan_stream"] == pytest.approx(50 + 300)
    assert idle["outside any span"] == pytest.approx(100 + 50)
    assert idle["session.push"] == pytest.approx(100 + 150)
    assert idle["result.host_copy"] == pytest.approx(40)
    assert sum(idle.values()) == pytest.approx(1000 - 210)


def _readings(trace=None, units=0, samples=None, counts=None, workload="logmel-stream-2048"):
    bench = Bench()
    w = bench.workload(workload)
    return Readings(workload, bench.config(w["config"]), bench.traffic(w["traffic"]), "NVIDIA H100 80GB HBM3",
                    12.5, Window(samples or {}, 1, 0), trace, units, counts or {})


def test_readers_read_their_metrics_and_nothing_where_there_is_nothing():
    s = devtrace.reduce(_trace())
    r = _readings(s, units=4, samples={"audio_s": 300.0, "wall_s": 2.0, "chunk_in": 14112, "rows": 512,
                                       "chunk_latency_s": [0.001 * i for i in range(1, 101)],
                                       "decode_s": [0.02, 0.03]}, counts={"step_ops": 8})
    assert readers.rate(r) == 150.0
    assert readers.idle_pct(r) == pytest.approx(100 * (1 - 210 / 1000))
    assert readers.busy_ms_per_unit(r) == pytest.approx(210e-3 / 4)
    assert readers.step_ops(r) == 8
    assert readers.p95_ms(r, "chunk_latency_s") == pytest.approx(95.05)
    assert readers.mean_ms(r, "decode_s") == pytest.approx(25.0)
    from flowbench.reference import design

    fb = design.slaney_filterbank(1024, 128, 16000, 0.0, 8000.0)
    flops, nbytes = roofline.melspec_work(512, 5888, 1024, 256, 128, int(np.count_nonzero(fb.astype(np.float32))))
    least = roofline.least_seconds("NVIDIA H100 80GB HBM3", flops, nbytes)
    assert readers.melspec_roofline_pct(r) == pytest.approx(100 * least / 75e-6)
    empty = _readings()
    for fn in (readers.rate, readers.idle_pct, readers.busy_ms_per_unit, readers.step_ops,
               readers.melspec_roofline_pct):
        assert fn(empty) is None
    assert readers.p95_ms(empty, "chunk_latency_s") is None and readers.mean_ms(empty, "decode_s") is None


def test_every_metric_has_a_reader_that_reads_nothing_from_an_empty_run():
    bench = Bench()
    for m in bench.spec["end_to_end"] + bench.spec["per_layer"]:
        v = bench.reader(m["name"]).read(_readings())
        assert v is None or (m["name"] == "setup_s" and math.isfinite(v))
