"""The port's bench against the JAX package's on the CPU.

Every case but ``roofline`` is held against the JAX function built as
``audioflow_tpu/bench.py`` builds it, on the same seeded tone batch at
batch 2 (1 s clips; config 2 at 1.6 s, past the 65,536 samples where
``compile()`` streams in chunks, as at its 10 s). Tolerances are those of
the port's tests of each path: 5e-4 in log-mel space
(``test_torch_graph.py``), 1e-5 in sample space for config 3 and 5e-4 for
config 5 (``test_torch_master.py``; config 5 on the tone batch at the JAX
package's own gate between two log-mel forms, 5e-3, ``validate.py:423``:
the EQ's high-pass leaves the lowest mel bin about 14 nats below the
frame's peak, where fp32 sums in another order part by 1.7e-3, while
``test_torch_master.py``'s white noise keeps every bin high), 2e-3 of the peak for the time-stretch
matmul path (``test_torch_phase_vocoder.py``) and 1e-5 of the peak for STFT
magnitudes (``test_torch_cli.py``). The streamed log-mel cases
(``logmel_stream``, ``session``) are compared from the stream's latency on:
the port's frontend is the fused ``LogMelSpec`` (a ROADMAP departure), whose
preroll frames differ from the JAX bench's two-node form. Rows and the CLI's output carry the JAX
keys, but ``achieved_gbps``: the port has no byte count
(``bytes_accessed`` -1.0), so it adds no bandwidth column.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as W
from audioflow_tpu import bench as jbench
from audioflow_tpu import graph as jgraph
from audioflow_tpu import models as jmodels
from audioflow_tpu import ops as jops
from audioflow_tpu.cli import main as jmain
from audioflow_torch import bench as tbench
from audioflow_torch.cli import main as tmain
from audioflow_torch.obs import profile_trace
from audioflow_torch.parallel._worlds import run_world
from logging_guard import restore_audioflow_logger  # noqa: F401  (autouse)
from thread_limits import one_blas_thread_per_module, two_torch_threads_per_module  # noqa: F401  (autouse)

BATCH = 2
SECONDS = {"logmel": 1.6}  # others 1.0
# the fewest whole 8-chunk blocks session_drain times (one warm, one timed):
# 2 x 8 x 14,112 samples at 44.1 kHz
SESSION_SECONDS = 5.2
# (tolerance, relative to the peak?) of each case's output
TOL = {
    "stft": (1e-5, True), "logmel": (5e-4, False), "logmel_stream": (5e-4, False), "master": (1e-5, False),
    "pvoc": (2e-3, True), "pitch": (2e-3, True), "streaming": (5e-3, False), "session": (5e-4, False),
}
# the JAX roofline row's keys (audioflow_tpu/bench.py:186-192); the JAX row
# itself, 8192^3 on a CPU, is too slow for a test
ROOFLINE_KEYS = {"benchmark", "hbm_gbps", "mxu_tflops_bf16", "triad_ms", "matmul_ms", "compile_seconds"}
NO_BYTES = {"achieved_gbps"}
TIMES = ("wall_seconds", "compile_seconds", "realtime_factor", "realtime_factor_per_chip", "achieved_tflops",
         "latency_ms_p50", "latency_ms_p99", "latency_x_realtime_p50")
BENCH_ARGS = ["bench", "stft", "--batch", "2", "--seconds", "0.5"]


@pytest.fixture(scope="module", autouse=True)
def world2():
    """``bench stft --sharded`` in a gloo world of two CPU ranks, spawned
    once for the module while its other tests run."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_world, W.bench_cli, 2, ([*BENCH_ARGS, "--sharded", "--device", "cpu"],), timeout=240)


def _jax_fn(name, x):
    """The JAX case as ``audioflow_tpu/bench.py`` builds it, and the input
    it takes (the batch trimmed to whole chunks where it streams)."""
    if name == "stft":
        return jmodels.stft_magnitude_graph(16000, 1024, 256).compile(), x
    if name == "logmel":
        return jmodels.log_mel_frontend(44100, 16000, 1024, 256, 128).compile(), x
    if name == "master":
        return jmodels.master_chain_graph(16000).compile(), x
    if name == "pvoc":
        return jax.jit(lambda z: jops.time_stretch(z, 1.25, 1024, 256)), x
    if name == "pitch":
        return jax.jit(lambda z: jops.pitch_shift(z, 12.0, 16000, 1024, 256)), x
    if name == "logmel_stream":
        g = jmodels.log_mel_frontend(44100, 16000, 1024, 256, 128, center=False)
    else:
        g = jgraph.chain(
            jgraph.Resample(44100, 16000, "kaiser"), jgraph.BiquadChain(jmodels.eq_bands_default(16000.0)),
            jgraph.Spectrogram(1024, 256, center=False), jgraph.MelProject(n_mels=128), input_rate=44100,
        )
    gran = g.chunk_granularity()
    chunk = gran * max(1, 16384 // gran)
    return jax.jit(lambda b: g.scan_stream(b, chunk)), x[:, : x.shape[-1] // chunk * chunk]


def _session_outputs(sess, x, chunk):
    """The session's per-chunk results over ``x`` pushed a chunk at a time, in stream order."""
    with sess:
        for i in range(0, x.shape[-1] // chunk * chunk, chunk):
            sess.push(x[:, i : i + chunk])
        return np.concatenate([np.asarray(r.data) for r in sess.poll_all()], axis=-2)


@pytest.mark.parametrize("name", sorted(TOL))
def test_case_matches_jax(name):
    seconds = SECONDS.get(name, 1.0)
    fn, x, audio = tbench._case(name, BATCH, seconds)
    rate = 16000 if name in ("stft", "master", "pvoc", "pitch") else 44100
    full = jbench._tone_batch(BATCH, seconds, rate)
    if name == "session":
        from audioflow_tpu.session import StreamSession as JSession
        from audioflow_torch.session import StreamSession as TSession

        assert np.array_equal(x, full) and audio == BATCH * seconds
        chunk = tbench._chunk(fn)
        j = jmodels.log_mel_frontend(44100, 16000, 1024, 256, 128)
        assert chunk == 14112 == j.chunk_granularity() * max(1, 16384 // j.chunk_granularity())
        got = _session_outputs(TSession(fn, chunk_in=chunk, lead_shape=(BATCH,), device="cpu"), x, chunk)
        want = _session_outputs(JSession(j, chunk_in=chunk, lead_shape=(BATCH,)), x, chunk)
    else:
        jfn, jx = _jax_fn(name, full)
        assert np.array_equal(x, jx), "the port's case takes the JAX bench's input"
        assert audio == pytest.approx(BATCH * x.shape[-1] / rate)
        xt = torch.from_numpy(np.ascontiguousarray(x))
        got = (fn.compile()(xt) if hasattr(fn, "compile") else fn(xt)).numpy()
        want = np.asarray(jfn(jnp.asarray(x)))
    tol, rel = TOL[name]
    assert got.shape == want.shape and np.isfinite(got).all(), (got.shape, want.shape)
    if name in ("logmel_stream", "session"):  # past the fused frontend's preroll
        lat = jmodels.log_mel_frontend(44100, 16000, 1024, 256, 128, center=False).stream_latency(14112)
        got, want = got[:, lat:], want[:, lat:]
    err = np.abs(got - want).max() / (np.abs(want).max() if rel else 1.0)
    assert err < tol, (name, err)


@pytest.mark.parametrize("name,seconds", [("stft", 0.5), ("pvoc", 0.5), ("session", SESSION_SECONDS)])
def test_rows_have_the_jax_keys(name, seconds):
    got = tbench.run_benchmark(name, batch=BATCH, seconds=seconds, device="cpu")
    want = jbench.run_benchmark(name, batch=BATCH, seconds=seconds)
    assert set(got) == set(want) - NO_BYTES
    for k in set(want) - set(TIMES) - NO_BYTES - {"flops", "bytes_accessed"}:
        assert got[k] == want[k], k
    assert got["n_devices"] == 1 and got["batches"] == want["batches"]
    assert all(np.isfinite(got[k]) and got[k] > 0 for k in set(TIMES) & set(got) - {"compile_seconds"}), got
    if "flops" in got:
        assert got["flops"] > 0 and got["bytes_accessed"] == -1.0
    if name == "session":  # the drained form times 8-chunk blocks, with the same keys
        drain = tbench.run_benchmark("session_drain", batch=BATCH, seconds=seconds, device="cpu")
        assert set(drain) == set(got) and drain["batches"] == 8


def test_roofline_row(monkeypatch):
    """The calibration row's keys, and the JAX row's arithmetic from its
    times (rounded as the JAX row rounds them), at shrunk sizes."""
    n, k = 1 << 18, 128
    monkeypatch.setattr(tbench, "ROOFLINE_ELEMENTS", n)
    monkeypatch.setattr(tbench, "ROOFLINE_K", k)
    row = tbench.run_benchmark("roofline", device="cpu")
    assert set(row) == ROOFLINE_KEYS and row["benchmark"] == "roofline"
    assert row["triad_ms"] > 0 and row["matmul_ms"] > 0, row
    assert row["hbm_gbps"] == pytest.approx(3 * n * 4 / (row["triad_ms"] / 1e3) / 1e9, rel=1e-2, abs=0.1)
    assert row["mxu_tflops_bf16"] == pytest.approx(2 * k**3 / (row["matmul_ms"] / 1e3) / 1e12, rel=1e-2, abs=0.1)


def test_unknown_name_raises_the_jax_error():
    with pytest.raises(ValueError) as want:
        jbench.run_benchmark("nosuchcase")
    with pytest.raises(ValueError) as got:
        tbench.run_benchmark("nosuchcase", device="cpu")
    assert str(got.value) == str(want.value) == "unknown benchmark 'nosuchcase'"


def test_cli_bench_matches_jax_cli(tmp_path, capsys):
    capsys.readouterr()
    assert tmain([*BENCH_ARGS, "--device", "cpu", "--report", str(tmp_path / "t.md"),
                  "--profile-dir", str(tmp_path / "d")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jmain([*BENCH_ARGS, "--report", str(tmp_path / "j.md")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) - NO_BYTES
    t_lines, j_lines = ((tmp_path / f).read_text().splitlines() for f in ("t.md", "j.md"))
    assert len(t_lines) == len(j_lines) == 5 and t_lines[:4] == j_lines[:4]
    assert t_lines[4].split(" | ")[:3] == j_lines[4].split(" | ")[:3] == ["| stft", "2", "0.5"]
    traces = list((tmp_path / "d").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    # without a card, the default device is refused
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, "is_available", lambda: False)
    try:
        capsys.readouterr()
        assert tmain(BENCH_ARGS) == 2
        assert "DEVICE_NOT_FOUND" in capsys.readouterr().err
    finally:
        monkey.undo()


def test_profile_trace_without_a_dir_traces_nothing(tmp_path):
    for log_dir in ("", None):
        with profile_trace(log_dir):
            assert not torch._C._autograd._profiler_enabled()
    with profile_trace(str(tmp_path)):
        assert torch._C._autograd._profiler_enabled()
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1


@pytest.mark.parametrize("n", [1, 2])
def test_sharded_bench_counts_the_world(world2, capsys, n):
    import torch.distributed as dist

    if n == 1:  # a plain call: a world of one gloo rank in this process
        capsys.readouterr()
        assert tmain([*BENCH_ARGS, "--sharded", "--device", "cpu"]) == 0
        rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
        assert not dist.is_initialized()  # the world the call made is gone
    else:
        (rc0, out0), (rc1, out1) = world2.result()
        assert rc0 == rc1 == 0 and out1 == []  # rank 0 prints
        rows = [json.loads(line) for line in out0]
    assert len(rows) == 1 and rows[0]["n_devices"] == n and rows[0]["benchmark"] == "stft"
    assert rows[0]["realtime_factor_per_chip"] == pytest.approx(rows[0]["realtime_factor"] / n)
