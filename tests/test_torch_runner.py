"""The port's batch runner against the JAX package's on the CPU.

Seven short files in batches of three (a tail batch of one), one of them
corrupt and one at another rate than the graph's: the sinks' outputs must
agree within the graph's port tolerance (5e-4 in log-mel space, 1e-5 in
sample space, as ``test_torch_master.py``), and the ``RunMetrics`` counts
(files, failed_files, audio_seconds, batches) must be equal.
"""

import numpy as np
import pytest
import torch

from audioflow_tpu import models as jmodels
from audioflow_tpu.io import BatchLoader as JLoader
from audioflow_tpu.runner import run_batches as j_run_batches
from audioflow_tpu.sinks import ArraySink as JArraySink
from audioflow_torch import models as tmodels
from audioflow_torch import runner
from audioflow_torch.errors import AudioError, ConfigError
from audioflow_torch.io import BatchLoader, write_wav
from audioflow_torch.sinks import ArraySink

GRAPHS = {  # name: (port graph, JAX graph, input rate, tolerance)
    "logmel": (lambda: tmodels.log_mel_frontend(44100), lambda: jmodels.log_mel_frontend(44100), 44100, 5e-4),
    "master": (lambda: tmodels.master_chain_graph(16000), lambda: jmodels.master_chain_graph(16000), 16000, 1e-5),
}


def _files(tmp_path, rate, growing=False):
    """Seven files; #2 is corrupt and #4 is at another rate. With
    ``growing`` the later files are longer than the first batch's."""
    rng = np.random.default_rng(rate)
    paths = []
    for i in range(7):
        n = rate // 4 + (700 * i if growing else 37 * i)
        p = tmp_path / f"f{i}.wav"
        write_wav(p, (0.4 * rng.standard_normal(n)).astype(np.float32), rate if i != 4 else 22050)
        paths.append(str(p))
    (tmp_path / "f2.wav").write_bytes(b"RIFF\x24\x00\x00\x00WAVEfmt garbage")
    return paths


@pytest.mark.parametrize("stride", ["fixed", None])
@pytest.mark.parametrize("name", ["logmel", "master"])
def test_run_batches_matches_jax(tmp_path, name, stride):
    make_t, make_j, rate, tol = GRAPHS[name]
    files = _files(tmp_path, rate, growing=stride is None)
    s = 1024 * (-(-(rate // 4 + 4200) // 1024)) if stride else None
    ts, js = ArraySink(), JArraySink()
    tm = runner.run_batches(make_t(), BatchLoader(files, 3, stride=s), sinks=[ts], device="cpu")
    jm = j_run_batches(make_j(), JLoader(files, 3, stride=s, use_native=False), sinks=[js])
    for k in ("files", "failed_files", "audio_seconds", "batches"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert (tm.files, tm.failed_files, tm.batches) == (7, 2, 3)
    got, want = ts.result(), js.result()
    assert got.shape == want.shape and got.shape[0] == 5 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert tm.compile_seconds > 0 and tm.wall_seconds > 0
    assert set(tm.to_dict()) == set(jm.to_dict())


def test_run_batch_masks_failed_and_off_rate_lanes(tmp_path):
    files = _files(tmp_path, 44100)
    g = tmodels.log_mel_frontend(44100)
    batch = next(iter(BatchLoader(files[2:5], 3, stride=12288)))
    assert list(batch.valid) == [False, True, True]
    out = runner.run_batch(g, batch, 12288, 4, 44100, torch.device("cpu"))
    assert out.shape[0] == 3 and list(batch.valid) == [False, True, False]
    assert not out[0].any() and not out[2].any() and out[1].abs().min() > 0
    offline = g.compile()(torch.from_numpy(batch.samples[1:2]))
    np.testing.assert_allclose(out[1:2].numpy(), offline.numpy(), atol=5e-4, rtol=0)


def test_run_batches_errors(tmp_path):
    """The errors, and ``mesh=``'s working path: in a world of one gloo
    rank the sharded runner writes exactly what the unsharded one writes
    (a 2-D mesh is refused)."""
    import torch.distributed as dist

    from audioflow_torch import parallel

    g = tmodels.master_chain_graph(16000)
    files = _files(tmp_path, 16000)
    assert parallel.multihost_init(num_processes=1, backend="gloo", timeout=60) is True
    try:
        mesh = parallel.make_mesh(devices="cpu")
        sharded, plain = ArraySink(), ArraySink()
        ms = runner.run_batches(g, BatchLoader(files, 3, stride=8192), sinks=[sharded], mesh=mesh)
        mp = runner.run_batches(g, BatchLoader(files, 3, stride=8192), sinks=[plain], device="cpu")
        assert ms.n_devices == 1 and (ms.files, ms.failed_files, ms.batches) == (mp.files, mp.failed_files, 3)
        assert ms.audio_seconds == mp.audio_seconds
        np.testing.assert_array_equal(sharded.result(), plain.result())
        with pytest.raises(ConfigError):
            runner.run_batches(g, BatchLoader(files, 3), mesh=parallel.make_mesh(
                axes=("data", "model"), shape=(1, 1), devices="cpu"))
    finally:
        dist.destroy_process_group()
    with pytest.raises(AudioError) as e:
        runner.run_batches(g, BatchLoader([], 2), device="cpu")
    assert e.value.code.value == "FILE_NOT_FOUND"
    if not torch.cuda.is_available():
        with pytest.raises(AudioError) as e:
            runner.run_batches(g, BatchLoader([], 2))  # the card is the default
        assert e.value.code.value == "DEVICE_NOT_FOUND"


def test_obs_like_jax(tmp_path, monkeypatch):
    from audioflow_tpu import obs as jobs
    from audioflow_torch import obs as tobs

    tm, jm = tobs.RunMetrics(2.0, 0.5, 1, 3, 1, 0.1, 1), jobs.RunMetrics(2.0, 0.5, 1, 3, 1, 0.1, 1)
    assert tm.to_dict() == jm.to_dict() and tm.realtime_factor == 4.0
    for m, d in ((tobs, "t"), (jobs, "j")):
        st = m.StatsFile(tmp_path / d / "stats.json")
        st.record_run(12.5)
        st.data["last_used"] = "fixed"
        st.save()
    assert (tmp_path / "t" / "stats.json").read_bytes() == (tmp_path / "j" / "stats.json").read_bytes()
    assert tobs.StatsFile(tmp_path / "j" / "stats.json").data["total_audio_seconds"] == 12.5
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg-config"))
    assert tobs.default_stats_path() == jobs.default_stats_path()
    with tobs.LifecycleManager(tobs.AppDirs()) as life:
        done = []
        life.register_cleanup("a", lambda: done.append("a"))
        life.register_cleanup("b", lambda: done.append("b"))
    assert done == ["b", "a"] and life.phase is tobs.AppPhase.EXITED
    assert life.stats.data["launch_count"] == 1
    with tobs.Timer() as t:
        pass
    assert t.elapsed >= 0
    x = torch.ones(4, 16)
    m = tobs.measure_throughput(lambda v: v * 2, x, audio_seconds=1.5, iters=3)
    assert (m.audio_seconds, m.batches) == (4.5, 3) and m.wall_seconds > 0
    tobs.sync((x, x))  # nothing to wait for on the CPU
    assert tobs.get_logger("runner").name == jobs.get_logger("runner").name == "audioflow.runner"
