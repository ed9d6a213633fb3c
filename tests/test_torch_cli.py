"""The port's CLI against the JAX package's on the CPU.

``run --device cpu`` must print the JAX CLI's JSON line: every field equal
except the times (wall, compile and the two realtime factors), and the
outputs within 5e-4 in log-mel space and 1e-5 in sample space (the graphs'
port tolerances, ``test_torch_master.py``), VAD states exactly and i16
after the resampler within 1 LSB.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from audioflow_tpu import models as jmodels
from audioflow_tpu.cli import main as jmain
from audioflow_tpu.config import graph_to_spec as j_graph_to_spec
from audioflow_torch.cli import main as tmain
from audioflow_torch.io import write_wav

TIMES = ("wall_seconds", "compile_seconds", "realtime_factor", "realtime_factor_per_chip")


def _files(tmp_path, rate, n=5, bad=True):
    rng = np.random.default_rng(rate + n)
    d = tmp_path / "in"
    d.mkdir(exist_ok=True)
    for i in range(n):
        off = bad and i == 3
        write_wav(d / f"f{i}.wav", (0.4 * rng.standard_normal(rate // 3 + 111 * i)).astype(np.float32),
                  22050 if off else rate)
    if bad:
        (d / "f1.wav").write_bytes(b"RIFF\x04\x00\x00\x00WAVE")
    return str(d / "*.wav")


def _run(main, capsys, args, out):
    capsys.readouterr()
    assert main(["run", *args, "-o", str(out), "--stats", str(out.parent / "stats.json")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line, np.load(out)


@pytest.mark.parametrize(
    "graph,rate,batch,tol",
    [("logmel", 44100, "2", 5e-4), ("master", 16000, "2", 1e-5), ("logmel", 44100, None, 5e-4),
     ("stft", 16000, None, 1e-5), ("vad", 16000, "2", 0), ("wire", 48000, None, 1)],
    ids=["logmel-batches", "master-batches", "logmel-whole", "stft-whole", "vad-batches", "wire-whole"],
)
def test_run_matches_jax_cli(tmp_path, capsys, graph, rate, batch, tol):
    inputs = _files(tmp_path, rate, bad=batch is not None)
    extra = ["--batch-size", batch] if batch else []
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tl, tout = _run(tmain, capsys, ["-i", inputs, "-g", graph, *extra, "--device", "cpu"], tmp_path / "t" / "o.npy")
    jl, jout = _run(jmain, capsys, ["-i", inputs, "-g", graph, *extra], tmp_path / "j" / "o.npy")
    assert set(tl) == set(jl)
    assert tl["output"].replace("/t/", "/j/") == jl["output"]
    for k in set(jl) - set(TIMES) - {"output"}:
        assert tl[k] == jl[k], k
    assert tl["files"] == 5 and tl["failed_files"] == (2 if batch else 0)
    assert tout.shape == jout.shape and np.isfinite(tout).all()
    if graph == "stft":  # magnitudes: relative to the peak
        assert np.abs(tout - jout).max() / np.abs(jout).max() < tol
    else:
        np.testing.assert_allclose(tout, jout, atol=tol, rtol=0)
    stats = json.loads((tmp_path / "t" / "stats.json").read_text())
    assert stats["run_count"] == 1 and stats["total_audio_seconds"] == tl["audio_seconds"]


def test_run_spec_from_jax_config5(tmp_path, capsys):
    inputs = _files(tmp_path, 44100)
    g = jmodels.log_mel_frontend(44100, 16000, 1024, 256, 128, eq=jmodels.eq_bands_default(16000))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dataclasses.asdict(j_graph_to_spec(g))))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    args = ["-i", inputs, "--spec", str(spec), "--batch-size", "3"]
    tl, tout = _run(tmain, capsys, [*args, "--device", "cpu"], tmp_path / "t" / "o.npy")
    jl, jout = _run(jmain, capsys, args, tmp_path / "j" / "o.npy")
    assert {k: tl[k] for k in ("files", "failed_files", "batches", "audio_seconds")} == {
        k: jl[k] for k in ("files", "failed_files", "batches", "audio_seconds")
    }
    np.testing.assert_allclose(tout, jout, atol=5e-4, rtol=0)


def test_run_refusals(tmp_path, capsys):
    inputs = _files(tmp_path, 16000, n=2, bad=False)
    with pytest.raises(SystemExit, match="not yet ported"):
        tmain(["run", "-i", inputs, "-g", "kws", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--sharded"):
        tmain(["run", "-i", inputs, "--sharded", "--device", "cpu"])
    if not torch.cuda.is_available():  # --device defaults to the card
        capsys.readouterr()
        assert tmain(["run", "-i", inputs, "-g", "stft", "--stats", str(tmp_path / "s.json")]) == 2
        assert "DEVICE_NOT_FOUND" in capsys.readouterr().err


def test_info_devices_config(tmp_path, capsys):
    assert tmain(["--precision", "high", "info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["name"] == "audioflow-torch" and info["torch"] == torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False  # "high" never means TF32
    assert tmain(["devices", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows and {"id", "platform", "kind", "process"} <= set(rows[0])
    f = tmp_path / "c.toml"
    assert tmain(["config", "set", "audio.n_mels", "64", "--file", str(f)]) == 0
    assert jmain(["config", "set", "audio.n_mels", "64", "--file", str(tmp_path / "j.toml")]) == 0
    assert f.read_text() == (tmp_path / "j.toml").read_text()
    capsys.readouterr()
    assert tmain(["config", "show", "--file", str(f)]) == 0
    assert json.loads(capsys.readouterr().out)["audio"]["n_mels"] == 64
    assert tmain(["config", "path", "--file", str(f)]) == 0
    assert capsys.readouterr().out.strip() == str(f)
