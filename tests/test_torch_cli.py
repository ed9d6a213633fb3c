"""The port's CLI against the JAX package's on the CPU.

``run --device cpu`` must print the JAX CLI's JSON line: every field equal
except the times (wall, compile and the two realtime factors), and the
outputs within 5e-4 in log-mel space and 1e-5 in sample space (the graphs'
port tolerances, ``test_torch_master.py``), VAD states exactly and i16
after the resampler within 1 LSB.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audioflow_tpu import models as jmodels
from audioflow_tpu.cli import main as jmain
from audioflow_tpu.config import graph_to_spec as j_graph_to_spec
from audioflow_torch.cli import main as tmain
from audioflow_torch.io import write_wav
from test_torch_decompose import _gate_decisions_agree, _voice
from logging_guard import restore_audioflow_logger  # noqa: F401  (autouse)
from thread_limits import one_blas_thread_per_module  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
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
    """An unknown graph is refused; every graph of the JAX CLI builds (the
    four last ported ones run in
    ``test_run_cqt_and_rhythm_graphs_match_jax_cli``); ``--sharded`` on a
    plain call runs a world of one gloo rank and writes exactly what ``run``
    writes, whole and in batches."""
    from audioflow_torch.cli import _GRAPHS, _build_graph
    from audioflow_torch.config import UserConfig

    inputs = _files(tmp_path, 16000, n=2, bad=False)
    capsys.readouterr()
    with pytest.raises(SystemExit):
        tmain(["run", "-i", inputs, "-g", "nosuchgraph", "--device", "cpu"])
    assert "invalid choice: 'nosuchgraph'" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="unknown graph 'nosuchgraph'"):
        _build_graph("nosuchgraph", 16000, UserConfig())
    assert len(_GRAPHS) == 18 and all(_build_graph(g, 16000, UserConfig()).nodes for g in _GRAPHS)
    import torch.distributed as dist

    for extra in ([], ["--batch-size", "2"]):
        outs = []
        for sharded in ([], ["--sharded"]):
            out = tmp_path / f"o{len(extra)}{len(sharded)}.npy"
            line, arr = _run(tmain, capsys, ["-i", inputs, "-g", "logmel", *extra, *sharded, "--device", "cpu"], out)
            assert line["n_devices"] == 1 and line["files"] == 2
            outs.append(arr)
        np.testing.assert_array_equal(outs[1], outs[0])
        assert not dist.is_initialized()  # the world the call made is gone
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


def _voice_files(tmp_path, n=2):
    """Float WAV files of a speech-like signal (tone bursts over a -45 dBFS
    floor), 1.024 s at 16 kHz: a whole number of the CLI's 1024-sample
    padding, so the graphs see the signal as written. Seed 2 keeps every
    bin's spectral-gate decision clear of fp32 differences between the
    packages (``test_run_new_graphs_match_jax_cli`` asserts it)."""
    x = _voice(seconds=16384 / 16000, lead=(n,), seed=2)
    d = tmp_path / "voice"
    d.mkdir()
    for i, row in enumerate(x):
        write_wav(d / f"v{i}.wav", row, 16000, bits=32)
    return str(d / "*.wav"), x


# the seven graphs of the mastering and feature families, each against the
# JAX CLI: log-mel and PCEN features within 5e-4 absolute (the run tests'
# log-mel tolerance above), the rest relative to the output's peak within
# the family tests' graph tolerances (test_torch_features.py,
# test_torch_decompose.py), spectral contrast within 0.02 dB
_NEW_GRAPHS = {"kws": ("abs", 5e-4), "deltafbank": ("abs", 5e-4), "denoise": ("rel", 2e-5),
               "features": ("rel", 2e-5), "chroma": ("rel", 2e-5), "contrast": ("abs", 0.02),
               "tonnetz": ("rel", 2e-5)}


@pytest.mark.parametrize("graph", sorted(_NEW_GRAPHS))
def test_run_new_graphs_match_jax_cli(tmp_path, capsys, graph):
    inputs, x = _voice_files(tmp_path)
    if graph == "denoise":  # no spectral-gate decision can flip between the packages
        assert _gate_decisions_agree(x, n_fft=1024, hop=256)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tl, tout = _run(tmain, capsys, ["-i", inputs, "-g", graph, "--device", "cpu"], tmp_path / "t" / "o.npy")
    jl, jout = _run(jmain, capsys, ["-i", inputs, "-g", graph], tmp_path / "j" / "o.npy")
    for k in set(jl) - set(TIMES) - {"output"}:
        assert tl[k] == jl[k], k
    assert tout.shape == jout.shape and np.isfinite(tout).all()
    kind, tol = _NEW_GRAPHS[graph]
    err = np.abs(tout - jout).max() / (np.abs(jout).max() if kind == "rel" else 1.0)
    assert err < tol, (graph, err)


def _tones(tmp_path, name="two_tones.wav", seconds=2.0, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t) * (t < seconds / 2) + 0.3 * np.sin(2 * np.pi * 660.0 * t)
         + 1e-3 * np.random.default_rng(7).standard_normal(t.size)).astype(np.float32)
    path = tmp_path / name
    write_wav(path, x, rate, bits=32)
    return path, x


def test_loudness_matches_jax_cli(tmp_path, capsys):
    """The meter's JSON against the JAX CLI's (its values rounded to 0.01,
    so within one step), and the normalized copy read back."""
    path, _ = _tones(tmp_path, seconds=4.0)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    capsys.readouterr()
    assert tmain(["loudness", str(path), "--normalize-to", "-20", "--out-dir", str(tmp_path / "t"),
                  "--device", "cpu"]) == 0
    tl = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jmain(["loudness", str(path), "--normalize-to", "-20", "--out-dir", str(tmp_path / "j")]) == 0
    jl = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(tl) == set(jl)
    for k, v in jl.items():
        if isinstance(v, float):
            assert abs(tl[k] - v) <= 0.0101, k
        elif k != "normalized":
            assert tl[k] == v, k
    assert abs(tl["normalized_lufs"] + 20.0) <= 0.02
    if not torch.cuda.is_available():  # --device defaults to the card
        assert tmain(["loudness", str(path)]) == 2


def test_separate_matches_jax_cli(tmp_path, capsys):
    """Two components that sum to the input (both CLIs' ``residual_rel``),
    each template peaking at one of the two tones. The initial factors come
    from another generator in each package, so the components are compared
    by what they separate, not sample by sample."""
    path, x = _tones(tmp_path)
    capsys.readouterr()
    args = ["separate", "-i", str(path), "-k", "2", "--iterations", "60"]
    assert tmain([*args, "-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    tl = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jmain([*args, "-o", str(tmp_path / "j")]) == 0
    jl = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(tl["components"]) == len(jl["components"]) == 2
    assert tl["residual_rel"] <= 1e-4 and jl["residual_rel"] <= 1e-4
    bin_hz = 16000 / 1024
    for peaks in (tl["template_peak_hz"], jl["template_peak_hz"]):
        assert sorted(round(p / bin_hz) for p in peaks) == [round(220 / bin_hz), round(660 / bin_hz)]
    from audioflow_torch.io import read_audio

    comps = [read_audio(p)[0] for p in tl["components"]]
    assert np.abs(sum(comps) - x).max() < 2e-4  # 16-bit components, summed


# every example spec through `run --spec`, against the JAX CLI on the same
# files at the spec's input rate: log-mel, MFCC and PCEN outputs within 5e-4
# absolute, the sample-domain chains within 2e-5 of the peak (the denoise
# chain's tolerance; the others' are tighter: test_torch_master.py,
# test_torch_effects.py)
_SPECS = {"asr_frontend_spec.json": ("abs", 5e-4), "denoise_master_spec.json": ("rel", 2e-5),
          "echo_ensemble_spec.json": ("abs", 2e-4), "eq_master_spec.json": ("rel", 2e-5),
          "kws_pcen_spec.json": ("abs", 5e-4), "logmel_spec.json": ("abs", 5e-4), "mfcc_spec.json": ("abs", 5e-4)}


@pytest.mark.parametrize("name", sorted(_SPECS))
def test_run_spec_examples_match_jax_cli(tmp_path, capsys, name):
    spec = ROOT / "examples" / name
    rate = json.loads(spec.read_text())["input_rate"]
    x = _voice(seconds=16384 / 16000, lead=(2,), seed=2)
    for i, row in enumerate(x):
        write_wav(tmp_path / f"v{i}.wav", row, rate, bits=32)
    if name == "denoise_master_spec.json":
        assert _gate_decisions_agree(x, n_fft=1024, hop=256)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    args = ["-i", str(tmp_path / "v*.wav"), "--spec", str(spec)]
    tl, tout = _run(tmain, capsys, [*args, "--device", "cpu"], tmp_path / "t" / "o.npy")
    jl, jout = _run(jmain, capsys, args, tmp_path / "j" / "o.npy")
    assert (tl["files"], tl["failed_files"]) == (jl["files"], jl["failed_files"]) == (2, 0)
    assert tout.shape == jout.shape and np.isfinite(tout).all()
    kind, tol = _SPECS[name]
    err = np.abs(tout - jout).max() / (np.abs(jout).max() if kind == "rel" else 1.0)
    assert err < tol, (name, err)


def _cqt_rhythm_files(tmp_path, graph):
    """Two 16 kHz files for the CQT and rhythm graphs. The CQT graphs get a
    110 Hz tone (CQT bin 21, under the hybrid inverse's painless cliff, so
    that its sinusoidal branch finds no peak: no decision of the hybrid
    inverse is taken) and a 98 Hz tone, 1 s; the rhythm graphs click tracks
    at 96 and 132 BPM, 6 s. Returns the glob and the rows as the CLI pads
    them (to a multiple of 1024 samples)."""
    from test_torch_rhythm import _click_audio

    if graph in ("onset", "beats"):
        x = _click_audio((96.0, 132.0), 6.0)
    else:
        t = np.arange(16000) / 16000
        x = np.stack([0.5 * np.sin(2 * np.pi * 110.0 * t), 0.4 * np.sin(2 * np.pi * 98.0 * t)]).astype(np.float32)
    d = tmp_path / "in"
    d.mkdir()
    for i, row in enumerate(x):
        write_wav(d / f"c{i}.wav", row, 16000, bits=32)
    return str(d / "*.wav"), np.pad(x, ((0, 0), (0, -x.shape[-1] % 1024)))


# the CQT and rhythm graphs against the JAX CLI, of the output's peak: the
# CQT magnitudes within test_torch_cqt.py's FWD_TOL, the inverses within its
# INV_TOL, the onset envelope within test_torch_rhythm.py's GRAPH_TOL; the
# beat masks exactly, after test_torch_rhythm.py's margin check
_CQT_RHYTHM = {("cqt", False): 1e-5, ("cqtroundtrip", False): 2e-5, ("cqtroundtrip", True): 2e-5,
               ("onset", False): 2e-5, ("beats", False): 0.0}


@pytest.mark.parametrize("graph,multirate", sorted(_CQT_RHYTHM), ids=lambda v: str(v))
def test_run_cqt_and_rhythm_graphs_match_jax_cli(tmp_path, capsys, graph, multirate):
    import torch as _torch

    from audioflow_torch import models as tmodels
    from audioflow_torch import ops as tops

    inputs, x = _cqt_rhythm_files(tmp_path, graph)
    if graph == "beats":
        from decision_margins import dp_margins_clear

        dp_margins_clear(tmodels.onset_frontend(16000).chain(_torch.from_numpy(x))[..., 0])
    if graph == "cqtroundtrip" and not multirate:
        from decision_margins import hybrid_decisions_clear

        margins = hybrid_decisions_clear(tops.cqt(_torch.from_numpy(x), 16000, output="complex"))
        assert margins["components"] == 0  # no sinusoid estimate is synthesized
    extra = ["--multirate"] if multirate else []
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tl, tout = _run(tmain, capsys, ["-i", inputs, "-g", graph, *extra, "--device", "cpu"], tmp_path / "t" / "o.npy")
    jl, jout = _run(jmain, capsys, ["-i", inputs, "-g", graph, *extra], tmp_path / "j" / "o.npy")
    for k in set(jl) - set(TIMES) - {"output"}:
        assert tl[k] == jl[k], k
    assert tout.shape == jout.shape and np.isfinite(tout).all()
    if graph == "beats":
        assert np.array_equal(tout, jout) and tout.sum() > 10
    else:
        err = np.abs(tout - jout).max() / np.abs(jout).max()
        assert err < _CQT_RHYTHM[graph, multirate], (graph, err)
