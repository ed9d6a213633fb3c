"""The port's ``stream``, ``vad``, ``key`` and ``egress`` subcommands against
the JAX package's CLI on the CPU: the same JSON, outputs within the graphs'
tolerances (VAD states exactly, i16 within 1 LSB after a resampler, log-mel
5e-4 from the stream's latency on: the JAX CLI's log-mel graph is the
unfused Spectrogram + MelProject pair, whose preroll frames are floored
where the port's fused node computes them), and egress against the loopback
server of ``ws_loopback.py``."""

import json

import numpy as np
import pytest

from audioflow_tpu.cli import main as jmain
from audioflow_torch.cli import main as tmain
from audioflow_torch.io import write_wav
from ws_loopback import ScribeServer
from logging_guard import restore_audioflow_logger  # noqa: F401  (autouse)


def _speech(seconds, rate, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 1e-4 * rng.standard_normal(n)
    for a, b in ((0.3, 0.9), (1.4, 2.0)):
        sl = slice(int(a * rate), min(n, int(b * rate)))
        x[sl] += 0.3 * np.sin(2 * np.pi * 310 * t[sl]) + 0.05 * rng.standard_normal(sl.stop - sl.start)
    return x.astype(np.float32)


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


@pytest.fixture(scope="module")
def wav16(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "say16.wav"
    write_wav(p, _speech(3.0, 16000), 16000)
    return p


@pytest.mark.parametrize("graph", ["vad", "wire", "logmel"])
def test_stream_matches_jax_cli(tmp_path, capsys, graph):
    rate = 48000 if graph == "wire" else 16000 if graph == "vad" else 44100
    wav = tmp_path / "in.wav"
    write_wav(wav, _speech(2.5, rate, seed=1), rate)
    capsys.readouterr()
    assert tmain(["stream", "-i", str(wav), "-g", graph, "-o", str(tmp_path / "t.npy"), "--device", "cpu"]) == 0
    (tl,) = _json_lines(capsys)
    assert jmain(["stream", "-i", str(wav), "-g", graph, "-o", str(tmp_path / "j.npy")]) == 0
    (jl,) = _json_lines(capsys)
    assert tl.pop("output").endswith("t.npy") and jl.pop("output").endswith("j.npy")
    assert tl == jl
    got, want = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert got.shape == want.shape and got.dtype == want.dtype
    if graph == "vad":
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) == {0, 1, 2}
    elif graph == "wire":
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    else:
        np.testing.assert_allclose(got[tl["latency"]:], want[tl["latency"]:], atol=5e-4)


@pytest.mark.parametrize("args", [[], ["--level", "relaxed"], ["--threshold-db", "-30"]])
def test_vad_matches_jax_cli(capsys, wav16, args):
    capsys.readouterr()
    assert tmain(["vad", "-i", str(wav16), *args, "--device", "cpu"]) == 0
    assert jmain(["vad", "-i", str(wav16), *args]) == 0
    tl, jl = _json_lines(capsys)
    assert tl == jl and tl["speech_segments"]


def test_key_matches_jax_cli(tmp_path, capsys):
    outs = []
    for main, name in ((tmain, "t.json"), (jmain, "j.json")):
        f = str(tmp_path / name)
        capsys.readouterr()
        assert main(["key", "set", "elevenlabs", "sk-42", "--file", f]) == 0
        assert main(["key", "get", "elevenlabs", "--file", f]) == 0
        assert main(["key", "delete", "elevenlabs", "--file", f]) == 0
        outs.append(capsys.readouterr().out.replace(name, "<file>"))
    assert outs[0] == outs[1] and "sk-42" in outs[0]


@pytest.mark.parametrize("rate", [16000, 48000])
def test_egress_matches_jax_cli_over_loopback(tmp_path, capsys, rate):
    """--vad-gate at 16 kHz (no resampler: the wire samples are exact) and at
    48 kHz (the cubic resampler: within 1 LSB)."""
    wav = tmp_path / "say.wav"
    write_wav(wav, _speech(2.5, rate, seed=2), rate)
    runs = []
    for main, extra in ((tmain, ["--device", "cpu"]), (jmain, [])):
        srv = ScribeServer([{"reply": True}])
        srv.start()
        capsys.readouterr()
        assert main(["egress", "-i", str(wav), "--url", f"ws://127.0.0.1:{srv.port}/v1/scribe", "--api-key",
                     "sk-cli", "--vad-gate", "--receive-timeout", "3.0", *extra]) == 0
        srv.join(5)
        lines = _json_lines(capsys)
        runs.append((lines, srv))
    (t_lines, t_srv), (j_lines, j_srv) = runs
    strip = [{k: v for k, v in line.items() if k != "timestamp"} for line in t_lines]
    assert strip == [{k: v for k, v in line.items() if k != "timestamp"} for line in j_lines]
    assert strip[-1] == {"chunks_sent": 13, "results": 2}
    assert [line.get("text") for line in strip[:-1]] == ["turn", "turn it on"]
    assert t_srv.configures == j_srv.configures == 1 and "xi_api_key=sk-cli" in t_srv.request_lines[0]
    got, want = np.concatenate(t_srv.audio[0]), np.concatenate(j_srv.audio[0])
    assert got.shape == want.shape == (40000,)
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() == 0 if rate == 16000 else d.max() <= 1
    assert (got == 0).any() and (got != 0).any()  # the gate muted the silences only
