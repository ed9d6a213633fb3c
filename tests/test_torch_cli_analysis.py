"""The port's analysis commands (``pitch`` by its three methods, ``align``,
``segments``, ``inspect``) and the example twins
(``examples/batch_features_torch.py``, ``examples/streaming_session_torch.py``)
against the JAX package's on the CPU, on short seeded files.

The JSON keys, frame counts and times are equal. Values the CLIs round
(f0 to 0.01 Hz, aperiodicity to 0.001) are equal within one rounding step
(the packages' fp32 differences can cross a rounding boundary), and where
the packages' measured differences say more, within those: the alignment
cost and the novelty peak. Discrete results are compared where their
decisions are clear, as each op's test does (``tests/decision_margins.py``):
the DTW path and the boundaries. ``inspect`` reports what each package
counts (XLA's cost analysis there, ``Graph.inspect``'s counts here): the
keys are equal, the port's flops and launches positive, and its bytes -1.0,
the JAX value where a backend has no analysis. The example twins: log-mel
within 5e-4 (the slice's tolerance), the wire chunks' i16 within 1 LSB, the
same number of messages.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import ops as jops
from audioflow_tpu import session as jsession
from audioflow_tpu.cli import main as jmain
from audioflow_torch import ops as tops
from audioflow_torch.cli import main as tmain
from audioflow_torch.io import write_wav
from audioflow_torch.sinks import wire
from decision_margins import dtw_path_margin, peak_pick_margins
from logging_guard import restore_audioflow_logger  # noqa: F401  (autouse)
from thread_limits import one_blas_thread_per_module, two_torch_threads_per_module  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ALIGN_TOL = 1e-4  # the accumulated costs' difference, of the final cost: the features' fp32 differences


def _json(main, capsys, args):
    capsys.readouterr()
    assert main(args) == 0, args
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _both(capsys, args):
    return _json(tmain, capsys, [*args, "--device", "cpu"]), _json(jmain, capsys, args)


def _vibrato(rate, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    x = (0.4 * np.sin(2 * np.pi * np.cumsum(220 + 30 * np.sin(2 * np.pi * 2.0 * t)) / rate)).astype(np.float32)
    x += 0.005 * rng.standard_normal(x.shape).astype(np.float32)
    gap = slice(int(0.45 * len(x)), int(0.55 * len(x)))
    x[gap] = 0.001 * rng.standard_normal(gap.stop - gap.start).astype(np.float32)
    return x


def _close(got, want, step):
    return got is None and want is None or got is not None and want is not None and abs(got - want) <= step * 1.01


def _features(o, sig, rate, n_fft, hop, feature="mfcc"):
    """The CLI's features (``align``, ``segments``) in either package."""
    x = jnp.asarray(sig) if o is jops else torch.from_numpy(sig)
    lm = o.log_mel(o.power(o.spectrogram(x, n_fft, hop)), o.mel_filterbank(n_fft // 2 + 1, 64, rate))
    return o.mfcc(lm, 13) if feature == "mfcc" else lm


@pytest.mark.parametrize("method", ["yin", "pyin", "pyin-online"])
def test_pitch_matches_jax_cli(tmp_path, capsys, method):
    rate = 44100  # a 51-tap pYIN band at 44.1 kHz: the JAX scan compiles in seconds
    path = tmp_path / "v.wav"
    write_wav(path, _vibrato(rate, 0.7), rate, bits=32)
    args = ["pitch", "-i", str(path), "--method", method, "--fmin", "100", "--fmax", "800"]
    if method == "pyin-online":
        args += ["--lag", "12"]
    tl, jl = _both(capsys, args)
    assert set(tl) == set(jl) and tl["frames"] == jl["frames"] == len(jl["track"]) > 90
    assert tl["voiced_fraction"] == jl["voiced_fraction"] and 0.5 < jl["voiced_fraction"] < 1.0
    assert _close(tl["median_f0_hz"], jl["median_f0_hz"], 0.01)
    for a, b in zip(tl["track"], jl["track"]):
        assert a["t"] == b["t"] and _close(a["f0_hz"], b["f0_hz"], 0.01), (a, b)
        assert _close(a["aperiodicity"], b["aperiodicity"], 0.001), (a, b)
    if method == "pyin-online":  # half a frame later: the uncentered frames' timeline
        assert jl["track"][0]["t"] == round(2048 / (2 * rate), 4)


def test_pitch_online_empty_track(tmp_path, capsys):
    """A file shorter than ``lag`` frames emits nothing, and the empty track
    prints what the JAX CLI's guards print (``audioflow_tpu/cli.py:585-596``):
    0.0 and null, not NaN."""
    path = tmp_path / "s.wav"
    write_wav(path, _vibrato(8000, 0.5), 8000, bits=32)
    args = ["pitch", "-i", str(path), "--method", "pyin-online", "--fmin", "100", "--fmax", "400",
            "--frame-length", "512", "--hop", "128", "--lag", "40", "--device", "cpu"]
    assert _json(tmain, capsys, args) == {"frames": 0, "voiced_fraction": 0.0, "median_f0_hz": None, "track": []}


@pytest.mark.parametrize("feature", ["mfcc", "logmel"])
def test_align_matches_jax_cli(tmp_path, capsys, feature):
    """The CLI's default cosine cost; the euclidean one is held at the op
    (``tests/test_torch_sequence.py``): its Gram form cancels on MFCC frames
    (|x|^2 reaches 1e5, an fp32 spacing of 8e-3 under the square root), so
    the packages' paths part at near ties."""
    rate = 16000
    x = _vibrato(rate, 1.5, seed=1)
    y = np.concatenate([x[: rate // 2], x[rate // 2 : rate : 2], x[rate:]])  # the middle at double speed
    for name, sig in (("a", x), ("b", y)):
        write_wav(tmp_path / f"{name}.wav", sig, rate, bits=32)
    # the path's step choices clear of the two packages' accumulated costs
    jacc, jpath = jops.dtw(*(_features(jops, s, rate, 1024, 256, feature) for s in (x, y)), metric="cosine")
    tacc, _ = tops.dtw(*(_features(tops, s, rate, 1024, 256, feature) for s in (x, y)), metric="cosine",
                       device="cpu")
    jacc = np.asarray(jacc)
    diff = float(np.abs(tacc.numpy() - jacc).max())
    assert diff <= ALIGN_TOL * jacc[-1, -1] and dtw_path_margin(jacc, jpath) > 2 * diff
    args = ["align", "-a", str(tmp_path / "a.wav"), "-b", str(tmp_path / "b.wav"), "--feature", feature]
    tl, jl = _both(capsys, args)
    assert set(tl) == set(jl)
    for k in ("frames_a", "frames_b", "path_len", "anchors"):
        assert tl[k] == jl[k], k
    assert abs(tl["cost"] - jl["cost"]) <= diff + 0.001
    assert abs(tl["cost_per_step"] - jl["cost_per_step"]) <= diff / jl["path_len"] + 1e-5


def test_segments_matches_jax_cli(tmp_path, capsys):
    rate = 22050
    t = np.arange(2 * rate) / rate
    parts = [0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(2 * np.pi * 2.5 * f * t) for f in (220.0, 330.0, 495.0)]
    rng = np.random.default_rng(2)
    x = (np.concatenate(parts) + 0.01 * rng.standard_normal(6 * rate)).astype(np.float32)
    write_wav(tmp_path / "m.wav", x, rate, bits=32)
    # the boundary decisions clear of the packages' novelty difference (the
    # CLI's pipeline in each; the summed-area table of a 258-frame similarity
    # with sections of near ones reaches 2e4, where fp32 steps 2e-3)
    _, jnov = jops.segment_boundaries(_features(jops, x, rate, 2048, 512), kernel_width=16)
    _, tnov = tops.segment_boundaries(_features(tops, x, rate, 2048, 512), kernel_width=16, device="cpu")
    diff = float(np.abs(tnov.numpy() - np.asarray(jnov)).max())
    m = peak_pick_margins(np.asarray(jnov), 8, 8, 8, 8, 0.05, slack=2 * diff)
    assert diff < 1e-2 and min(m.values()) > 2 * diff, (m, diff)
    tl, jl = _both(capsys, ["segments", "-i", str(tmp_path / "m.wav"), "--kernel", "16"])
    assert set(tl) == set(jl) and tl["frames"] == jl["frames"] and tl["duration_s"] == jl["duration_s"]
    assert tl["boundaries_s"] == jl["boundaries_s"] and len(jl["boundaries_s"]) >= 2
    assert abs(tl["novelty_peak"] - jl["novelty_peak"]) <= diff + 1e-5


@pytest.mark.parametrize("graph", ["logmel", "master"])
def test_inspect_matches_jax_cli_keys(capsys, graph):
    args = ["inspect", "-g", graph, "--seconds", "0.5", "--batch", "2", "--input-rate", "16000"]
    tl, jl = _both(capsys, args)
    assert set(tl) == set(jl) == {"flops", "bytes_accessed", "fusions", "collectives", "hlo_bytes", "graph",
                                  "input_shape"}
    assert tl["graph"] == jl["graph"] and tl["input_shape"] == jl["input_shape"] == [2, 8000]
    assert tl["collectives"] == jl["collectives"] == 0
    assert tl["fusions"] > 0 and tl["bytes_accessed"] == tl["hlo_bytes"] == -1.0
    assert tl["flops"] > 0  # the DFT banks' and the block IIR's products
    assert all(isinstance(tl[k], float) for k in ("flops", "bytes_accessed", "hlo_bytes"))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_twins_match_jax_scripts(tmp_path, capsys, monkeypatch):
    t = np.arange(44100) / 44100
    rng = np.random.default_rng(3)
    for i in range(3):  # tones over noise: no mel band far below the tone, where the log magnifies rounding
        x = 0.3 * np.sin(2 * np.pi * (220 + i * 110) * t) + 0.05 * rng.standard_normal(t.size)
        write_wav(tmp_path / f"x{i}.wav", x.astype(np.float32), 44100)
    _load("batch_features").main(str(tmp_path), "*.wav", str(tmp_path / "j.npy"))
    _load("batch_features_torch").main([str(tmp_path), "*.wav", str(tmp_path / "t.npy"), "--device", "cpu"])
    got, want = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert got.shape == want.shape and got.shape[0] == 3 and np.abs(got - want).max() <= 5e-4
    # the JAX script snapshots to a fixed path; keep its snapshot in the test's directory
    snap = jsession.StreamSession.snapshot
    monkeypatch.setattr(jsession.StreamSession, "snapshot", lambda self, path: snap(self, str(tmp_path / "j.ckpt")))
    capsys.readouterr()
    _load("streaming_session").main(str(tmp_path / "x0.wav"), str(tmp_path / "j.jsonl"))
    jout = capsys.readouterr().out
    _load("streaming_session_torch").main([str(tmp_path / "x0.wav"), str(tmp_path / "t.jsonl"), "--device", "cpu"])
    tout = capsys.readouterr().out
    assert (tmp_path / "t.jsonl.ckpt.npz").exists()
    final = [[ln for ln in out.splitlines() if "final chunk" in ln] for out in (tout, jout)]
    assert final[0] == final[1] and len(final[0]) == 1
    jmsgs = (tmp_path / "j.jsonl").read_text().splitlines()
    tmsgs = (tmp_path / "t.jsonl").read_text().splitlines()
    assert len(tmsgs) == len(jmsgs) > 0
    for a, b in zip(tmsgs, jmsgs):
        ga, gb = wire.decode_audio_chunk(a), wire.decode_audio_chunk(b)
        assert ga.shape == gb.shape and np.abs(ga - gb).max() * 32768 <= 1.0 + 1e-3
