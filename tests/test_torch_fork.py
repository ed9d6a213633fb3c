"""The port's Fork against the JAX package's on the CPU: offline and
streamed, per-branch latency, the fork spec both ways between the packages,
and the graphs that build on the new nodes (``vad_graph``, a ``Mix`` spec).
Tolerances as ``test_torch_session.py``: VAD states exactly, i16 within 1
LSB, log-mel 5e-4."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import config as jconfig
from audioflow_tpu import graph as jg
from audioflow_tpu import models as jmodels
from audioflow_torch import config as tconfig
from audioflow_torch import graph as tg
from audioflow_torch import models as tmodels
from audioflow_torch.errors import ConfigError

LOGMEL_TOL = 5e-4


def _dictation(mod, rate=48000):
    return mod.fork(
        mod.chain(mod.Resample(rate, 16000, "kaiser"), input_rate=rate),
        wire=mod.chain(mod.VadGate(320), mod.QuantizeI16(), input_rate=16000),
        vad=mod.chain(mod.Vad(320), input_rate=16000),
        features=mod.chain(mod.LogMelSpec(1024, 256, 128, center=False), input_rate=16000),
    )


def _speech(seconds, rate, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 1e-5 * rng.standard_normal((2, n))
    for a, b in ((0.2, 0.7), (1.0, 1.6)):
        sl = slice(min(n, int(a * rate)), min(n, int(b * rate)))
        x[:, sl] += 0.3 * np.sin(2 * np.pi * 300 * t[sl]) + 0.05 * rng.standard_normal((2, sl.stop - sl.start))
    return x.astype(np.float32)


def _close(got, want):
    assert got.keys() == want.keys() == {"wire", "vad", "features"}
    w = {k: np.asarray(v) for k, v in want.items()}
    assert got["wire"].dtype == torch.int16 and got["wire"].shape == w["wire"].shape
    assert np.abs(got["wire"].numpy().astype(np.int32) - w["wire"]).max() <= 1
    np.testing.assert_array_equal(got["vad"].numpy(), w["vad"])
    np.testing.assert_allclose(got["features"].numpy(), w["features"], atol=LOGMEL_TOL)


def test_fork_offline_matches_jax():
    x = _speech(2.5, 48000)
    got = _dictation(tg).compile()(torch.from_numpy(x))
    _close(got, _dictation(jg).compile()(jnp.asarray(x)))
    assert set(np.unique(got["vad"].numpy())) == {0, 1, 2}


def test_fork_streamed_matches_jax_and_shifted_offline():
    f_t, f_j = _dictation(tg), _dictation(jg)
    chunk = f_t.chunk_granularity()
    assert chunk == f_j.chunk_granularity()
    lat = f_t.stream_latency(chunk)
    assert lat == f_j.stream_latency(chunk)
    x = _speech(2.0, 48000, seed=1)
    n = x.shape[-1] // chunk * chunk
    got = f_t.scan_stream(torch.from_numpy(x[:, :n]), chunk)
    _close(got, f_j.scan_stream(jnp.asarray(x[:, :n]), chunk))
    # each branch: its offline output shifted by its own latency
    off = f_t.chain(torch.from_numpy(x[:, :n]))
    # (the streamed and the whole-array resampler round in their own order:
    # i16 within 1 LSB)
    m = off["vad"].shape[1] - lat["vad"]
    np.testing.assert_array_equal(got["vad"][:, lat["vad"] : lat["vad"] + m].numpy(), off["vad"][:, :m].numpy())
    m = off["wire"].shape[1] - lat["wire"]
    d = got["wire"][:, lat["wire"] : lat["wire"] + m].int() - off["wire"][:, :m].int()
    assert d.abs().max() <= 1
    m = off["features"].shape[1] - lat["features"]
    np.testing.assert_allclose(got["features"][:, lat["features"] :][:, :m].numpy(), off["features"][:, :m].numpy(),
                               atol=LOGMEL_TOL)


def test_fork_validation():
    trunk = tg.chain(tg.Resample(48000, 16000), input_rate=48000)
    with pytest.raises(ConfigError, match="at least one branch"):
        tg.Fork(trunk, ())
    with pytest.raises(ConfigError, match="duplicate"):
        tg.Fork(trunk, (("a", tg.chain(tg.Vad(), input_rate=16000)), ("a", tg.chain(tg.Vad(), input_rate=16000))))
    with pytest.raises(ConfigError, match="input_rate"):
        tg.fork(trunk, v=tg.chain(tg.Vad(), input_rate=8000))
    with pytest.raises(ConfigError, match="domain"):
        tg.fork(tg.chain(tg.Spectrogram(512, 128, center=False), input_rate=16000), v=tg.chain(tg.Vad()))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fork_spec_round_trips_between_packages(writer):
    """A fork spec written by either package loads in the other into a Fork
    that computes the same thing."""
    src = _dictation(tg) if writer == "port" else _dictation(jg)
    spec = (tconfig if writer == "port" else jconfig).fork_to_spec(src)
    spec = json.loads(json.dumps(spec))
    back_t, back_j = tconfig.fork_from_spec(spec), jconfig.fork_from_spec(spec)
    assert [k for k, _ in back_t.branches] == ["wire", "vad", "features"]
    assert tconfig.fork_to_spec(back_t) == jconfig.fork_to_spec(back_j) == spec
    x = _speech(1.0, 48000, seed=2)
    _close(back_t.compile()(torch.from_numpy(x)), back_j.compile()(jnp.asarray(x)))
    with pytest.raises(ConfigError, match="missing"):
        tconfig.fork_from_spec({"trunk": spec["trunk"]})


def test_mix_and_vad_nodes_load_from_jax_specs():
    """graph_to_spec of the JAX package's Mix, VadGate and QuantizeI16 loads in
    the port, and the port's spec is the JAX package's."""
    mix = jg.Mix(branches=((jg.Gain(0.0),), (jg.Gain(-6.0), jg.Limiter(-3.0))), combine="max", weights=(1.0, 2.0))
    jgraph = jg.chain(mix, jg.VadGate(320, level="relaxed"), jg.QuantizeI16("round"), input_rate=16000)
    spec = json.loads(json.dumps(dataclasses.asdict(jconfig.graph_to_spec(jgraph))))
    tgraph = tconfig.graph_from_spec(spec)
    assert [type(n).__name__ for n in tgraph.nodes] == ["Mix", "VadGate", "QuantizeI16"]
    assert dataclasses.asdict(tconfig.graph_to_spec(tgraph)) == spec
    x = _speech(1.0, 16000, seed=3)
    got = tgraph.compile()(torch.from_numpy(x)).numpy()
    want = np.asarray(jgraph.compile()(jnp.asarray(x)))
    assert got.dtype == np.int16 and np.abs(got.astype(np.int32) - want).max() <= 1


def test_vad_graph_matches_jax():
    x = _speech(2.0, 16000, seed=4)
    for kw in ({}, {"level": "aggressive"}, {"threshold_db": -30.0, "frame_ms": 10}):
        got = tmodels.vad_graph(16000, **kw).compile()(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmodels.vad_graph(16000, **kw).compile()(jnp.asarray(x))))
