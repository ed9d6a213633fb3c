"""The port's config layer against the JAX package's: TOML round trips,
the config tree, secrets, and graph specs carried across.

A ``GraphSpec`` JSON written by the JAX package's ``graph_to_spec`` must
load through the port's ``graph_from_spec`` into a graph that computes the
same thing, within the tolerance of that graph's own port test: 1e-5 of the
peak for the STFT magnitude (``test_torch_griffinlim.py``), 1e-5 in sample
space for config 3 and 5e-4 in log-mel space for config 5 and the Kaldi
fbank (``test_torch_master.py``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import config as jconfig
from audioflow_tpu import models as jmodels
from audioflow_torch import config as tconfig
from audioflow_torch import graph as tgraph
from audioflow_torch import models as tmodels
from audioflow_torch.errors import ConfigError


def _edited(m):
    cfg = m.UserConfig()
    cfg.audio.n_mels = 80
    cfg.audio.resample_mode = 'cubic "q"'
    cfg.session.emit_partials = False
    cfg.obs.stats_path = "C:\\stats"
    cfg.api.connect_timeout_s = 2.5
    return cfg


@pytest.mark.parametrize("edited", [False, True])
def test_toml_round_trip_equal(tmp_path, edited):
    tcfg = _edited(tconfig) if edited else tconfig.UserConfig()
    jcfg = _edited(jconfig) if edited else jconfig.UserConfig()
    assert tcfg.to_dict() == jcfg.to_dict()
    text = tconfig.dumps_toml(tcfg.to_dict())
    assert text == jconfig.dumps_toml(jcfg.to_dict())
    assert tconfig.loads_toml(text) == jconfig.loads_toml(text) == tcfg.to_dict()
    assert tconfig.UserConfig.from_dict(tconfig.loads_toml(text)) == tcfg
    tm = tconfig.ConfigManager(tmp_path / "t.toml", tcfg)
    jm = jconfig.ConfigManager(tmp_path / "j.toml", jcfg)
    tm.save()
    jm.save()
    assert (tmp_path / "t.toml").read_text() == (tmp_path / "j.toml").read_text()
    assert tconfig.ConfigManager(tmp_path / "j.toml").load().to_dict() == jcfg.to_dict()


def test_config_manager_update_and_errors(tmp_path):
    m = tconfig.ConfigManager(tmp_path / "c.toml")
    assert m.load() == tconfig.UserConfig()  # a missing file keeps the defaults
    got = m.update(lambda c: setattr(c.audio, "hop", 160))
    assert got.audio.hop == m.current().audio.hop == 160
    m.current().audio.hop = 1  # a snapshot: mutating it changes nothing
    assert m.current().audio.hop == 160
    (tmp_path / "bad.toml").write_text("[audio\n")
    bad = [
        ("[audio\n", "CONFIG_PARSE_ERROR"),
        ("[nope]\nx = 1\n", "CONFIG_VALIDATION_ERROR"),
        ("[audio]\nbogus = 1\n", "CONFIG_VALIDATION_ERROR"),
        ("audio = 3\n", "CONFIG_PARSE_ERROR"),
    ]
    for text, code in bad:
        (tmp_path / "bad.toml").write_text(text)
        with pytest.raises(ConfigError) as et:
            tconfig.ConfigManager(tmp_path / "bad.toml").load()
        with pytest.raises(Exception) as ej:
            jconfig.ConfigManager(tmp_path / "bad.toml").load()
        assert et.value.code.value == ej.value.code.value == code


def test_secrets_like_jax(tmp_path, monkeypatch):
    for m, d in ((tconfig, "t"), (jconfig, "j")):
        s = m.FileKeyStorage(tmp_path / d / "secrets.json")
        s.store("elevenlabs", "k1")
        s.store("other", "k2")
        s.delete("other")
        s.delete("never-stored")
        assert s.retrieve("elevenlabs") == "k1"
        assert oct((tmp_path / d / "secrets.json").stat().st_mode & 0o777) == "0o600"
    assert (tmp_path / "t" / "secrets.json").read_text() == (tmp_path / "j" / "secrets.json").read_text()
    with pytest.raises(ConfigError) as e:
        tconfig.FileKeyStorage(tmp_path / "t" / "secrets.json").retrieve("other")
    assert e.value.code.value == "SECRET_NOT_FOUND"
    monkeypatch.delenv("AUDIOFLOW_API_KEY", raising=False)
    monkeypatch.setenv("AUDIOFLOW_API_KEY_MY_ACCT", "v")
    assert tconfig.default_key_storage().retrieve("my-acct") == "v"
    with pytest.raises(ConfigError):
        tconfig.EnvKeyStorage().retrieve("absent")


def _spec_json(graph) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(jconfig.graph_to_spec(graph))))


def _run_both(jg, x):
    tg = tconfig.graph_from_spec(_spec_json(jg))
    assert [type(n).__name__ for n in tg.nodes] == [type(n).__name__ for n in jg.nodes]
    assert (tg.input_rate, tg.name, tg.output_rate) == (jg.input_rate, jg.name, jg.output_rate)
    got = tg.compile()(torch.from_numpy(x)).numpy()
    want = np.asarray(jg.compile()(jnp.asarray(x)))
    assert got.shape == want.shape and np.isfinite(got).all()
    return tg, got, want


def test_jax_spec_stft_magnitude():
    x = (0.3 * np.random.default_rng(0).standard_normal((2, 8000))).astype(np.float32)
    _, got, want = _run_both(jmodels.stft_magnitude_graph(), x)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_jax_spec_config5_log_mel_with_eq():
    x = (0.3 * np.random.default_rng(1).standard_normal((2, 20000))).astype(np.float32)
    jg = jmodels.log_mel_frontend(44100, 16000, 1024, 256, 128, eq=jmodels.eq_bands_default(16000))
    tg, got, want = _run_both(jg, x)
    assert tg.nodes[1] == tgraph.BiquadChain(tmodels.eq_bands_default(16000))
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_jax_spec_master_chain():
    x = (0.3 * np.random.default_rng(2).standard_normal((2, 16000))).astype(np.float32)
    _, got, want = _run_both(jmodels.master_chain_graph(16000), x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_jax_spec_kaldi_fbank():
    x = (0.3 * np.random.default_rng(3).standard_normal((2, 8000))).astype(np.float32)
    _, got, want = _run_both(jmodels.kaldi_fbank_frontend(16000), x)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_port_spec_equals_jax_spec_and_round_trips():
    eq_t, eq_j = tmodels.eq_bands_default(16000), jmodels.eq_bands_default(16000)
    pairs = [
        (tmodels.log_mel_frontend(eq=eq_t, fused=False), jmodels.log_mel_frontend(eq=eq_j)),
        (tmodels.master_chain_graph(16000), jmodels.master_chain_graph(16000)),
        (tmodels.kaldi_fbank_frontend(16000), jmodels.kaldi_fbank_frontend(16000)),
    ]
    for tg, jg in pairs:
        assert dataclasses.asdict(tconfig.graph_to_spec(tg)) == _spec_json(jg)
    fused = tmodels.log_mel_frontend(eq=eq_t)  # LogMelSpec: the melspec kernel's node
    spec = json.loads(json.dumps(dataclasses.asdict(tconfig.graph_to_spec(fused))))
    assert tconfig.graph_from_spec(spec) == fused
    assert tconfig.graph_from_spec(tconfig.graph_to_spec(fused)) == fused


def test_spec_with_unported_node_raises_naming_it():
    """Every JAX node is ported (a JAX ``OnlinePyin`` spec loads
    as the port's node), so the unported node is a JAX spec's node renamed
    to a type no package registers."""
    from audioflow_tpu import graph as jgraph

    spec = _spec_json(jgraph.chain(jgraph.OnlinePyin(), input_rate=16000))
    assert tconfig.graph_from_spec(spec) == tgraph.chain(tgraph.OnlinePyin(), input_rate=16000)
    spec["nodes"][0]["type"] = "OnlinePyinUnported"
    with pytest.raises(ConfigError) as e:
        tconfig.graph_from_spec(spec)
    assert e.value.code.value == "CONFIG_VALIDATION_ERROR" and "'OnlinePyinUnported'" in e.value.message
    with pytest.raises(ConfigError) as e:
        tconfig.graph_from_spec({"nodes": [{"type": "Gain", "bogus": 1}]})
    assert e.value.code.value == "CONFIG_VALIDATION_ERROR" and "Gain" in e.value.message
