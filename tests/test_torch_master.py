"""The port's pipelines of BASELINE configs 3 and 5, and the Kaldi fbank
frontend, against the JAX package's on the CPU at 2 rows x 3 chunks.

Config 3 is ``master_chain_graph`` (high-pass + 5-band EQ + limiter);
config 5 streams ``Resample -> BiquadChain -> Spectrogram -> MelProject``
(``audioflow_tpu/bench.py:132-165``), which ``log_mel_frontend(eq=...)``
builds, fused through ``LogMelSpec`` or as the two-node pair. Tolerances:
1e-5 in sample space, 5e-4 in log-mel space (as ``test_torch_graph.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu import models as jmodels
from audioflow_torch import graph as tgraph
from audioflow_torch import models as tmodels

CHUNK5 = 14112  # config 5's chunk at 44.1 kHz
LATENCY5 = 4  # its stream latency in frames
CHUNK3 = 16384


def _jax_bands(rate):
    return jmodels.eq_bands_default(rate)


@pytest.fixture(scope="module")
def pcm16():
    return (0.3 * np.random.default_rng(0).standard_normal((2, 3 * CHUNK3))).astype(np.float32)


@pytest.fixture(scope="module")
def pcm44():
    return (0.3 * np.random.default_rng(1).standard_normal((2, 3 * CHUNK5))).astype(np.float32)


def test_master_chain_matches_jax(pcm16):
    g = tmodels.master_chain_graph(16000)
    j = jmodels.master_chain_graph(16000)
    assert [type(n).__name__ for n in g.nodes] == [type(n).__name__ for n in j.nodes] == ["BiquadChain", "Limiter"]
    assert g.nodes[1].sample_rate == 16000
    offline = g.compile()(torch.from_numpy(pcm16))
    np.testing.assert_allclose(offline.numpy(), np.asarray(j.compile()(jnp.asarray(pcm16))), atol=1e-5, rtol=0)
    streamed = g.scan_stream(torch.from_numpy(pcm16), CHUNK3)
    np.testing.assert_allclose(streamed.numpy(), np.asarray(j.scan_stream(jnp.asarray(pcm16), CHUNK3)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(streamed.numpy(), offline.numpy(), atol=1e-5, rtol=0)
    # the limiter engages (0.3·N(0,1) peaks past -1 dBFS after the EQ) and
    # holds the peak to the threshold within the fp32 rounding of the
    # envelope's log-domain ramp (k·|log r| reaches 61 over 49,152 samples)
    assert pcm16.max() > 1.0
    assert offline.abs().max().item() <= 10 ** (-1 / 20) * (1 + 1e-5)


def test_master_chain_long_input_runs_chunked():
    """Past 65,536 samples ``compile()`` streams the chain internally; it
    equals the whole-array chain."""
    x = (0.3 * np.random.default_rng(2).standard_normal((1, 70000))).astype(np.float32)
    g = tmodels.master_chain_graph(16000)
    chunked = g.compile()(torch.from_numpy(x))
    whole = g.compile(chunked=False)(torch.from_numpy(x))
    assert chunked.shape == whole.shape == (1, 70000)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-5, rtol=0)


def test_eq_chain_graph_matches_jax(pcm16):
    g, j = tmodels.eq_chain_graph(16000), jmodels.eq_chain_graph(16000)
    np.testing.assert_allclose(g.compile(chunked=False)(torch.from_numpy(pcm16)).numpy(),
                               np.asarray(j(jnp.asarray(pcm16))), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def config5_jax(pcm44):
    """The JAX package's config-5 composition streamed (bench.py:132-165)."""
    j = jgraph.chain(
        jgraph.Resample(44100, 16000, "kaiser"), jgraph.BiquadChain(_jax_bands(16000.0)),
        jgraph.Spectrogram(1024, 256, center=False), jgraph.MelProject(n_mels=128), input_rate=44100,
    )
    return np.asarray(j.scan_stream(jnp.asarray(pcm44), CHUNK5))


def _config5_port():
    return tgraph.chain(
        tgraph.Resample(44100, 16000, "kaiser"), tgraph.BiquadChain(tmodels.eq_bands_default(16000.0)),
        tgraph.Spectrogram(1024, 256, center=False), tgraph.MelProject(n_mels=128), input_rate=44100,
    )


def test_config5_composition_matches_jax(pcm44, config5_jax):
    g = _config5_port()
    assert g.chunk_granularity() == 3528 and g.stream_latency(CHUNK5) == LATENCY5
    got = g.scan_stream(torch.from_numpy(pcm44), CHUNK5).numpy()
    assert got.shape == config5_jax.shape == (2, 60, 128)
    np.testing.assert_allclose(got, config5_jax, atol=5e-4, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_log_mel_frontend_with_eq_matches_jax(pcm44, config5_jax, fused):
    eq = tmodels.eq_bands_default(16000.0)
    g = tmodels.log_mel_frontend(44100, 16000, 1024, 256, 128, eq=eq, fused=fused)
    j = jmodels.log_mel_frontend(44100, 16000, 1024, 256, 128, eq=_jax_bands(16000.0), center=False, fused=fused)
    assert [type(n).__name__ for n in g.nodes] == [type(n).__name__ for n in j.nodes]
    assert g.nodes[1] == tgraph.BiquadChain(tuple(eq))
    for m in ("chunk_lens", "_delays", "_warmups", "stream_latency"):
        assert getattr(g, m)(CHUNK5) == getattr(j, m)(CHUNK5), m
    got = g.scan_stream(torch.from_numpy(pcm44), CHUNK5).numpy()
    want = np.asarray(j.scan_stream(jnp.asarray(pcm44), CHUNK5))
    assert np.isfinite(got).all() and got.shape == want.shape == (2, 60, 128)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    # the fused and two-node forms agree with the composition past the preroll
    np.testing.assert_allclose(got[:, LATENCY5:], config5_jax[:, LATENCY5:], atol=5e-4, rtol=0)


@pytest.mark.parametrize("cmvn", [True, False])
def test_kaldi_fbank_matches_jax(cmvn):
    x = (0.3 * np.random.default_rng(3).standard_normal((2, 8000))).astype(np.float32)
    g = tmodels.kaldi_fbank_frontend(16000, cmvn=cmvn)
    j = jmodels.kaldi_fbank_frontend(16000, cmvn=cmvn)
    assert [type(n).__name__ for n in g.nodes] == [type(n).__name__ for n in j.nodes]
    got = g.compile()(torch.from_numpy(x)).numpy()
    want = np.asarray(j(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 47, 80)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    assert g.streamable == (not cmvn)
    if not cmvn:
        streamed = g.scan_stream(torch.from_numpy(x), 1600).numpy()
        np.testing.assert_allclose(streamed, np.asarray(j.scan_stream(jnp.asarray(x), 1600)), atol=5e-4, rtol=0)
        lat = g.stream_latency(1600)
        np.testing.assert_allclose(streamed[:, lat:], got[:, : streamed.shape[1] - lat], atol=5e-4, rtol=0)
