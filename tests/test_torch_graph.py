"""The port's log-mel frontend slice against the JAX package on the CPU.

The slice is ``log_mel_frontend(44100, 16000, 1024, 256, 128, center=False)``
run as a chunked stream of 14,112-sample chunks (the ``logmel_stream``
benchmark's chunk), here at batch 2 x 3 chunks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu.models import log_mel_frontend as jax_frontend
from audioflow_torch import graph as tgraph
from audioflow_torch.errors import AudioError, ConfigError
from audioflow_torch.models import log_mel_frontend

CHUNK = 14112
LATENCY = 4  # stream_latency(CHUNK) in frames


@pytest.fixture(scope="module")
def signal():
    return np.random.default_rng(0).standard_normal((2, 3 * CHUNK)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_streams(signal):
    """JAX scan_stream outputs: fused (LogMelSpec) and two-node (default) forms."""
    return {
        fused: np.asarray(
            jax_frontend(44100, 16000, 1024, 256, 128, center=False, fused=fused).scan_stream(
                jnp.asarray(signal), CHUNK
            )
        )
        for fused in (True, False)
    }


@pytest.fixture(scope="module")
def port_streams(signal):
    return {
        fused: log_mel_frontend(44100, 16000, 1024, 256, 128, fused=fused)
        .scan_stream(torch.from_numpy(signal), CHUNK)
        .numpy()
        for fused in (True, False)
    }


@pytest.mark.parametrize("fused", [True, False])
def test_stream_matches_jax_every_frame(jax_streams, port_streams, fused):
    """Every frame, the preroll included: checks the port of _delays and _warmups."""
    got, want = port_streams[fused], jax_streams[fused]
    assert got.shape == want.shape == (2, 60, 128)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_fused_equals_two_node_after_latency(jax_streams, port_streams):
    """The two forms differ in the discarded preroll frames (so do the JAX
    package's own), and agree from stream_latency on."""
    fused, two = port_streams[True], port_streams[False]
    np.testing.assert_allclose(fused[:, LATENCY:], two[:, LATENCY:], atol=5e-4)
    np.testing.assert_allclose(fused[:, LATENCY:], jax_streams[False][:, LATENCY:], atol=5e-4)
    assert np.isfinite(fused).all()


@pytest.mark.parametrize("fused", [True, False])
def test_streaming_metadata_matches_jax(fused):
    g = log_mel_frontend(44100, 16000, 1024, 256, 128, fused=fused)
    j = jax_frontend(44100, 16000, 1024, 256, 128, fused=fused)
    assert g.chunk_granularity() == j.chunk_granularity() == 3528
    assert g.chunk_lens(CHUNK) == j.chunk_lens(CHUNK)
    assert g._delays(CHUNK) == j._delays(CHUNK)
    assert g._warmups(CHUNK) == j._warmups(CHUNK)
    assert g.stream_latency(CHUNK) == j.stream_latency(CHUNK) == LATENCY
    carries, pendings, k = g.init_state(CHUNK, (2,))
    jc, jp, jk = j.init_state(CHUNK, (2,))
    assert k == int(jk) == 0
    for a, b in zip(carries + pendings, jc + jp):
        assert (a is None and b is None) or tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("fused", [True, False])
def test_streamed_equals_offline(signal, port_streams, fused):
    g = log_mel_frontend(44100, 16000, 1024, 256, 128, fused=fused)
    offline = g.chain(torch.from_numpy(signal)).numpy()
    streamed = port_streams[fused]
    n = min(streamed.shape[1] - LATENCY, offline.shape[1])
    assert n > 50
    np.testing.assert_allclose(streamed[:, LATENCY : LATENCY + n], offline[:, :n], atol=5e-4)
    # compile()'s auto-chunked offline form equals the whole-array chain
    np.testing.assert_allclose(g.compile()(torch.from_numpy(signal)).numpy(), offline, atol=5e-4)


@pytest.mark.parametrize("node", ["LogMelSpec", "Spectrogram"])
def test_center_offline_matches_jax(rng, node):
    x = rng.standard_normal((2, 70000)).astype(np.float32)
    tnode = getattr(tgraph, node)(1024, 256, center=True)
    jnode = getattr(jgraph, node)(1024, 256, center=True)
    tail = () if node == "LogMelSpec" else (tgraph.MelProject(),)
    jtail = () if node == "LogMelSpec" else (jgraph.MelProject(),)
    g = tgraph.chain(tnode, *tail, input_rate=16000)
    j = jgraph.chain(jnode, *jtail, input_rate=16000)
    want = np.asarray(j.chain(jnp.asarray(x)))
    np.testing.assert_allclose(g.chain(torch.from_numpy(x)).numpy(), want, atol=5e-4)
    if node == "Spectrogram":  # the decentered chunked form of a center=True head
        np.testing.assert_allclose(g.compile()(torch.from_numpy(x)).numpy(), want, atol=5e-4)


def test_graph_errors():
    g = log_mel_frontend(44100, 16000, 1024, 256, 128)
    with pytest.raises(AudioError):
        g.chunk_lens(1000)  # not a multiple of the granularity
    with pytest.raises(AudioError):
        g.scan_stream(torch.zeros(2, CHUNK + 1), CHUNK)
    with pytest.raises(AudioError):
        log_mel_frontend(44100, 16000, 1024, 256, 128, center=True).init_state(CHUNK)
    with pytest.raises(ConfigError):
        tgraph.chain(tgraph.MelProject(), input_rate=16000)  # frames node fed samples
    with pytest.raises(AudioError):
        tgraph.chain(tgraph.Resample(48000, 16000), input_rate=44100)
    with pytest.raises(NotImplementedError):
        log_mel_frontend(eq=("band",))
    assert set(tgraph.node_registry()) >= {"Resample", "Spectrogram", "MelProject", "LogMelSpec"}
