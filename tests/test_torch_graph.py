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
from audioflow_torch.models import eq_bands_default, log_mel_frontend

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


# LogMelSpec alone, at two lead axes: a chunk shorter than its 768-sample
# carry (each new carry then spans both segments), one that is not a
# multiple of it, and the benchmark's resampled chunk
@pytest.mark.parametrize("chunk", [256, 1280, 5120])
def test_logmel_node_streamed_equals_offline(rng, chunk):
    g = tgraph.chain(tgraph.LogMelSpec(1024, 256, 128, center=False), input_rate=16000)
    x = torch.from_numpy(rng.standard_normal((2, 2, 4 * 5120)).astype(np.float32))
    streamed, offline = g.scan_stream(x, chunk), g.chain(x)
    lat, n = g.stream_latency(chunk), offline.shape[-2]
    assert lat == 3 and streamed.shape == (2, 2, n + lat, 128)
    torch.testing.assert_close(streamed[..., lat:, :], offline, rtol=0, atol=1e-4)


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
    # eq is a BiquadChain after the resampler now that the IIR engine is
    # ported; an empty chain is a configuration error, as in the JAX package
    eq_graph = log_mel_frontend(eq=eq_bands_default(16000.0))
    assert [type(n).__name__ for n in eq_graph.nodes] == ["Resample", "BiquadChain", "LogMelSpec"]
    with pytest.raises(AudioError):
        tgraph.BiquadChain(())
    assert set(tgraph.node_registry()) >= {"Resample", "Spectrogram", "MelProject", "LogMelSpec"}


def _taps_graph(pkg):
    """The reference's ``test_graph_taps`` graph (``tests/test_graph.py``)."""
    return pkg.chain(
        pkg.Resample(48000, 16000, "kaiser"), pkg.Stft(512, 128, center=False), pkg.Power(),
        pkg.MelProject(n_mels=64), input_rate=48000,
    )


def test_graph_taps(rng):
    """One call yields intermediate outputs, as the reference's taps do:
    ``compile(taps=...)`` and ``chain(x, taps=...)`` return ``(final, {idx:
    output})``, each within the log-mel slice's tolerance of the JAX
    package's, and a tap out of range raises ``ConfigError``."""
    x = rng.standard_normal(48000).astype(np.float32)
    g, j = _taps_graph(tgraph), _taps_graph(jgraph)
    final, tapped = g.compile(taps=(0, 1))(torch.from_numpy(x))
    j_final, j_tapped = j.compile(taps=(0, 1))(jnp.asarray(x))
    assert set(tapped) == set(j_tapped) == {0, 1}
    assert tuple(tapped[0].shape) == (16000,) and tapped[1].dtype == torch.complex64
    np.testing.assert_allclose(final.numpy(), g.compile()(torch.from_numpy(x)).numpy(), atol=1e-6)
    np.testing.assert_allclose(final.numpy(), np.asarray(j_final), atol=5e-4)
    np.testing.assert_allclose(tapped[0].numpy(), np.asarray(j_tapped[0]), atol=1e-5)
    chained, chain_taps = g.chain(torch.from_numpy(x), taps=(2,))
    assert torch.equal(chained, final) and set(chain_taps) == {2}
    with pytest.raises(ConfigError, match="tap indices out of range"):
        g.compile(taps=(99,))


def test_compile_takes_the_reference_arguments(monkeypatch):
    """``compile(donate, taps, chunked)`` in the reference's order: a
    positional True is ``donate``, which is accepted and changes nothing,
    so a short input is not chunked; ``chunked=True`` still forces the
    chunked form, and a tapped compile is never chunked."""
    calls = []
    real = tgraph.Graph._chunked_chain
    monkeypatch.setattr(tgraph.Graph, "_chunked_chain", lambda self, x: calls.append(1) or real(self, x))
    g = log_mel_frontend(44100, 16000, 1024, 256, 128)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 2 * CHUNK)).astype(np.float32))
    donated = g.compile(True)(x)
    assert calls == []
    assert torch.equal(donated, g.compile(False)(x)) and torch.equal(donated, g.chain(x))
    g.compile(chunked=True)(x)
    assert calls == [1]
    final, _ = g.compile(donate=True, taps=(0,), chunked=True)(x)
    assert calls == [1] and torch.equal(final, donated)


def _planned(form):
    """A fresh stream (its plans and output shapes not yet resolved) and its chunk."""
    if form == "logmel":
        return log_mel_frontend(44100, 16000, 1024, 256, 128), CHUNK
    if form == "fork":  # the dictation fork of test_torch_fork.py
        f = tgraph.fork(
            tgraph.chain(tgraph.Resample(48000, 16000, "kaiser"), input_rate=48000),
            wire=tgraph.chain(tgraph.VadGate(320), tgraph.QuantizeI16(), input_rate=16000),
            vad=tgraph.chain(tgraph.Vad(320), input_rate=16000),
            features=tgraph.chain(tgraph.LogMelSpec(1024, 256, 128, center=False), input_rate=16000),
        )
        return f, f.chunk_granularity()
    # the Gain branch waits in a delay line for the two resamplers' latency
    mix = tgraph.Mix(((tgraph.Gain(0.0),), (tgraph.Resample(16000, 8000), tgraph.Resample(8000, 16000))))
    g = tgraph.chain(mix, input_rate=16000)
    return g, 4 * g.chunk_granularity()


def _count_meta_steps(monkeypatch, stream) -> list:
    """Patch the step of every node type ``stream`` holds (a Fork's graphs
    and a Mix's branches included) to log the steps taken over meta tensors."""
    graphs = [stream.trunk, *(g for _, g in stream.branches)] if isinstance(stream, tgraph.Fork) else [stream]
    types = set()
    while graphs:
        for node in graphs.pop().nodes:
            types.add(type(node))
            if isinstance(node, tgraph.Mix):
                graphs.extend(node._graphs())
    log = []
    for cls in types:
        def step(self, carry, chunk, *args, _step=cls.step, **kwargs):
            if chunk.device.type == "meta":
                log.append(type(self).__name__)
            return _step(self, carry, chunk, *args, **kwargs)

        monkeypatch.setattr(cls, "step", step)
    return log


@pytest.mark.parametrize("form", ["logmel", "fork", "mix"])
def test_schedule_and_shapes_are_resolved_once(monkeypatch, form):
    """The streaming plan and the step output shapes are worked out once a
    key: after a key's first ``init_state``, another ``init_state`` and the
    steps take no step over meta tensors (for a Fork neither its trunk nor
    a branch, for a Mix none of its branches), two passes stream bitwise
    the same, and a new lead shape takes exactly one more shape pass."""
    stream, chunk = _planned(form)
    meta_steps = _count_meta_steps(monkeypatch, stream)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4 * chunk)).astype(np.float32))
    stream.init_state(chunk, (2,))
    one_pass = len(meta_steps)
    assert one_pass > 0
    state = stream.init_state(chunk, (2,))
    for c in range(3):
        state, _ = stream.stream_step(state, x[:, c * chunk : (c + 1) * chunk])
    first, second = stream.scan_stream(x, chunk), stream.scan_stream(x, chunk)
    assert len(meta_steps) == one_pass
    if form == "fork":
        assert first.keys() == second.keys() == {"wire", "vad", "features"}
        assert all(torch.equal(first[k], second[k]) for k in first)
    else:
        assert torch.equal(first, second)
    stream.init_state(chunk, (3,))
    assert len(meta_steps) == 2 * one_pass
