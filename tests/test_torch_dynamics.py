"""The port's dynamics ops and sample/spectral nodes against the JAX package
on the CPU: each op on the same seeded input, each node's ``apply`` against
the JAX node's, and each streamable node's ``scan_stream`` against the JAX
graph's and against its own offline output."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu import ops as jops
from audioflow_torch import graph as tgraph
from audioflow_torch import ops as tops

RATE = 16000


@pytest.fixture(scope="module")
def signal():
    """[2, 3, 4096]: noise with a quiet stretch, so gates, AGC holds and
    envelopes all see both levels."""
    x = (0.3 * np.random.default_rng(0).standard_normal((2, 3, 4096))).astype(np.float32)
    x[..., 1000:2200] *= 1e-3
    return x


def _close(got: torch.Tensor, want, atol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if atol == 0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize(
    "name,args,atol",
    [
        ("gain_db", (-3.5,), 0),
        ("peak_normalize", (0.9,), 1e-6),
        ("rms_normalize", (-18.0,), 1e-6),
        ("mean_square_energy", (), 1e-7),
        ("limiter", (-6.0, 50.0, RATE), 1e-5),
        ("compressor", (-20.0, 4.0, 100.0, RATE), 1e-5),
        ("compressor", (-20.0, 4.0, 30.0, RATE, 6.0), 1e-5),  # soft knee
        ("noise_gate", (-30.0, 100.0, RATE), 1e-5),
        ("preemphasis", (0.97,), 0),
        ("deemphasis", (0.97,), 1e-5),
    ],
)
def test_op_matches_jax(signal, name, args, atol):
    _close(getattr(tops, name)(torch.from_numpy(signal), *args), getattr(jops, name)(jnp.asarray(signal), *args), atol)


@pytest.mark.parametrize("channels", [1, 2, 3, 6])
def test_to_mono_equals_jax(signal, channels):
    _close(tops.to_mono(torch.from_numpy(signal), channels), jops.to_mono(jnp.asarray(signal), channels), 0)


def test_envelope_and_dbfs_match_jax(signal):
    x = np.abs(signal)
    _close(tops.dynamics.envelope_peak_release(torch.from_numpy(x), 0.99),
           jops.dynamics.envelope_peak_release(jnp.asarray(x), 0.99), 1e-5)
    e = np.array([0.0, 1e-9, 0.25, 1.0], np.float32)
    np.testing.assert_allclose(tops.energy_to_dbfs(torch.from_numpy(e)).numpy(),
                               np.asarray(jops.energy_to_dbfs(jnp.asarray(e))), rtol=1e-6)
    with pytest.raises(ValueError):
        tops.dynamics.envelope_peak_release(torch.from_numpy(x), 1.0)


@pytest.mark.parametrize("gain0,block", [(None, 1024), ([[1.0, -2.0, 3.0], [0.0, 5.0, -7.0]], 256), (2.0, 5000)])
def test_agc_matches_jax(signal, gain0, block):
    """With and without the carried gain, with a tail past the last full
    block (4096 = 16·256; 4096 = 4·1024) and with no full block at all."""
    x = signal[..., :4000]
    g_t = None if gain0 is None else torch.tensor(gain0, dtype=torch.float32)
    g_j = None if gain0 is None else jnp.asarray(gain0, jnp.float32)
    y_t, end_t = tops.agc(torch.from_numpy(x), block=block, gain0=g_t)
    y_j, end_j = jops.agc(jnp.asarray(x), block=block, gain0=g_j)
    _close(y_t, y_j, 1e-5)
    _close(end_t, np.broadcast_to(np.asarray(end_j), (2, 3)), 1e-5)


@pytest.mark.parametrize("norm_var", [False, True])
def test_cmvn_matches_jax(norm_var):
    f = np.random.default_rng(1).standard_normal((2, 50, 13)).astype(np.float32) * 3 + 1
    _close(tops.cmvn(torch.from_numpy(f), norm_var), jops.cmvn(jnp.asarray(f), norm_var), 1e-5)


@pytest.mark.parametrize("frame_length,hop", [(2048, 512), (400, 160)])
def test_trim_and_split_intervals_equal_jax(frame_length, hop):
    rng = np.random.default_rng(2)
    s = np.zeros(40000, np.float32)
    s[10000:20000] = 0.3 * rng.standard_normal(10000)
    s[25000:30000] = 0.3 * rng.standard_normal(5000)
    assert tops.split_silence(torch.from_numpy(s), 40.0, frame_length, hop) == jops.split_silence(
        jnp.asarray(s), 40.0, frame_length, hop)
    got, span = tops.trim_silence(torch.from_numpy(s), 40.0, frame_length, hop)
    want, want_span = jops.trim_silence(jnp.asarray(s), 40.0, frame_length, hop)
    assert span == want_span and np.array_equal(got.numpy(), np.asarray(want))
    assert tops.trim_silence(torch.zeros(100))[1] == jops.trim_silence(jnp.zeros(100))[1]
    with pytest.raises(ValueError):
        tops.split_silence(torch.zeros(2, 100))


# --- nodes ----------------------------------------------------------------

# (port node, JAX node, chunk for scan_stream or None when offline only,
# tolerance against the JAX graph: its jitted chains may fuse a multiply and
# a subtract into one rounding, so the exact ops are 1e-6 here)
SAMPLE_NODES = {
    "ToMono": (tgraph.ToMono(2), jgraph.ToMono(2), 512, 0),
    "Gain": (tgraph.Gain(-6.0), jgraph.Gain(-6.0), 512, 0),
    "Limiter": (tgraph.Limiter(-6.0, 20.0), jgraph.Limiter(-6.0, 20.0), 512, 1e-5),
    "Compressor": (tgraph.Compressor(-25.0, 3.0, 30.0, 6.0), jgraph.Compressor(-25.0, 3.0, 30.0, 6.0), 512, 1e-5),
    "NoiseGate": (tgraph.NoiseGate(-30.0, 10.0), jgraph.NoiseGate(-30.0, 10.0), 512, 1e-5),
    "Agc": (tgraph.Agc(block=256), jgraph.Agc(block=256), 512, 1e-5),
    "Preemphasis": (tgraph.Preemphasis(0.9), jgraph.Preemphasis(0.9), 512, 1e-6),
    "PeakNormalize": (tgraph.PeakNormalize(0.5), jgraph.PeakNormalize(0.5), None, 1e-6),
    "RmsNormalize": (tgraph.RmsNormalize(-12.0), jgraph.RmsNormalize(-12.0), None, 1e-6),
}


@pytest.mark.parametrize("name", list(SAMPLE_NODES))
def test_sample_node_matches_jax(signal, name):
    node_t, node_j, chunk, atol = SAMPLE_NODES[name]
    g = tgraph.chain(node_t, input_rate=RATE)
    j = jgraph.chain(node_j, input_rate=RATE)
    offline = g.compile(chunked=False)(torch.from_numpy(signal))
    _close(offline, j(jnp.asarray(signal)), atol)
    assert g.streamable == j.streamable == (chunk is not None)
    if chunk is None:
        return
    assert g.chunk_granularity() == j.chunk_granularity()
    streamed = g.scan_stream(torch.from_numpy(signal), chunk)
    _close(streamed, j.scan_stream(jnp.asarray(signal), chunk), atol)
    # the streamed ops are the offline ones, in pieces
    _close(streamed, offline.numpy(), 0 if name in ("ToMono", "Gain", "Preemphasis") else 1e-6)


def test_sample_rate_is_bound_from_the_graph():
    from audioflow_torch.errors import AudioError

    for node in (tgraph.Limiter(), tgraph.Compressor(), tgraph.NoiseGate(), tgraph.Agc()):
        assert tgraph.chain(node, input_rate=22050).nodes[0].sample_rate == 22050
        with pytest.raises(AudioError):
            node.apply(torch.zeros(4096))


def test_preemphasis_step_without_graph_uses_started_flag():
    """Direct step() callers: the first chunk takes the Kaldi edge, later
    chunks the carried sample; together they equal the offline op."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 64)).astype(np.float32))
    node = tgraph.Preemphasis()
    carry = node.init_carry((2,), 32)
    carry, a = node.step(carry, x[:, :32])
    carry, b = node.step(carry, x[:, 32:])
    assert torch.equal(torch.cat([a, b], -1), tops.preemphasis(x))
    assert bool(carry[1].all())


def _stream_pair(nodes_t, nodes_j, x, chunk, rate):
    g = tgraph.Graph(nodes_t, input_rate=rate)
    j = jgraph.Graph(nodes_j, input_rate=rate)
    assert g._warmups(chunk) == j._warmups(chunk) and g.stream_latency(chunk) == j.stream_latency(chunk)
    return g, g.scan_stream(torch.from_numpy(x), chunk), np.asarray(j.scan_stream(jnp.asarray(x), chunk))


def test_preemphasis_after_resample_takes_first_index():
    """Downstream of the resampler's latency the first real sample lands
    mid-chunk: first_index puts the Kaldi edge on it, so the stream equals
    the offline chain shifted by the latency, and the JAX graph's stream."""
    x = (0.3 * np.random.default_rng(4).standard_normal((2, 3 * 4608))).astype(np.float32)
    g, streamed, want = _stream_pair(
        (tgraph.Resample(48000, 16000), tgraph.Preemphasis()),
        (jgraph.Resample(48000, 16000), jgraph.Preemphasis()), x, 4608, 48000)
    lat = g.stream_latency(4608)
    assert g.nodes[1].wants_first_index and 0 < lat < 1536 and g._warmups(4608)[1] == lat
    np.testing.assert_allclose(streamed.numpy(), want, atol=1e-5, rtol=0)
    offline = g.chain(torch.from_numpy(x))
    n = streamed.shape[-1] - lat
    np.testing.assert_allclose(streamed[..., lat:].numpy(), offline[..., :n].numpy(), atol=1e-5, rtol=0)
    # the Kaldi edge on the first real sample: (1 - k)·x[0], not x[0] - k·0
    first = g.nodes[0].apply(torch.from_numpy(x))[..., 0]
    np.testing.assert_allclose(streamed[..., lat].numpy(), (0.03 * first).numpy(), atol=1e-6, rtol=0)


SPECTRAL_NODES = {
    "Stft": ((tgraph.Stft(512, 128),), (jgraph.Stft(512, 128),), 1e-4),
    "Magnitude": ((tgraph.Stft(512, 128), tgraph.Magnitude()), (jgraph.Stft(512, 128), jgraph.Magnitude()), 1e-4),
    "Power": ((tgraph.Stft(512, 128), tgraph.Power()), (jgraph.Stft(512, 128), jgraph.Power()), 1e-3),
    "Mfcc": ((tgraph.Spectrogram(512, 128), tgraph.MelProject(40), tgraph.Mfcc(13)),
             (jgraph.Spectrogram(512, 128), jgraph.MelProject(40), jgraph.Mfcc(13)), 5e-4),
    "Cmvn": ((tgraph.Spectrogram(512, 128), tgraph.MelProject(40), tgraph.Cmvn(True)),
             (jgraph.Spectrogram(512, 128), jgraph.MelProject(40), jgraph.Cmvn(True)), 5e-4),
    "Istft": ((tgraph.Stft(512, 128), tgraph.Istft(512, 128)), (jgraph.Stft(512, 128), jgraph.Istft(512, 128)), 1e-5),
}


@pytest.mark.parametrize("name", list(SPECTRAL_NODES))
def test_spectral_node_matches_jax(name):
    nodes_t, nodes_j, atol = SPECTRAL_NODES[name]
    x = (0.3 * np.random.default_rng(5).standard_normal((2, 4096))).astype(np.float32)
    got = tgraph.Graph(nodes_t, input_rate=RATE).compile(chunked=False)(torch.from_numpy(x))
    want = np.asarray(jgraph.Graph(nodes_j, input_rate=RATE)(jnp.asarray(x)))
    if got.is_complex():
        got = torch.stack([got.real, got.imag], -1)
        want = np.stack([want.real, want.imag], -1)
    _close(got, want, atol)


def test_stft_streams_like_offline():
    x = (0.3 * np.random.default_rng(6).standard_normal((2, 8 * 512))).astype(np.float32)
    g, streamed, want = _stream_pair((tgraph.Stft(512, 128, center=False),),
                                     (jgraph.Stft(512, 128, center=False),), x, 512, RATE)
    lat = g.stream_latency(512)
    np.testing.assert_allclose(torch.view_as_real(streamed).numpy(), np.stack([want.real, want.imag], -1),
                               atol=1e-4, rtol=0)
    offline = g.chain(torch.from_numpy(x))
    n = offline.shape[-2]
    np.testing.assert_allclose(torch.view_as_real(streamed[:, lat:]).numpy(),
                               torch.view_as_real(offline[:, : streamed.shape[-2] - lat]).numpy(), atol=1e-4)
    assert n == streamed.shape[-2] - lat


def test_stft_istft_stream_takes_warmup_passthrough():
    """Stft -> Istft streamed: the Istft consumes the Stft's preroll frames
    (warmup_passthrough), so the stream is an exact reconstruction of the
    input shifted by the latency, as in the JAX package's stream."""
    x = (0.3 * np.random.default_rng(7).standard_normal((2, 8 * 512))).astype(np.float32)
    g, streamed, want = _stream_pair(
        (tgraph.Stft(512, 128, center=False), tgraph.Istft(512, 128, center=False)),
        (jgraph.Stft(512, 128, center=False), jgraph.Istft(512, 128, center=False)), x, 512, RATE)
    lat = g.stream_latency(512)
    assert g.nodes[1].warmup_passthrough and g._warmups(512)[1] == 3 and lat == 384
    # from the latency on; before it, the preroll's first samples divide
    # rounding by a window-square sum near 1e-9, in both packages
    np.testing.assert_allclose(streamed[..., lat:].numpy(), want[..., lat:], atol=1e-5, rtol=0)
    n = streamed.shape[-1] - lat
    np.testing.assert_allclose(streamed[..., lat:].numpy(), x[..., :n], atol=1e-5, rtol=0)
    offline = g.chain(torch.from_numpy(x))
    np.testing.assert_allclose(streamed[..., lat + 512 : lat + n - 512].numpy(),
                               offline[..., 512 : n - 512].numpy(), atol=1e-5, rtol=0)
