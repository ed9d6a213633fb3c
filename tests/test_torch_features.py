"""The port's feature family (``ops/features.py``; the ``SpectralFeatures``,
``Chroma``, ``SpectralContrast``, ``Tonnetz``, ``Pcen`` and ``Deltas``
nodes; ``kws_frontend``, ``delta_fbank_frontend`` and
``examples/kws_pcen_spec.json``) against the JAX package on the CPU, on
seeded inputs.

Tolerances: the host designs (bin frequencies, chroma filterbank, contrast
bands, tonnetz basis) are float64 copied bit for bit, so equal;
``stack_memory`` moves values only, so equal; every other output within
2e-6 of the JAX package's peak (fp32 reductions in another order; PCEN's
smoother is a doubling scan where JAX runs an associative scan), 2e-5 for
spectral contrast on random magnitudes and for the whole graphs (a
spectrogram's fp32 products in front); spectral contrast behind a
spectrogram within 0.02 dB (its valleys are a band's smallest bins, down to
1e-4 of the spectral peak, where the spectrogram's fp32 error, about 1e-7
of the peak, is 1e-3 of their size). Streamed against offline:
exactly for the stateless nodes and ``SpectralFeatures``' flux carry;
``Pcen`` and ``Deltas`` within 1e-5 of the peak, the JAX package's own
streaming tolerance for them (the scan's and the regression's sums run in
another order per chunk). The rolloff picks the first bin whose cumulative
magnitude crosses a threshold; its comparison first asserts that no frame's
crossing is within 1e-5 (relative) of a tie."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu import models as jmodels
from audioflow_tpu import ops as jops
from audioflow_tpu.config import graph_from_spec as j_from_spec
from audioflow_torch import graph as tgraph
from audioflow_torch import models as tmodels
from audioflow_torch import ops as tops
from audioflow_torch.config import graph_from_spec

RATE = 16000
TOL = 2e-6
GRAPH_TOL = 2e-5
STREAM_TOL = 1e-5
CONTRAST_DB = 0.02
ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want) -> float:
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def mag():
    return np.abs(np.random.default_rng(0).standard_normal((2, 30, 257))).astype(np.float32)


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(1)
    t = np.arange(RATE // 2) / RATE
    x = 0.3 * np.sin(2 * np.pi * np.array([[261.6], [440.0]]) * t) + 0.05 * rng.standard_normal((2, RATE // 2))
    return x.astype(np.float32)


def test_host_designs_equal_jax():
    assert np.array_equal(tops.fft_frequencies(RATE, 512), jops.fft_frequencies(RATE, 512))
    for args in ((RATE, 512), (22050, 2048, 12, 0.3), (44100, 1024, 24)):
        got, want = tops.chroma_filterbank(*args), jops.chroma_filterbank(*args)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    for args in ((RATE, 512), (44100, 2048, 6, 100.0)):
        assert tops.contrast_bands(*args) == jops.contrast_bands(*args)
    for n in (12, 24):
        assert np.array_equal(tops.tonnetz_basis(n), jops.tonnetz_basis(n))
    with pytest.raises(ValueError, match="Nyquist"):
        tops.contrast_bands(8000, 512, 6, 400.0)


def _rolloff_margin(mag, roll_percent=0.85):
    cum = np.cumsum(np.asarray(mag, np.float64), axis=-1)
    return float((np.abs(cum - roll_percent * cum[..., -1:]) / cum[..., -1:]).min())


@pytest.mark.parametrize(
    "name,args",
    [("spectral_centroid", (RATE, 512)), ("spectral_bandwidth", (RATE, 512)), ("spectral_bandwidth", (RATE, 512, 1.0)),
     ("spectral_rolloff", (RATE, 512)), ("spectral_flatness", ()), ("spectral_flux", ()),
     ("spectral_flux", (False, True)), ("chroma", (RATE, 512)), ("spectral_features", (RATE, 512)),
     ("spectral_contrast", (RATE, 512)), ("delta", (9, 1)), ("delta", (5, 2)), ("add_deltas", ()), ("pcen", ())],
)
def test_spectral_op_matches_jax(mag, name, args):
    if name in ("spectral_rolloff", "spectral_features"):
        assert _rolloff_margin(mag) > 1e-5
    got = getattr(tops, name)(torch.from_numpy(mag), *args)
    want = jax.jit(lambda m: getattr(jops, name)(m, *args))(jnp.asarray(mag))
    assert _rel(got, want) < (2e-5 if name == "spectral_contrast" else TOL)


def test_flux_with_previous_frame_matches_jax(mag):
    prev = mag[:, -1:] * 0.5
    got = tops.spectral_flux(torch.from_numpy(mag), prev=torch.from_numpy(prev))
    assert _rel(got, jops.spectral_flux(jnp.asarray(mag), prev=jnp.asarray(prev))) < TOL


@pytest.mark.parametrize("name", ["zero_crossing_rate", "frame_rms"])
def test_time_domain_op_matches_jax(signal, name):
    got = getattr(tops, name)(torch.from_numpy(signal), 512, 128)
    assert _rel(got, jax.jit(lambda v: getattr(jops, name)(v, 512, 128))(jnp.asarray(signal))) < TOL


def test_tonnetz_and_stack_memory_match_jax(mag):
    c = mag[..., :12]
    assert _rel(tops.tonnetz(torch.from_numpy(c)), jops.tonnetz(jnp.asarray(c))) < TOL
    for n_steps, delay in ((3, 2), (2, -3), (2, 40)):
        got = tops.stack_memory(torch.from_numpy(mag), n_steps, delay)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jops.stack_memory(jnp.asarray(mag), n_steps, delay)))


@pytest.mark.parametrize("first_index", [None, 0, 5, -3])
def test_pcen_smoother_matches_jax(mag, first_index):
    """From a carried M and with the warm-start reseed at ``first_index``."""
    e = mag[..., :40]
    m_prev = np.random.default_rng(2).random((2, 40)).astype(np.float32)
    got = tops.pcen_smoother(torch.from_numpy(e), 0.1, torch.from_numpy(m_prev), first_index)
    want = jax.jit(lambda a, m: jops.pcen_smoother(a, 0.1, m, first_index))(jnp.asarray(e), jnp.asarray(m_prev))
    assert _rel(got[0], want[0]) < TOL and _rel(got[1], want[1]) < TOL


def _front(mod, power):
    return (mod.Spectrogram(512, 128, center=False, power=power),)


_NODES = [
    ("SpectralFeatures", False, dict(features=("centroid", "bandwidth", "rolloff", "flatness", "flux"), n_bins=257)),
    ("SpectralFeatures", False, dict(features=("centroid", "flatness"))),
    ("Chroma", True, {}),
    ("SpectralContrast", False, {}),
    ("Pcen", None, dict(n_bins=40)),
    ("Deltas", None, dict(orders=(1,), n_bins=40)),
]


@pytest.mark.parametrize("name,power,kw", _NODES, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(_NODES)])
def test_feature_node_offline_and_streamed(signal, name, power, kw):
    def build(mod):
        front = _front(mod, bool(power)) if power is not None else (
            mod.Spectrogram(512, 128, center=False), mod.MelProject(n_mels=40, log=None if name == "Pcen" else "ln"))
        return mod.chain(*front, getattr(mod, name)(**kw), input_rate=RATE)

    tg, jg = build(tgraph), build(jgraph)
    x = torch.from_numpy(signal)
    off = tg.chain(x)
    want = np.asarray(jax.jit(jg.chain)(jnp.asarray(signal)))
    if name == "SpectralContrast":
        np.testing.assert_allclose(off.numpy(), want, atol=CONTRAST_DB, rtol=0)
    else:
        assert _rel(off, want) < GRAPH_TOL
    chunk = 128 * 25
    xs = x[:, : x.shape[-1] // chunk * chunk]
    streamed = tg.scan_stream(xs, chunk)
    lat = tg.stream_latency(chunk)
    assert lat == jg.stream_latency(chunk)
    n = min(streamed.shape[-2] - lat, off.shape[-2])
    got, want = streamed[:, lat : lat + n], off[:, :n]
    if name in ("Pcen", "Deltas"):
        assert _rel(got, want) < STREAM_TOL
    else:
        assert torch.equal(got, want)


def test_tonnetz_node_and_offline_only_nodes(signal):
    tg = tgraph.chain(*_front(tgraph, True), tgraph.Chroma(), tgraph.Tonnetz(), input_rate=RATE)
    jg = jgraph.chain(*_front(jgraph, True), jgraph.Chroma(), jgraph.Tonnetz(), input_rate=RATE)
    off = tg.chain(torch.from_numpy(signal))
    assert _rel(off, jax.jit(jg.chain)(jnp.asarray(signal))) < GRAPH_TOL
    chunk = 128 * 25
    streamed = tg.scan_stream(torch.from_numpy(signal[:, : signal.shape[-1] // chunk * chunk]), chunk)
    lat = tg.stream_latency(chunk)
    n = min(streamed.shape[-2] - lat, off.shape[-2])
    assert torch.equal(streamed[:, lat : lat + n], off[:, :n])
    assert not tgraph.Pcen().streamable and not tgraph.Deltas(n_bins=40).streamable
    assert not tgraph.SpectralFeatures(("flux",)).streamable and tgraph.SpectralFeatures().streamable
    dd = tgraph.chain(*_front(tgraph, True), tgraph.Deltas(), input_rate=RATE)
    jd = jgraph.chain(*_front(jgraph, True), jgraph.Deltas(), input_rate=RATE)
    assert _rel(dd.chain(torch.from_numpy(signal)), jax.jit(jd.chain)(jnp.asarray(signal))) < GRAPH_TOL


@pytest.mark.parametrize("which", ["kws_frontend", "delta_fbank_frontend", "kws_pcen_spec"])
def test_feature_pipelines_match_jax(signal, which):
    """Offline against the JAX package's, and streamed from frame 0 (the
    PCEN reseed, the deltas' edge replication) against offline."""
    if which == "kws_pcen_spec":
        spec = json.loads((ROOT / "examples" / "kws_pcen_spec.json").read_text())
        tg, jg = graph_from_spec(spec), j_from_spec(spec)
    else:
        tg, jg = getattr(tmodels, which)(RATE), getattr(jmodels, which)(RATE)
    assert tg.streamable and [type(n).__name__ for n in tg.nodes] == [type(n).__name__ for n in jg.nodes]
    off = tg.compile()(torch.from_numpy(signal))
    assert _rel(off, jax.jit(jg.chain)(jnp.asarray(signal))) < GRAPH_TOL
    chunk = tg.chunk_granularity() * 20
    xs = signal[:, : signal.shape[-1] // chunk * chunk]
    streamed = tg.scan_stream(torch.from_numpy(xs), chunk)
    lat = tg.stream_latency(chunk)
    n = min(streamed.shape[-2] - lat, off.shape[-2])
    assert _rel(streamed[:, lat : lat + n], off[:, :n]) < STREAM_TOL


def test_fork_spec_with_the_new_nodes_crosses_packages():
    """A fork whose branches hold the new nodes: the JAX package's
    ``fork_to_spec`` loads into the port and writes back the same JSON."""
    from audioflow_tpu import config as jconfig
    from audioflow_torch import config as tconfig

    jf = jgraph.fork(
        jgraph.chain(jgraph.Fir("highpass", 101, (70.0,)), jgraph.Delay(0.05), input_rate=RATE),
        kws=jmodels.kws_frontend(RATE),
        feats=jgraph.chain(*_front(jgraph, False), jgraph.SpectralContrast(), input_rate=RATE),
    )
    spec = json.loads(json.dumps(jconfig.fork_to_spec(jf)))
    tf = tconfig.fork_from_spec(spec)
    assert [type(n).__name__ for _, g in tf.branches for n in g.nodes] == [
        "Spectrogram", "MelProject", "Pcen", "Spectrogram", "SpectralContrast"]
    assert json.loads(json.dumps(tconfig.fork_to_spec(tf))) == spec
