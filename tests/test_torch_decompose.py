"""The port's decomposition family (``ops/decompose.py``: medians, HPSS,
spectral gating, NMF; the ``Hpss`` and ``SpectralGate`` nodes; the
``denoise_master_chain`` pipeline and ``examples/denoise_master_spec.json``)
against the JAX package on the CPU, on seeded inputs.

Tolerances: the median filters are comparisons only, so equal; masks and
waveforms within 1e-5 of the JAX package's peak (fp32 STFT products in
another order), the whole mastering chain within 2e-5 (the spectral gate's
1e-5 and the EQ's, ``test_torch_master.py``); NMF from the JAX package's own initial draws within 1e-4 of
the reconstruction's peak after 30 updates (fp32 matmuls compound through
the multiplicative updates). Spectral gating decides ``log10(mag) >
thresh`` per bin and ranks frames by energy; each comparison first asserts
that on its input, at every bin, the two packages' log magnitudes and
thresholds differ by less than the bin's distance from its threshold, and
that the quiet-frame
ranking is at least 1e-5 (relative) from a tie, so no decision can flip."""

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
from audioflow_torch.ops import decompose as tdec

RATE = 16000
ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want) -> float:
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _voice(seconds=1.0, lead=(2,), seed=0, noise_db=-45.0):
    """A speech-like signal: tone bursts over a noise floor at ``noise_db``."""
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE)
    t = np.arange(n) / RATE
    x = 10 ** (noise_db / 20) * rng.standard_normal((*lead, n))
    for a, b, f in ((0.1, 0.4, 220.0), (0.55, 0.85, 330.0)):
        sl = slice(int(a * n), int(b * n))
        x[..., sl] += 0.3 * np.sin(2 * np.pi * f * t[sl]) * np.hanning(sl.stop - sl.start)
    return x.astype(np.float32)


def test_median_network_equals_jax():
    for n in (3, 5, 17, 33):
        assert tops.median_filter is not None and tdec.median_network(n) == jops.decompose.median_network(n)


@pytest.mark.parametrize(
    "size,axis,impl,n",
    [(17, -2, "network", 40), (17, -1, "network", 129), (5, -1, "auto", 129), (35, -1, "auto", 129),
     (17, -1, "sort", 129), (9, -2, "network", 3), (1, -1, "auto", 10)],
)
def test_median_filter_equals_jax(size, axis, impl, n):
    """Comparisons only: equal. n=3 < size//2 pads symmetrically more than once."""
    rng = np.random.default_rng(size + n)
    x = rng.random((2, n, n) if axis == -2 else (2, 7, n)).astype(np.float32)
    got = tops.median_filter(torch.from_numpy(x), size, axis, impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.median_filter(jnp.asarray(x), size, axis, impl)))


def test_hpss_mask_and_hpss_match_jax():
    x = _voice()
    p = np.abs(np.random.default_rng(1).standard_normal((2, 40, 129))).astype(np.float32) ** 2
    for got, want in zip(tops.hpss_mask(torch.from_numpy(p), margin=1.5), jops.hpss_mask(jnp.asarray(p), margin=1.5)):
        assert _rel(got, want) < 1e-6
    for got, want in zip(tops.hpss(torch.from_numpy(x), 512, 128), jax.jit(lambda v: jops.hpss(v, 512, 128))(jnp.asarray(x))):
        assert _rel(got, want) < 1e-5


def _ranking_margin(mag, quantile=0.1):
    """The relative gap between the k-th and (k+1)-th quietest frame energies."""
    e = np.sort(np.asarray(mag, np.float64).sum(-1), axis=-1)
    k = max(int(round(mag.shape[-2] * quantile)), 2)
    return float((np.abs(e[..., k] - e[..., k - 1]) / e[..., k]).min())


def test_noise_profile_and_smooth_match_jax():
    mag = np.abs(np.random.default_rng(2).standard_normal((2, 60, 129))).astype(np.float32)
    assert _ranking_margin(mag) > 1e-5
    for got, want in zip(tops.noise_profile(torch.from_numpy(mag)), jops.noise_profile(jnp.asarray(mag))):
        assert _rel(got, want) < 1e-6
    keep = (np.random.default_rng(3).random((2, 30, 65)) > 0.5).astype(np.float32)
    for axis in (-2, -1):
        got = tdec._smooth(torch.from_numpy(keep), 5, axis)
        assert _rel(got, jops.decompose._smooth(jnp.asarray(keep), 5, axis)) < 1e-6


def _gate_decisions_agree(x, noise=None, n_fft=512, hop=128) -> bool:
    """Whether both packages take every bin's gate decision the same way
    with room to spare: at every bin, the difference of their log10
    magnitudes plus that of their thresholds stays under the bin's distance
    from its threshold."""

    def jax_parts():
        mag = np.abs(np.asarray(jops.stft(jnp.asarray(x), n_fft, hop, impl="matmul")))
        if noise is None:
            mean, std = (np.asarray(v) for v in jops.noise_profile(jnp.asarray(mag)))
        else:
            nmag = np.abs(np.asarray(jops.stft(jnp.asarray(noise), n_fft, hop, impl="matmul")))
            logn = np.asarray(jnp.log10(jnp.maximum(jnp.asarray(nmag), 1e-10)))
            mean, std = logn.mean(-2), logn.std(-2)
        return np.asarray(jnp.log10(jnp.maximum(jnp.asarray(mag), 1e-10))), mean + 1.5 * std

    def port_parts():
        mag = tops.stft(torch.from_numpy(x), n_fft, hop, impl="matmul").abs()
        if noise is None:
            mean, std = tops.noise_profile(mag)
        else:
            logn = torch.log10(torch.clamp_min(tops.stft(torch.from_numpy(noise), n_fft, hop, impl="matmul").abs(), 1e-10))
            mean, std = logn.mean(-2), logn.std(-2, correction=0)
        return torch.log10(torch.clamp_min(mag, 1e-10)).numpy(), (mean + 1.5 * std).numpy()

    lj, tj = jax_parts()
    lt, tt = port_parts()
    if noise is None:
        assert _ranking_margin(10 ** lj) > 1e-5
    return bool((np.abs(lj - tj[..., None, :]) > np.abs(lt - lj) + np.abs(tt - tj)[..., None, :]).all())


@pytest.mark.parametrize("with_noise", [False, True], ids=["self-profile", "noise-clip"])
def test_spectral_gate_matches_jax(with_noise):
    x = _voice(seconds=0.5)
    noise = (10 ** (-45 / 20) * np.random.default_rng(9).standard_normal((2, 4000))).astype(np.float32)
    nz = noise if with_noise else None
    assert _gate_decisions_agree(x, nz)
    got = tops.spectral_gate(torch.from_numpy(x), 512, 128, noise=None if nz is None else torch.from_numpy(nz),
                             prop_decrease=0.9)
    want = jax.jit(lambda v, n: jops.spectral_gate(v, 512, 128, noise=n, prop_decrease=0.9))(
        jnp.asarray(x), None if nz is None else jnp.asarray(nz))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("loss", ["frobenius", "kl"])
def test_nmf_from_jax_init_matches_jax(loss):
    """The updates from the JAX package's initial draws (``jax.random``, in
    its order), against its ``ops.nmf``."""
    s = np.abs(np.random.default_rng(4).standard_normal((30, 65))).astype(np.float32)
    kh, kw = jax.random.split(jax.random.PRNGKey(0))
    h0 = np.array(jax.random.uniform(kh, (30, 3), jnp.float32, 0.1, 1.0))
    w0 = np.array(jax.random.uniform(kw, (3, 65), jnp.float32, 0.1, 1.0))
    h, w = tdec._nmf_updates(torch.from_numpy(s), torch.from_numpy(h0), torch.from_numpy(w0), 30, loss, 1e-10)
    jh, jw = jops.nmf(jnp.asarray(s), 3, n_iter=30, loss=loss, seed=0)
    assert _rel(h @ w, np.asarray(jh) @ np.asarray(jw)) < 1e-4
    assert _rel(h, jh) < 1e-3 and _rel(w, jw) < 1e-3


def test_nmf_is_seeded_and_separates_to_the_input():
    s = torch.from_numpy(np.abs(np.random.default_rng(5).standard_normal((2, 20, 33))).astype(np.float32))
    a, b = tops.nmf(s, 2, n_iter=5, seed=3), tops.nmf(s, 2, n_iter=5, seed=3)
    assert torch.equal(a[0], b[0]) and a[0].shape == (2, 20, 2) and a[1].shape == (2, 2, 33)
    assert not torch.equal(a[0], tops.nmf(s, 2, n_iter=5, seed=4)[0])
    x = torch.from_numpy(_voice(seconds=0.5, lead=()))
    comps, h, w = tops.nmf_separate(x, 2, 256, 64, n_iter=20)
    assert comps.shape == (2, x.shape[-1]) and h.shape[-1] == 2 and w.shape == (2, 129)
    assert (comps.sum(0) - x).abs().max() <= 1e-4 * x.abs().max()
    with pytest.raises(ValueError):
        tops.nmf(s, 0)
    with pytest.raises(ValueError, match="1-D"):
        tops.nmf_separate(x[None], 2)


@pytest.mark.parametrize("component", ["harmonic", "percussive"])
def test_hpss_node_matches_jax(component):
    x = _voice(seconds=0.5)
    tg = tgraph.chain(tgraph.Hpss(component, 512, 128), input_rate=RATE)
    jg = jgraph.chain(jgraph.Hpss(component, 512, 128), input_rate=RATE)
    assert not tg.streamable
    assert _rel(tg.compile()(torch.from_numpy(x)), jax.jit(jg.chain)(jnp.asarray(x))) < 1e-5


def test_spectral_gate_node_and_denoise_graphs_match_jax():
    """The node, ``denoise_master_chain`` and the example spec, offline."""
    x = _voice(seconds=1.0)
    assert _gate_decisions_agree(x, n_fft=1024, hop=256)
    t_gate = tgraph.chain(tgraph.SpectralGate(prop_decrease=0.9), input_rate=RATE)
    j_gate = jgraph.chain(jgraph.SpectralGate(prop_decrease=0.9), input_rate=RATE)
    assert not t_gate.streamable
    assert _rel(t_gate.chain(torch.from_numpy(x)), jax.jit(j_gate.chain)(jnp.asarray(x))) < 1e-5
    spec = json.loads((ROOT / "examples" / "denoise_master_spec.json").read_text())
    for tg, jg in ((tmodels.denoise_master_chain(RATE), jmodels.denoise_master_chain(RATE)),
                   (graph_from_spec(spec), j_from_spec(spec))):
        assert [type(n).__name__ for n in tg.nodes] == [type(n).__name__ for n in jg.nodes]
        got = tg.compile()(torch.from_numpy(x))
        assert np.isfinite(got.numpy()).all()
        assert _rel(got, jax.jit(jg.chain)(jnp.asarray(x))) < 2e-5
