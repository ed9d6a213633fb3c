"""The port's effects family (``ops/effects.py``; the ``Delay``, ``Tremolo``,
``Vibrato``, ``Chorus`` and ``Flanger`` nodes;
``examples/echo_ensemble_spec.json``) against the JAX package on the CPU, on
seeded inputs.

Tolerances: the feedback delay and tremolo within 1e-6 of the JAX package's
peak (a multiply-add per sample, which XLA may fuse); the modulated taps
within one fp32 spacing of their read position times the signal's largest
step between samples (``_tap_tol``): both packages read at an fp32
position ``n + Dmax - d(n)`` (spacing 2^-11 below n = 8,192), and the two
``sin`` implementations move ``d`` by an ulp, which can move the read by
one spacing; the echo chain within three times that (its delay's feedback
adds up to 1 + 0.3 / 0.65 of a change, its limiter at most doubles one).
Streamed against offline: ``Delay`` and ``Tremolo`` exactly; the modulated
taps within the JAX package's documented 2e-3 (``tests/test_effects.py``),
because the stream reads from chunk-local positions."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu import ops as jops
from audioflow_tpu.config import graph_from_spec as j_from_spec
from audioflow_torch import graph as tgraph
from audioflow_torch import ops as tops
from audioflow_torch.config import graph_from_spec, graph_to_spec
from audioflow_torch.ops import effects as teff
from audioflow_torch.profiling import aten_ops

RATE = 16000
TOL = 1e-6
STREAM_ATOL = 2e-3
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def x():
    return (0.3 * np.random.default_rng(0).standard_normal((2, RATE // 2))).astype(np.float32)


def _tap_tol(x, dmax: int = 400) -> float:
    """One fp32 spacing at the last read position of ``x [..., T]`` times
    its largest step between samples."""
    spacing = 2.0 ** (np.floor(np.log2(x.shape[-1] + dmax)) - 23)
    return float(spacing * np.abs(np.diff(x, axis=-1)).max())


def _rel(got, want) -> float:
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("delay,feedback", [(300, 0.4), (7, -0.7), (5000, 0.9)])
def test_feedback_delay_matches_jax(x, delay, feedback):
    y, (xt, wt) = tops.feedback_delay(torch.from_numpy(x), delay, feedback, 0.5)
    jy, (jxt, jwt) = jops.feedback_delay(jnp.asarray(x), delay, feedback, 0.5)
    assert _rel(y, jy) < TOL and _rel(wt, jwt) < TOL
    np.testing.assert_array_equal(xt.numpy(), np.asarray(jxt))


@pytest.mark.parametrize("chunk", [1000, 300, 4096, 77])
def test_feedback_delay_streams_exactly_at_any_chunk(x, chunk):
    xt = torch.from_numpy(x)
    off, _ = tops.feedback_delay(xt, 300, 0.6, 0.4)
    carry, outs = None, []
    for i in range(0, xt.shape[-1], chunk):
        y, carry = tops.feedback_delay(xt[:, i : i + chunk], 300, 0.6, 0.4, carry)
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=-1), off)


def test_feedback_delay_launches_grow_with_blocks():
    """A host loop over the ceil(T/D) blocks: one aten op a block, plus a
    fixed set around it (no loop over samples)."""
    ops = {t: aten_ops(lambda t=t: tops.feedback_delay(torch.zeros(4, t), 2880, 0.35, 0.3)) for t in (16384, 57601)}
    blocks = {t: -(-t // 2880) for t in ops}
    assert ops[57601] - ops[16384] == blocks[57601] - blocks[16384] == 15
    with pytest.raises(ValueError):
        tops.feedback_delay(torch.zeros(4), 0)
    with pytest.raises(ValueError):
        tops.feedback_delay(torch.zeros(4), 3, feedback=1.0)


@pytest.mark.parametrize(
    "name,kw",
    [("tremolo", dict(rate_hz=4.0, depth=0.7, t0=1234)), ("vibrato", dict(rate_hz=6.0, depth_s=0.002)),
     ("chorus", dict(voices=3, t0=100)), ("flanger", dict(rate_hz=0.5, mix=0.7))],
)
def test_lfo_effect_matches_jax(x, name, kw):
    got = getattr(tops, name)(torch.from_numpy(x), RATE, **kw)
    want = getattr(jops, name)(jnp.asarray(x), RATE, **kw)
    if name == "tremolo":
        assert _rel(got, want) < TOL
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_tap_tol(x), rtol=0)


def test_modulated_tap_with_history_matches_jax(x):
    """A chunk after the first: its history and absolute offset."""
    hist = x[:, 321 - 193 : 321]  # Dmax = ceil(0.012 * 16000) + 1
    got = teff._modulated_tap(torch.from_numpy(x[:, 321:]), RATE, 1.0, 0.01, 0.002, 0.5, 321, torch.from_numpy(hist))
    from audioflow_tpu.ops import effects as jeff

    want = jeff._modulated_tap(jnp.asarray(x[:, 321:]), RATE, 1.0, 0.01, 0.002, 0.5, 321, jnp.asarray(hist))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_tap_tol(x), rtol=0)
    with pytest.raises(ValueError, match="history"):
        teff._modulated_tap(torch.from_numpy(x), RATE, 1.0, 0.01, 0.002, 0.0, 0, torch.zeros(2, 5))
    with pytest.raises(ValueError):
        tops.chorus(torch.zeros(16), RATE, voices=0)
    with pytest.raises(ValueError):
        tops.tremolo(torch.zeros(16), RATE, depth=1.5)


_NODES = [
    ("Delay", dict(delay_s=0.02, feedback=0.5, mix=0.6)),
    ("Tremolo", dict(rate_hz=4.0, depth=0.7)),
    ("Vibrato", dict(rate_hz=6.0, depth_s=0.002)),
    ("Chorus", dict(rate_hz=1.0, depth_s=0.002, base_delay_s=0.01, voices=2)),
    ("Flanger", dict(rate_hz=0.5, depth_s=0.001, base_delay_s=0.001)),
]


@pytest.mark.parametrize("name,kw", _NODES, ids=[n for n, _ in _NODES])
def test_effect_node_offline_and_streamed(x, name, kw):
    tg = tgraph.chain(getattr(tgraph, name)(**kw), input_rate=RATE)
    jg = jgraph.chain(getattr(jgraph, name)(**kw), input_rate=RATE)
    off = tg.chain(torch.from_numpy(x))
    want = np.asarray(jax.jit(jg.chain)(jnp.asarray(x)))
    if name in ("Delay", "Tremolo"):
        assert _rel(off, want) < TOL
    else:
        np.testing.assert_allclose(off.numpy(), want, atol=_tap_tol(x), rtol=0)
    chunk = 1000
    streamed = tg.scan_stream(torch.from_numpy(x), chunk)
    assert tg.stream_latency(chunk) == 0
    if name in ("Delay", "Tremolo"):
        assert torch.equal(streamed, off)
    else:
        np.testing.assert_allclose(streamed.numpy(), off.numpy(), atol=STREAM_ATOL, rtol=0)
    assert graph_from_spec(dataclasses.asdict(graph_to_spec(tg))).nodes == tg.nodes


def test_echo_ensemble_spec_matches_jax(x):
    """The example spec (Chorus -> Delay -> Limiter), offline against the
    JAX package's and streamed against offline."""
    spec = json.loads((ROOT / "examples" / "echo_ensemble_spec.json").read_text())
    tg, jg = graph_from_spec(spec), j_from_spec(spec)
    assert [type(n).__name__ for n in tg.nodes] == ["Chorus", "Delay", "Limiter"] and tg.streamable
    off = tg.chain(torch.from_numpy(x))
    np.testing.assert_allclose(off.numpy(), np.asarray(jax.jit(jg.chain)(jnp.asarray(x))), atol=3 * _tap_tol(x),
                               rtol=0)
    streamed = tg.scan_stream(torch.from_numpy(x), 2000)
    np.testing.assert_allclose(streamed.numpy(), off.numpy(), atol=STREAM_ATOL, rtol=0)


@pytest.mark.parametrize("which", ["echo", "kws", "features", "fir_deltas"])
def test_stream_state_leaves_follow_jax(which):
    """A snapshot's leaves for the new nodes' carries (the delay's tuple,
    the modulated taps' history, the PCEN smoother, the deltas' frames, the
    flux frame, the FIR prehistory): shapes and dtypes in the JAX package's
    ``tree_flatten`` order, and the port's state rebuilt from them."""
    import jax

    from audioflow_tpu import models as jmodels
    from audioflow_torch import models as tmodels
    from audioflow_torch.convert import state_from_leaves, state_leaves

    def build(mod, models):
        if which == "echo":
            return mod.chain(mod.Chorus(), mod.Delay(0.01), mod.Tremolo(), input_rate=RATE)
        if which == "kws":
            return models.kws_frontend(RATE)
        if which == "features":
            return mod.chain(mod.Spectrogram(512, 128, center=False, power=False),
                             mod.SpectralFeatures(("centroid", "flux"), n_bins=257), input_rate=RATE)
        return mod.chain(mod.Fir(num_taps=31), mod.Spectrogram(512, 128, center=False),
                         mod.MelProject(n_mels=24), mod.Deltas(orders=(1,), n_bins=24), input_rate=RATE)

    tg, jg = build(tgraph, tmodels), build(jgraph, jmodels)
    chunk = tg.chunk_granularity() * 8
    t_state = tg.init_state(chunk, (2,))
    j_leaves = jax.tree_util.tree_leaves(jg.init_state(chunk, (2,)))
    t_leaves = state_leaves(t_state)
    assert [(a.shape, a.dtype) for a in t_leaves] == [(np.shape(b), np.asarray(b).dtype) for b in j_leaves]
    back = state_from_leaves(t_state, [np.asarray(v) for v in j_leaves])
    assert [a.shape for a in state_leaves(back)] == [a.shape for a in t_leaves]
