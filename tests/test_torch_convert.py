"""Stream state carried between the JAX package and the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu.models import log_mel_frontend as jax_frontend
from audioflow_torch.convert import stream_state_from_jax, stream_state_to_numpy
from audioflow_torch.models import log_mel_frontend

CHUNK = 14112


@pytest.mark.parametrize("fused", [True, False])
def test_jax_state_continues_in_port(fused):
    """JAX streams 2 chunks, hands its state over, the port streams 2 more:
    the result equals JAX streaming all 4."""
    x = np.random.default_rng(1).standard_normal((2, 4 * CHUNK)).astype(np.float32)
    chunks = [x[:, i * CHUNK : (i + 1) * CHUNK] for i in range(4)]
    j = jax_frontend(44100, 16000, 1024, 256, 128, center=False, fused=fused)
    g = log_mel_frontend(44100, 16000, 1024, 256, 128, fused=fused)

    step = jax.jit(j.stream_step)
    state = j.init_state(CHUNK, (2,))
    want = []
    for i, c in enumerate(chunks):
        state, out = step(state, jnp.asarray(c))
        want.append(np.asarray(out))
        if i == 1:
            handed = jax.tree_util.tree_map(np.asarray, state)

    pstate = stream_state_from_jax(handed, device="cpu")
    assert pstate[2] == 2
    got = []
    for c in chunks[2:]:
        pstate, out = g.stream_step(pstate, torch.from_numpy(c))
        got.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(got, 1), np.concatenate(want[2:], 1), atol=5e-4)


def test_state_round_trip():
    g = log_mel_frontend(44100, 16000, 1024, 256, 128)
    state = g.init_state(CHUNK, (2,))
    state, _ = g.stream_step(state, torch.from_numpy(np.ones((2, CHUNK), np.float32)))
    np_state = stream_state_to_numpy(state)
    carries, pendings, k = np_state
    assert k == np.int32(1) and k.dtype == np.int32
    jc, jp, _ = jax_frontend(44100, 16000, 1024, 256, 128, fused=True).init_state(CHUNK, (2,))
    assert [None if a is None else a.shape for a in carries + pendings] == [
        None if a is None else a.shape for a in jc + jp
    ]
    back = stream_state_from_jax(np_state)
    for a, b in zip(back[0] + back[1], state[0] + state[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert back[2] == state[2]


def _config5(fused):
    from audioflow_tpu.models import eq_bands_default as jax_bands
    from audioflow_torch.models import eq_bands_default

    return (jax_frontend(44100, 16000, 1024, 256, 128, eq=jax_bands(16000.0), center=False, fused=fused),
            log_mel_frontend(44100, 16000, 1024, 256, 128, eq=eq_bands_default(16000.0), fused=fused))


def _dynamics_chain():
    """Every new kind of carry: the IIR state, the scalar envelope and AGC
    gain carries, and Preemphasis' (sample, started) tuple behind a
    resampler's latency."""
    from audioflow_tpu import graph as jg
    from audioflow_tpu.models import eq_bands_default as jax_bands
    from audioflow_torch import graph as tg
    from audioflow_torch.models import eq_bands_default

    def build(g, bands):
        return g.chain(g.Resample(44100, 16000), g.BiquadChain(bands), g.Agc(block=512), g.Compressor(-25.0, 3.0),
                       g.NoiseGate(-40.0), g.Preemphasis(), g.Limiter(-3.0), input_rate=44100)

    return build(jg, jax_bands(16000.0)), build(tg, eq_bands_default(16000.0))


def _stft_istft():
    from audioflow_tpu import graph as jg
    from audioflow_torch import graph as tg

    def build(g):
        return g.chain(g.Resample(44100, 16000), g.Stft(1024, 256, center=False), g.Istft(1024, 256, center=False),
                       input_rate=44100)

    return build(jg), build(tg)


@pytest.mark.parametrize("case,atol", [("config5-fused", 5e-4), ("config5-plain", 5e-4), ("dynamics", 1e-5),
                                       ("stft-istft", 1e-5)])
def test_new_carries_cross_both_ways(case, atol):
    """JAX streams 2 chunks and hands its state to the port, which streams
    2 more: the JAX package's own remaining output. And back: the port's
    state after 2 chunks, handed to JAX, continues the JAX stream."""
    j, g = {"config5-fused": lambda: _config5(True), "config5-plain": lambda: _config5(False),
            "dynamics": _dynamics_chain, "stft-istft": _stft_istft}[case]()
    x = (0.3 * np.random.default_rng(2).standard_normal((2, 4 * CHUNK))).astype(np.float32)
    chunks = [x[:, i * CHUNK : (i + 1) * CHUNK] for i in range(4)]
    step = jax.jit(j.stream_step)
    state = j.init_state(CHUNK, (2,))
    want = []
    for i, c in enumerate(chunks):
        state, out = step(state, jnp.asarray(c))
        want.append(np.asarray(out))
        if i == 1:
            handed = jax.tree_util.tree_map(np.asarray, state)
    want = np.concatenate(want[2:], -2 if want[0].ndim == 3 else -1)
    axis = -2 if want.ndim == 3 else -1

    pstate = stream_state_from_jax(handed, device="cpu")
    got = []
    for c in chunks[2:]:
        pstate, out = g.stream_step(pstate, torch.from_numpy(c))
        got.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(got, axis), want, atol=atol, rtol=0)

    pstate = g.init_state(CHUNK, (2,))
    for c in chunks[:2]:
        pstate, _ = g.stream_step(pstate, torch.from_numpy(c))
    jstate = jax.tree_util.tree_map(jnp.asarray, stream_state_to_numpy(pstate))
    back = []
    for c in chunks[2:]:
        jstate, out = step(jstate, jnp.asarray(c))
        back.append(np.asarray(out))
    np.testing.assert_allclose(np.concatenate(back, axis), want, atol=atol, rtol=0)
