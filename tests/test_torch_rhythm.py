"""The port's rhythm family (``ops/rhythm.py``; the ``OnsetStrength``,
``Tempo``, ``BeatTrack`` and ``OnlineBeats`` nodes; ``onset_frontend`` and
``beat_graph``) against the JAX package on the CPU, on seeded inputs.

Tolerances, each relative to the reference's peak unless stated:

* onset strength within ``TOL`` = 2e-6 (dB differences of the same powers,
  averaged in another order); the onset frontend behind a spectrogram within
  ``GRAPH_TOL`` = 2e-5 (the spectrogram's fp32 products in front);
* autocorrelations within ``TOL`` of lag 0 (the direct sums, cuFFT/pocketfft
  against XLA's FFT, and the fp32 DFT-bank products);
* the tempogram, normalized to 1 at lag 0, within 1e-6 absolute;
* BPM tracks within 1e-6: the same lag, divided by another rounding;
* streamed against offline: exactly (the same frames through the same
  operations).

Every rhythm decision is discrete: peak picking's ``env >= mean + delta``,
the tempo's best lag, the DP's best predecessor per frame, whether it is
positive and the best final beat, and the causal tracker's peak test and
best lag. Each comparison first asserts, on the input both packages are
given, that the decisions it reaches are clear of the packages' fp32
differences: envelope comparisons by ``ENV_MARGIN``, weighted
autocorrelations by ``LAG_MARGIN`` of the best, DP scores (sums of envelope
values and log-gap costs of order 1-100) by ``DP_MARGIN``. Where the
packages see different envelopes (the graphs), the margins add the largest
envelope difference measured between them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu import models as jmodels
from audioflow_tpu import ops as jops
from audioflow_torch import graph as tgraph
from audioflow_torch import models as tmodels
from audioflow_torch import ops as tops
from audioflow_torch.convert import state_from_leaves, state_leaves, stream_state_from_jax
from audioflow_torch.ops import rhythm as trhythm
from decision_margins import DP_MARGIN, ENV_MARGIN, LAG_MARGIN, dp_margins_clear, online_margins_clear, tempo_margin
from thread_limits import one_blas_thread_per_module, two_torch_threads_per_module  # noqa: F401  (autouse)

RATE = 16000
HOP = 256
TOL = 2e-6
GRAPH_TOL = 2e-5
TG_TOL = 1e-6
BPM_TOL = 1e-6
CHUNK = 16384


def _rel(got, want) -> float:
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _clicks(bpms, seconds: float, seed: int = 0) -> np.ndarray:
    """Onset envelopes of click tracks at ``bpms`` over a noise floor, at
    the 16 kHz / hop 256 frame rate."""
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE / HOP)
    env = 0.05 * rng.random((len(bpms), n))
    for row, bpm in zip(env, bpms):
        for k in np.arange(0.0, n, 60.0 * RATE / (HOP * bpm)):
            row[int(round(k))] += 1.0
    return env.astype(np.float32)


def _click_audio(bpms, seconds: float, seed: int = 1) -> np.ndarray:
    """Click tracks as audio: 10 ms noise bursts at each beat, -40 dB noise
    between them."""
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE)
    x = 0.01 * rng.standard_normal((len(bpms), n))
    burst = rng.standard_normal(160) * np.hanning(160)
    for row, bpm in zip(x, bpms):
        for s in np.arange(0.0, n - 160, 60.0 * RATE / bpm):
            row[int(s) : int(s) + 160] += burst
    return x.astype(np.float32)


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize("lag", [1, 2])
def test_onset_strength_matches_jax(lag):
    m = np.random.default_rng(lag).random((2, 60, 64)).astype(np.float32) ** 3
    got = tops.onset_strength(torch.from_numpy(m), lag)
    assert _rel(got, jops.onset_strength(jnp.asarray(m), lag)) < TOL
    assert (got[..., :lag] == 0).all()


def test_peak_pick_matches_jax():
    env = np.random.default_rng(4).random((3, 400)).astype(np.float32)
    t = torch.from_numpy(env)
    mean = trhythm._sliding_mean(t.double(), 10, 10) + 0.07
    assert float((t.double() - mean).abs().min()) > ENV_MARGIN  # every over-average decision clear
    for kw in ({}, {"wait": 10, "delta": 0.2}, {"pre_max": 1, "post_max": 5, "pre_avg": 3, "post_avg": 0}):
        got = tops.peak_pick(t, **kw)
        assert got.dtype == torch.bool and torch.equal(got, torch.from_numpy(np.array(jops.peak_pick(jnp.asarray(env), **kw))))


@pytest.mark.parametrize("impl,max_lag", [("direct", 30), ("fft", 200), ("matmul", 200), ("auto", 64), ("auto", 65),
                                          ("auto", None)])
def test_autocorrelate_matches_jax(impl, max_lag):
    x = np.random.default_rng(5).standard_normal((2, 300)).astype(np.float32)
    got = tops.autocorrelate(torch.from_numpy(x), max_lag, impl=impl)
    want = np.asarray(jax.jit(lambda z: jops.autocorrelate(z, max_lag, impl=impl))(jnp.asarray(x)))
    assert np.abs(got.numpy() - want).max() / np.abs(want[..., 0]).max() < TOL


def test_tempogram_and_tempo_match_jax():
    env = _clicks((90.0, 120.0, 150.0), 8.0)
    t = torch.from_numpy(env)
    tg = tops.tempogram(t)
    assert tuple(tg.shape) == (3, env.shape[-1], 384)
    assert np.abs(tg.numpy() - np.asarray(jax.jit(jops.tempogram)(jnp.asarray(env)))).max() < TG_TOL
    assert tempo_margin(t) > LAG_MARGIN
    bpm = tops.tempo(t, RATE, HOP)
    assert torch.equal(bpm, torch.from_numpy(np.array(jax.jit(lambda e: jops.tempo(e, RATE, HOP))(jnp.asarray(env)))))
    # the click tracks come back at their tempo, within one lag's step
    assert np.abs(bpm.numpy() - [90.0, 120.0, 150.0]).max() < 1.5, bpm
    assert np.array_equal(tops.tempo_frequencies(40, RATE, HOP), jops.tempo_frequencies(40, RATE, HOP))
    silent = tops.tempo(torch.zeros(2, 100), RATE, HOP)  # all-zero envelope: the start_bpm fallback
    assert torch.equal(silent, torch.full((2,), 120.0))


def test_beat_track_matches_jax():
    """The Ellis DP on click tracks, batched over three lanes and on one,
    with the tempo estimated and given."""
    env = _clicks((90.0, 120.0, 150.0), 8.0, seed=2)
    t = torch.from_numpy(env)
    dp_margins_clear(t)
    mask, bpm = tops.beat_track(t, RATE, HOP)
    j_mask, j_bpm = jax.jit(lambda e: jops.beat_track(e, RATE, HOP))(jnp.asarray(env))
    assert mask.dtype == torch.bool and torch.equal(mask, torch.from_numpy(np.array(j_mask)))
    assert torch.equal(bpm, torch.from_numpy(np.array(j_bpm)))
    period = 60.0 * RATE / (HOP * bpm.numpy())
    for row, p in zip(mask.numpy(), period):  # beats one period apart, within a frame
        gaps = np.diff(np.nonzero(row)[0])
        assert len(gaps) > 5 and np.abs(gaps - p).max() <= 1.0, (gaps, p)
    one, one_bpm = tops.beat_track(t[1], RATE, HOP, bpm=118.0)
    j_one, _ = jax.jit(lambda e: jops.beat_track(e, RATE, HOP, bpm=118.0))(jnp.asarray(env[1]))
    assert torch.equal(one, torch.from_numpy(np.array(j_one))) and float(one_bpm) == 118.0


def test_online_beat_track_matches_jax_and_streams():
    env = _clicks((100.0, 128.0), 8.0, seed=3)
    online_margins_clear(env)
    t = torch.from_numpy(env)
    beat, bpm = tops.online_beat_track(t, RATE, HOP)
    j_beat, j_bpm = jax.jit(lambda e: jops.online_beat_track(e, RATE, HOP))(jnp.asarray(env))
    assert torch.equal(beat, torch.from_numpy(np.array(j_beat)))
    assert _rel(bpm, j_bpm) < BPM_TOL
    assert beat.sum() > 10 and not beat[:, : 125].any()  # no beat in the 2 s warmup
    # chunked steps equal the offline track, shifted by post frames
    plan = tops.make_online_beat_plan(RATE, HOP)
    assert plan is tops.make_online_beat_plan(RATE, HOP) and plan.latency == 3
    carry = tops.online_beat_init(plan, (2,))
    beats = []
    for i in range(0, env.shape[-1], 37):  # chunk frame 0 is offline frame i
        carry, (b, _) = tops.online_beat_step(plan, carry, t[:, i : i + 37], first_index=-i)
        beats.append(b)
    assert torch.equal(torch.cat(beats, -1)[:, 3:], beat[:, :-3])
    assert sorted(carry) == ["acf", "emean", "peak", "period", "ring", "since"]
    assert carry["since"].dtype == torch.int32 and int(carry["since"].max()) <= 1 << 20


# ---------------------------------------------------------------- the graphs


def _online_graph(pkg):
    return pkg.chain(
        pkg.Spectrogram(1024, HOP, center=False, power=True), pkg.MelProject(n_mels=64, log=None),
        pkg.OnsetStrength(n_bins=64), pkg.OnlineBeats(hop=HOP), input_rate=RATE,
    )


@pytest.fixture(scope="module")
def audio():
    return _click_audio((96.0, 132.0), 8 * CHUNK / RATE)


@pytest.fixture(scope="module")
def envelopes(audio):
    """The onset envelope of ``audio`` (onset_frontend): the port's offline,
    the port's streamed in 16,384-sample chunks (aligned to offline), and the
    JAX package's offline; and the largest difference between any two."""
    g = tmodels.onset_frontend(RATE)
    x = torch.from_numpy(audio)
    offline = g.chain(x)[..., 0]
    lat = g.stream_latency(CHUNK)
    streamed = g.scan_stream(x, CHUNK)[:, lat:, 0]
    want = np.asarray(jax.jit(jmodels.onset_frontend(RATE).chain)(jnp.asarray(audio)))[..., 0]
    n = streamed.shape[1]
    diff = max(float((streamed - offline[:, :n]).abs().max()), float(np.abs(offline.numpy() - want).max()))
    return offline, streamed, want, diff


def test_onset_frontend_matches_jax_and_streams(envelopes):
    offline, streamed, want, _ = envelopes
    assert _rel(offline, want) < GRAPH_TOL
    assert _rel(streamed, offline[:, : streamed.shape[1]].numpy()) < GRAPH_TOL
    g = tmodels.onset_frontend(RATE)
    assert g.stream_latency(CHUNK) == jmodels.onset_frontend(RATE).stream_latency(CHUNK) == 3
    assert (streamed[:, 0] == 0).all()  # frame 0 has nothing to difference against


def test_tempo_and_beat_graph_match_jax(audio, envelopes):
    offline, _, _, diff = envelopes
    assert tempo_margin(offline) > LAG_MARGIN + diff / float(offline.abs().max())
    dp = dp_margins_clear(offline)
    assert min(dp["predecessor"], dp["sign"], dp["last"]) > DP_MARGIN + 2 * dp["beats"] * diff
    x, xj = torch.from_numpy(audio), jnp.asarray(audio)
    tg = tgraph.chain(*tmodels.onset_frontend(RATE).nodes, tgraph.Tempo(hop=HOP), input_rate=RATE)
    jg = jgraph.chain(*jmodels.onset_frontend(RATE).nodes, jgraph.Tempo(hop=HOP), input_rate=RATE)
    bpm = tg.compile()(x)
    assert tuple(bpm.shape) == (2, 1, 1) and torch.equal(bpm, torch.from_numpy(np.array(jg.compile()(xj))))
    beats = tmodels.beat_graph(RATE).compile()(x)
    assert beats.dtype == torch.float32 and tuple(beats.shape) == (2, offline.shape[-1], 1)
    assert torch.equal(beats, torch.from_numpy(np.array(jmodels.beat_graph(RATE).compile()(xj))))
    assert not tmodels.beat_graph(RATE).streamable and not tg.streamable


def test_online_beats_graph_streams_and_matches_jax(audio, envelopes):
    """The streaming beat graph: streamed equal to offline at its latency,
    and equal to the JAX package's stream."""
    offline_env, _, _, diff = envelopes
    online_margins_clear(offline_env.numpy(), env_diff=diff)
    g, j = _online_graph(tgraph), _online_graph(jgraph)
    x = torch.from_numpy(audio)
    offline = g.compile()(x)
    streamed = g.scan_stream(x, CHUNK)
    lat = g.stream_latency(CHUNK)
    assert lat == j.stream_latency(CHUNK) == 6  # the spectrogram's 3 frames and the tracker's 3
    n = streamed.shape[1] - lat
    assert torch.equal(streamed[:, lat:, 0], offline[:, :n, 0])
    assert _rel(streamed[:, lat:, 1], offline[:, :n, 1].numpy()) < BPM_TOL
    want = np.asarray(j.scan_stream(jnp.asarray(audio), CHUNK))
    assert np.array_equal(streamed[..., 0].numpy(), want[..., 0])
    assert _rel(streamed[..., 1], want[..., 1]) < BPM_TOL
    assert streamed[..., 0].sum() > 10


def test_jax_online_beats_snapshot_restores_in_the_port(audio, envelopes):
    """The JAX stream's state after 4 chunks, as a snapshot's leaves (the
    JAX ``tree_flatten`` order: the tracker's dict by sorted key) and as its
    pytree, continues in the port as the JAX stream continues."""
    offline_env, _, _, diff = envelopes
    online_margins_clear(offline_env.numpy(), env_diff=diff)
    g, j = _online_graph(tgraph), _online_graph(jgraph)
    chunks = [audio[:, i * CHUNK : (i + 1) * CHUNK] for i in range(audio.shape[-1] // CHUNK)]
    step = jax.jit(j.stream_step)
    state = j.init_state(CHUNK, (2,))
    want = []
    for i, c in enumerate(chunks):
        state, out = step(state, jnp.asarray(c))
        want.append(np.asarray(out))
        if i == 3:
            handed = jax.tree_util.tree_map(np.asarray, state)
    want = np.concatenate(want[4:], axis=-2)
    template = g.init_state(CHUNK, (2,))
    leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(handed)]
    assert [(a.shape, a.dtype) for a in state_leaves(template)] == [(a.shape, a.dtype) for a in leaves]
    for restored in (state_from_leaves(template, leaves), stream_state_from_jax(handed)):
        assert sorted(restored[0][3]) == ["acf", "emean", "peak", "period", "ring", "since"]
        got = []
        for c in chunks[4:]:
            restored, out = g.stream_step(restored, torch.from_numpy(c))
            got.append(out.numpy())
        got = np.concatenate(got, axis=-2)
        assert np.array_equal(got[..., 0], want[..., 0]) and got[..., 0].sum() > 3
        assert _rel(got[..., 1], want[..., 1]) < BPM_TOL


def test_onset_strength_node_needs_n_bins_to_stream():
    node = tgraph.OnsetStrength()
    assert not node.streamable and tgraph.OnsetStrength(n_bins=64).streamable
    with pytest.raises(Exception, match="n_bins"):
        node.validate_chunk(4)
    assert tgraph.Tempo().out_len(100) == 1 and tgraph.OnlineBeats().latency(64) == 3
