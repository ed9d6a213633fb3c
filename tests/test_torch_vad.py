"""The dictation path's ops and nodes of the port against the JAX package on
the CPU: ``quantize_i16``, ``vad_scan``, the ``Vad``, ``VadGate``,
``QuantizeI16`` and ``Mix`` nodes offline and streamed, and ``Ring`` /
``Staging``.

Tolerances: quantize and the VAD states exactly; the VAD's smoothed energy
within 1e-6 relative (the mean of squares reduces in another order in each
package; on equal energies the recurrence is bit for bit, see
``test_vad_smoothing_recurrence_is_bitwise_on_equal_energies``); i16 after the
resampler within 1 LSB; gated and mixed samples within 1e-5 (each package's
resampler and biquads round in their own order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu import graph as jg
from audioflow_tpu import ops as jops
from audioflow_tpu.ops import ring as jring
from audioflow_tpu.ops.biquad import highpass as j_highpass, lowpass as j_lowpass
from audioflow_torch import graph as tg
from audioflow_torch import ops as tops
from audioflow_torch.ops import ring as tring
from audioflow_torch.ops.biquad import highpass as t_highpass, lowpass as t_lowpass


def _speech_like(seconds, sr, seed=0, lead=()):
    """Tone and noise bursts between silences, levels clear of the -50 dB
    threshold in both directions: bursts near -20 dB, gaps near -100 dB."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = np.zeros((*lead, n), np.float32)
    pos = 0
    while pos < n:
        gap = int(rng.uniform(0.3, 0.8) * sr)
        burst = int(rng.uniform(0.2, 0.9) * sr)
        a, b = min(n, pos + gap), min(n, pos + gap + burst)
        f = rng.uniform(150, 900)
        x[..., a:b] = 0.3 * np.sin(2 * np.pi * f * t[a:b]) + 0.05 * rng.standard_normal((*lead, b - a))
        pos = b
    return (x + 1e-5 * rng.standard_normal(x.shape)).astype(np.float32)


# ------------------------------------------------------------------ quantize

@pytest.mark.parametrize("name", ["quantize_i16", "quantize_i16_round"])
def test_quantize_matches_jax_exactly(name):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-1.3, 1.3, 4000),
        [np.nan, np.inf, -np.inf, 0.99999, -0.99999, 0.5, -0.5, 0.0, -0.0, 1.0, -1.0, 16383.5 / 32767],
    ]).astype(np.float32)
    got = getattr(tops, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jops, name)(jnp.asarray(x)))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    if name == "quantize_i16":
        np.testing.assert_array_equal(got[4000:4004], [0, 32767, -32767, 32766])


def test_dequantize_matches_jax():
    q = np.arange(-32768, 32768, 7, dtype=np.int16)
    np.testing.assert_array_equal(
        tops.dequantize_i16(torch.from_numpy(q)).numpy(), np.asarray(jops.dequantize_i16(jnp.asarray(q)))
    )


# ----------------------------------------------------------------------- VAD

def _random_frames(seed, shape):
    rng = np.random.default_rng(seed)
    scale = rng.choice([0.001, 0.003, 0.01, 0.03, 0.1], shape[:-1])[..., None]
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("smoothing", [0.3, 0.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_vad_scan_matches_jax(seed, smoothing):
    frames = _random_frames(seed, (3, 300, 160))
    jcfg = jops.VadConfig(threshold_db=-60.0, smoothing_factor=smoothing)
    tcfg = tops.VadConfig(threshold_db=-60.0, smoothing_factor=smoothing)
    jc, js = jops.vad_scan(jnp.asarray(frames), jcfg)
    tc, ts = tops.vad_scan(torch.from_numpy(frames), tcfg)
    assert ts.dtype == torch.int32 and ts.shape == (3, 300)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert len(set(ts.numpy().ravel().tolist())) == 3  # all three states occur
    for name in ("silence_frames", "speech_frames", "state"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    np.testing.assert_allclose(tc.smoothed.numpy(), np.asarray(jc.smoothed), rtol=1e-6)


def test_vad_smoothing_recurrence_is_bitwise_on_equal_energies():
    """Fed the JAX package's own energies, the port's smoothed energy and
    states are bitwise the JAX scan's (one rounding per frame, as XLA's fused
    multiply-add on the CPU)."""
    frames = _random_frames(3, (4, 400, 160))
    energy = np.asarray(jops.mean_square_energy(jnp.asarray(frames), axis=-1))
    cfg = jops.VadConfig(threshold_db=-60.0)
    jc, js = jax.jit(lambda e: jax.lax.scan(
        lambda c, v: jops.vad_step(cfg, c, v), jops.vad_init((4,)), jnp.moveaxis(e, -1, 0)
    ))(jnp.asarray(energy))
    carry = tops.vad_init((4,))
    states = []
    for i in range(energy.shape[-1]):
        carry, s = tops.vad_step(tops.VadConfig(threshold_db=-60.0), carry, torch.from_numpy(energy[:, i]))
        states.append(s)
    np.testing.assert_array_equal(carry.smoothed.numpy(), np.asarray(jc.smoothed))
    np.testing.assert_array_equal(torch.stack(states).numpy(), np.asarray(js))


def test_vad_silence_tone_silence_states():
    """silence | tone | silence: states 0 ... 1 ... 2 ... 0, as the JAX package's."""
    sr = 16000
    t = np.arange(sr) / sr
    x = np.concatenate([np.zeros(sr // 2), 0.5 * np.sin(2 * np.pi * 440 * t), np.zeros(sr)]).astype(np.float32)
    frames = x[: len(x) // 320 * 320].reshape(-1, 320)
    _, ts = tops.vad_scan(torch.from_numpy(frames))
    _, js = jops.vad_scan(jnp.asarray(frames))
    s = ts.numpy()
    np.testing.assert_array_equal(s, np.asarray(js))
    assert s[0] == 0 and s[len(s) // 2] == 1 and s[-1] == 0
    runs = [int(v) for i, v in enumerate(s) if i == 0 or v != s[i - 1]]
    assert runs == [0, 1, 2, 0]


def test_vad_levels_and_helpers():
    assert {k: v.threshold_db for k, v in tops.VAD_LEVELS.items()} == {
        k: v.threshold_db for k, v in jops.VAD_LEVELS.items()
    }
    assert tg.Vad(level="relaxed").threshold_db == jg.Vad(level="relaxed").threshold_db == -40.0
    with pytest.raises(Exception, match="unknown VAD level"):
        tg.VadGate(level="loud")
    c = tops.vad_init((2,))
    assert torch.isneginf(tops.vad.vad_energy_db(c)).all() and not tops.is_speaking(c).any()


# --------------------------------------------------------------------- nodes

def _stream_pair(jgraph, tgraph, x, chunk):
    want = np.asarray(jgraph.scan_stream(jnp.asarray(x), chunk))
    got = tgraph.scan_stream(torch.from_numpy(x), chunk).numpy()
    return got, want


def test_vad_node_offline_and_streamed():
    x = _speech_like(3.0, 16000, lead=(2,))
    jgr, tgr = jg.chain(jg.Vad(320), input_rate=16000), tg.chain(tg.Vad(320), input_rate=16000)
    got = tgr.compile()(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgr.compile()(jnp.asarray(x))))
    assert set(np.unique(got.numpy())) == {0, 1, 2}
    n = x.shape[-1] // 3200 * 3200
    s_got, s_want = _stream_pair(jgr, tgr, x[:, :n], 3200)
    np.testing.assert_array_equal(s_got, s_want)
    np.testing.assert_array_equal(s_got, tgr.chain(torch.from_numpy(x[:, :n])).numpy())


@pytest.mark.parametrize("keep_ending", [True, False])
def test_vad_gate_offline_and_streamed(keep_ending):
    x = _speech_like(2.0, 16000, seed=1, lead=(2,))
    jgr = jg.chain(jg.VadGate(320, keep_ending=keep_ending), input_rate=16000)
    tgr = tg.chain(tg.VadGate(320, keep_ending=keep_ending), input_rate=16000)
    got = tgr.chain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgr.chain(jnp.asarray(x))))
    assert (got == 0).any() and (got != 0).any()
    s_got, s_want = _stream_pair(jgr, tgr, x[:, :32000], 3200)
    np.testing.assert_array_equal(s_got, s_want)
    np.testing.assert_array_equal(s_got, got[:, :32000])


def test_wire_egress_graph_within_one_lsb():
    """48 kHz -> 16 kHz cubic resample -> i16: the resamplers round in their
    own order, so a sample may land one step away."""
    from audioflow_tpu.models import wire_egress_graph as j_wire
    from audioflow_torch.models import wire_egress_graph as t_wire

    x = _speech_like(1.5, 48000, seed=2, lead=(2,))
    got = t_wire().compile()(torch.from_numpy(x)).numpy()
    want = np.asarray(j_wire().compile()(jnp.asarray(x)))
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    chunk = t_wire().chunk_granularity() * 8
    n = x.shape[-1] // chunk * chunk
    s_got, s_want = _stream_pair(j_wire(), t_wire(), x[:, :n], chunk)
    assert s_got.dtype == np.int16 and np.abs(s_got.astype(np.int32) - s_want).max() <= 1


def _mix_nodes(mod, lp, hp, combine="sum", weights=None):
    sr = 16000
    return mod.Mix(
        branches=((mod.BiquadChain((lp(1000.0, sr),)),), (mod.BiquadChain((hp(1000.0, sr),)), mod.Gain(-3.0))),
        combine=combine,
        weights=weights,
    )


@pytest.mark.parametrize("combine,weights", [("sum", None), ("mean", (0.25, 0.75)), ("max", None)])
def test_mix_offline_and_streamed(combine, weights):
    x = _speech_like(1.0, 16000, seed=3, lead=(2,))
    jgr = jg.chain(_mix_nodes(jg, j_lowpass, j_highpass, combine, weights), input_rate=16000)
    tgr = tg.chain(_mix_nodes(tg, t_lowpass, t_highpass, combine, weights), input_rate=16000)
    got = tgr.chain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgr.chain(jnp.asarray(x))), atol=1e-5)
    s_got, s_want = _stream_pair(jgr, tgr, x[:, :12800], 1280)
    np.testing.assert_allclose(s_got, s_want, atol=1e-5)
    lat = tgr.stream_latency(1280)
    np.testing.assert_allclose(s_got[:, lat:], got[:, : 12800 - lat], atol=1e-5)


def test_mix_with_latency_streams_as_shifted_offline_exactly():
    """A branch with a resampler has latency and the other none: the streamed
    mix is the offline mix shifted by one latency, as in the JAX package."""
    mix_t = tg.Mix(branches=((tg.Gain(0.0),), (tg.Resample(16000, 8000), tg.Resample(8000, 16000))))
    mix_j = jg.Mix(branches=((jg.Gain(0.0),), (jg.Resample(16000, 8000), jg.Resample(8000, 16000))))
    tgr, jgr = tg.chain(mix_t, input_rate=16000), jg.chain(mix_j, input_rate=16000)
    x = _speech_like(1.0, 16000, seed=4, lead=(2,))
    chunk = tgr.chunk_granularity() * 4
    n = x.shape[-1] // chunk * chunk
    lat = tgr.stream_latency(chunk)
    assert lat == jgr.stream_latency(chunk) > 0
    s_got, s_want = _stream_pair(jgr, tgr, x[:, :n], chunk)
    np.testing.assert_allclose(s_got, s_want, atol=1e-5)
    off = tgr.chain(torch.from_numpy(x[:, :n])).numpy()
    np.testing.assert_allclose(s_got[:, lat:], off[:, : n - lat], atol=1e-5)


# -------------------------------------------------------------- ring, staging

def test_ring_matches_jax():
    """A wrap-around sequence of writes (one partial, on overflow) and reads."""
    rng = np.random.default_rng(5)
    jr, tr = jring.ring_init(11, (2,)), tring.ring_init(11, (2,))
    for step, (w, r) in enumerate([(4, 3), (7, 0), (9, 5), (3, 8), (6, 6), (0, 2), (12, 1)]):
        if w:
            data = rng.standard_normal((2, w)).astype(np.float32)
            jr, jn = jring.ring_write(jr, jnp.asarray(data))
            tr, tn = tring.ring_write(tr, torch.from_numpy(data))
            assert tn == int(jn)
        if r:
            jr, jv, jn = jring.ring_read(jr, r)
            tr, tv, tn = tring.ring_read(tr, r)
            assert tn == int(jn)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert (tr.read_pos, tr.write_pos) == (int(jr.read_pos), int(jr.write_pos)), step
        assert tring.ring_available(tr) == int(jring.ring_available(jr))
        assert tring.ring_free(tr) == int(jring.ring_free(jr))
        np.testing.assert_array_equal(tr.buf.numpy(), np.asarray(jr.buf))
    assert tring.ring_clear(tr)[1:] == (0, 0)


def test_staging_matches_jax():
    rng = np.random.default_rng(6)
    js, ts = jring.staging_init(40, (2,)), tring.staging_init(40, (2,))
    for w, take in [(7, 0), (13, 16), (20, 16), (5, 16), (0, 16)]:
        if w:
            data = rng.standard_normal((2, w)).astype(np.float32)
            js = jring.staging_push(js, jnp.asarray(data))
            before = ts.buf.clone()
            ts = tring.staging_push(ts, torch.from_numpy(data))
        if take:
            js, jv, jn = jring.staging_take(js, take)
            before = ts.buf.clone()
            ts, tv, tn = tring.staging_take(ts, take)
            assert tn == int(jn)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert ts.count == int(js.count)
        np.testing.assert_array_equal(ts.buf.numpy(), np.asarray(js.buf))
    # functional: a push or a take never writes the buffer it was given
    st = tring.staging_push(tring.staging_init(8), torch.ones(3))
    before = st.buf.clone()
    tring.staging_take(tring.staging_push(st, torch.full((2,), 2.0)), 4)
    assert torch.equal(st.buf, before)
