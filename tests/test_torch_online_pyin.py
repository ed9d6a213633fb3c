"""The port's streaming pYIN (``ops.pyin_online``, ``online_pyin_step``, the
``OnlinePyin`` node) and ``piptrack`` against the JAX package on the CPU,
on seeded inputs.

The online tracker's configuration is the JAX package's test one (8 kHz,
frame 512, hop 128, 0.5-semitone bins, 16 thresholds, ``tests/test_pitch.py``)
on a vibrato pair, so that the decode is nontrivial. Its emissions pass
through discrete decisions (the band's and the final state's first maxima,
the track picks, the lag walk, the refinement's first maximum), so they are
compared where the decisions that reach them are the same in both
packages, and each place where they differ must be a near tie, within the
packages' message differences there
(``tests/decision_margins.py::online_pyin_flips_explained``): the JAX
package's raw step runs one frame a call, so that its messages after every
frame are read, and its decisions follow from them. Where equal: the voicing exactly, f0 within ``F0_RTOL`` = 1e-5 relative (the
candidate's refined lag through another FFT), the voiced probability on
every frame within ``VP_TOL`` = 1e-5 (frame-local sums, no decision).
Streamed against offline: exactly, for two chunk sizes. Against the
offline Viterbi outside the lag window on a steady tone: the JAX test's
bound, voicing equal and f0 within 1e-6 relative. piptrack: the candidate
masks exactly, the values within ``PIP_TOL`` = 1e-5 of the peak.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu import ops as jops
from audioflow_tpu.ops import pitch as jpitch
from audioflow_torch import graph as tgraph
from audioflow_torch import ops as tops
from audioflow_torch.errors import AudioError
from audioflow_torch.ops import pitch as tpitch
from decision_margins import online_pyin_flips_explained, online_pyin_prev_maps, online_pyin_trace
from thread_limits import one_blas_thread_per_module, two_torch_threads_per_module  # noqa: F401  (autouse)

SR = 8000
CFG = dict(fmin=100.0, fmax=400.0, frame_length=512, hop=128, lag=10)
KW = dict(n_thresholds=16, resolution=0.5)
F0_RTOL = 1e-5
VP_TOL = 1e-5
PIP_TOL = 1e-5


def _vibrato_pair(seconds=2.5, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f_tr = 180 + 40 * np.sin(2 * np.pi * 0.7 * t)
    x = (0.4 * np.sin(2 * np.pi * np.cumsum(f_tr) / SR)).astype(np.float32)
    x += 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    gap = slice(int(0.3 * len(x)), int(0.34 * len(x)))  # an unvoiced gap
    x[gap] = 0.001 * rng.standard_normal(gap.stop - gap.start).astype(np.float32)
    return np.stack([x, np.roll(x, 3000)]), f_tr


def _plan():
    return tops.make_online_pyin_plan(SR, CFG["fmin"], CFG["fmax"], CFG["frame_length"], CFG["hop"], CFG["lag"], **KW)


@pytest.fixture(scope="module")
def online():
    """The port's emissions on the vibrato pair, the JAX package's raw step
    run one frame a call (jitted once; its state carried, so its messages
    after every frame are read), and where the port's decisions are clear
    of the packages' differences."""
    x, _ = _vibrato_pair()
    plan = _plan()
    got = tops.pyin_online(x, SR, CFG["fmin"], CFG["fmax"], CFG["frame_length"], CFG["hop"], CFG["lag"],
                           device="cpu", **KW)
    fr = tops.frame(torch.from_numpy(x), CFG["frame_length"], CFG["hop"])
    step = jax.jit(functools.partial(jops.online_pyin_step, plan))
    state = jops.online_pyin_init(plan, (2,))
    want, msgs = [], []
    for t in range(fr.shape[1]):
        state, out = step(state, jnp.asarray(fr[:, t : t + 1].numpy()))
        want.append([np.asarray(a) for a in out])
        msgs.append(np.concatenate([np.asarray(state["dv"]), np.asarray(state["du"])], axis=-1))
    want = [np.concatenate(a, axis=-1) for a in zip(*want)]
    port = online_pyin_trace(plan, fr)
    jobs = jpitch._pyin_observations(jnp.asarray(fr.numpy()), SR, CFG["fmin"], CFG["fmax"], **KW)
    jmsg = np.stack(msgs)
    ref = {"msg": jmsg, "prev": online_pyin_prev_maps(plan, jmsg), "n_bins": plan.n_bins,
           "score": np.moveaxis(np.where(np.asarray(jobs[2]), np.asarray(jobs[3]), -1.0), -2, 0),
           "bins": np.moveaxis(np.asarray(jobs[5]), -2, 0)}
    score_diff = float(np.abs(port["score"] - ref["score"]).max())
    clear = online_pyin_flips_explained(plan, port, ref, score_diff)["equal"]
    return x, got, want, clear


def test_plan_matches_jax_and_validates():
    for kw in ({}, dict(fmin=100.0, fmax=400.0, frame_length=512, hop=128, lag=10, **KW)):
        got, want = tops.make_online_pyin_plan(16000, **kw), jops.make_online_pyin_plan(16000, **kw)
        assert isinstance(got, tops.OnlinePyinPlan)
        assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
            f: getattr(want, f) for f in want.__dataclass_fields__}
        assert (got.nbps, got.n_bins, got.t_max) == (want.nbps, want.n_bins, want.t_max)
    assert (tops.make_online_pyin_plan(16000).n_bins, tops.make_online_pyin_plan(16000).t_max) == (602, 248)
    for bad in (dict(lag=0), dict(resolution=0.0), dict(switch_prob=1.5)):
        with pytest.raises(ValueError):
            jops.make_online_pyin_plan(8000, **bad)
        with pytest.raises(ValueError):
            tops.make_online_pyin_plan(8000, **bad)
    state = tops.online_pyin_init(_plan(), (2,))
    jstate = jops.online_pyin_init(_plan(), (2,))
    assert set(state) == set(jstate) and state["seen"] == 0
    for k in set(state) - {"seen"}:
        assert tuple(state[k].shape) == jstate[k].shape and np.array_equal(state[k].numpy(), np.asarray(jstate[k]))


def test_online_pyin_emissions_match_jax(online):
    """Every raw emission, warm-up frames included, where clear."""
    _, (f0, vf, vp), (jf0, jvf, jvp), clear = online
    assert f0.shape == vf.shape == vp.shape == jf0.shape == (2, 153) and vf.dtype == torch.bool
    assert clear.mean() > 0.9, clear.mean()
    assert np.array_equal(vf.numpy()[clear], jvf[clear])
    assert np.abs(f0.numpy()[clear] / jf0[clear] - 1.0).max() <= F0_RTOL
    assert np.abs(vp.numpy() - jvp).max() <= VP_TOL
    decoded = vf.numpy()[:, CFG["lag"]:]
    assert 0.8 < decoded.mean() < 1.0  # the gap decodes unvoiced


def test_online_pyin_step_chunks_equal_one_call():
    """The raw step over two chunks, the state carried (its frame clock a
    host int), equals one call over all frames, also with skip_first."""
    x, _ = _vibrato_pair(1.0)
    fr = tops.frame(torch.from_numpy(x), CFG["frame_length"], CFG["hop"])
    plan = _plan()
    for skip in (0, 3):
        s0 = tops.online_pyin_init(plan, (2,))
        _, whole = tops.online_pyin_step(plan, s0, fr, skip_first=skip)
        s1, a = tops.online_pyin_step(plan, s0, fr[:, :20], skip_first=skip)
        s2, b = tops.online_pyin_step(plan, s1, fr[:, 20:], skip_first=skip)
        assert s1["seen"] == 20 and s2["seen"] == fr.shape[1] and s0["seen"] == 0
        for w, p, q in zip(whole, a, b):
            assert torch.equal(w, torch.cat([p, q], dim=-1))


@pytest.mark.parametrize("mult", [4, 16])
def test_online_pyin_node_streams_exactly(online, mult):
    x, (f0, vf, vp), _, _ = online
    node = tgraph.OnlinePyin(**CFG, **KW)
    g = tgraph.chain(node, input_rate=SR)
    offline = g.chain(torch.from_numpy(x))
    # the node's offline form is the emission timeline realigned by lag
    lag = CFG["lag"]
    assert torch.equal(offline[..., : -lag, 0], f0[..., lag:]) and torch.equal(offline[..., : -lag, 1], vf[..., lag:].float())
    jnode = jgraph.chain(jgraph.OnlinePyin(**CFG, **KW), input_rate=SR).nodes[0]
    chunk = g.chunk_granularity() * mult
    lat = g.stream_latency(chunk)
    assert lat == node.latency(chunk) == jnode.latency(chunk) == node._carry_len // node.hop + lag
    assert node.out_len(chunk) == jnode.out_len(chunk) and node.chunk_multiple() == jnode.chunk_multiple()
    n_use = x.shape[-1] // chunk * chunk
    streamed = g.scan_stream(torch.from_numpy(x[:, :n_use]), chunk)
    n = streamed.shape[-2] - lat
    assert n > 100 and torch.equal(streamed[:, lat : lat + n], offline[:, :n])
    assert "OnlinePyin" in tgraph.node_registry()


def test_online_pyin_agrees_with_offline_decode_on_steady_pitch():
    """Fixed-lag smoothing equals the whole-sequence Viterbi outside the lag
    window on a steady tone (``tests/test_pitch.py:344-365``)."""
    rng = np.random.default_rng(1)
    t = np.arange(2 * SR) / SR
    x = (0.4 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32) + 0.01 * rng.standard_normal(t.shape).astype(np.float32)
    lag = 12
    f0, vf, _ = tops.pyin_online(x, SR, 100.0, 400.0, 512, 128, lag, device="cpu", **KW)
    of0, ovf, _ = tops.pyin_frames(tops.frame(torch.from_numpy(x), 512, 128), SR, 100.0, 400.0, hop=128, **KW)
    dec_f0, dec_vf = f0.numpy()[lag:], vf.numpy()[lag:]
    n = dec_f0.shape[0]
    sl = slice(5, n - 5)
    assert (dec_vf[sl] == ovf.numpy()[:n][sl]).all()
    np.testing.assert_allclose(dec_f0[sl], of0.numpy()[:n][sl], rtol=1e-6)


def test_piptrack_matches_jax():
    rng = np.random.default_rng(4)
    t = np.arange(22050) / 22050
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.3 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    s = np.abs(np.asarray(jops.stft(jnp.asarray(np.stack([x, x + 0.01 * rng.standard_normal(x.shape).astype(np.float32)])),
                                    2048, 512)))
    for kw in (dict(fmin=150, fmax=2000), dict()):
        p, m = tops.piptrack(s, 22050, 2048, device="cpu", **kw)
        jp, jm = (np.asarray(a) for a in jops.piptrack(jnp.asarray(s), 22050, 2048, **kw))
        assert p.shape == m.shape == s.shape
        assert np.array_equal(p.numpy() > 0, jp > 0) and np.array_equal(m.numpy() > 0, jm > 0)
        assert np.abs(p.numpy() - jp).max() <= PIP_TOL * jp.max()
        assert np.abs(m.numpy() - jm).max() <= PIP_TOL * jm.max()
    mid = p.numpy()[0, 5:-5]
    assert all((np.abs(mid - f) < 2.0).any(axis=-1).all() for f in (440.0, 1000.0))


def test_numpy_input_runs_on_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _ = _vibrato_pair(0.5)
    s = np.abs(np.random.default_rng(0).standard_normal((4, 513))).astype(np.float32)
    g = tgraph.chain(tgraph.OnlinePyin(**CFG, **KW), input_rate=SR)
    for run in (
        lambda **kw: tops.pyin_online(x, SR, 100.0, 400.0, 512, 128, 10, **kw, **KW)[0],
        lambda **kw: tops.piptrack(s, SR, 1024, **kw)[0],
        lambda **kw: g.compile()(x, **kw),
        lambda **kw: g.scan_stream(x[:, :2048], 512, **kw),
    ):
        with pytest.raises(AudioError):
            run()
        assert run(device="cpu").device.type == "cpu"
    with pytest.raises(AudioError):
        tgraph.chain(tgraph.OnlinePyin(), input_rate=None).nodes[0].apply(torch.zeros(4096))
