"""The port's StreamSession against the JAX package's on the CPU: the same
graph and the same pushes give results identical in count, index and
finality, with data within the graph's tolerances (log-mel 5e-4, as
``test_torch_convert.py``; VAD states exactly; i16 within 1 LSB). Snapshots
restore across the packages both ways. Also the guard against writes into
shared design tensors (ROADMAP C2, C3)."""

import numpy as np
import pytest
import torch

import jax

from audioflow_tpu import graph as jg
from audioflow_tpu.models import log_mel_frontend as j_frontend
from audioflow_tpu.session import StreamSession as JSession
from audioflow_torch import graph as tg
from audioflow_torch.convert import state_from_leaves, state_leaves, stream_state_from_jax, stream_state_to_numpy
from audioflow_torch.models import log_mel_frontend as t_frontend
from audioflow_torch.session import Result, SessionState, StreamSession
from thread_limits import one_blas_thread_per_module  # noqa: F401  (autouse)

LOGMEL_TOL = 5e-4


def _signal(seconds, rate, lead=(2,), seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 900, lead)[..., None] * t) + 0.05 * rng.standard_normal((*lead, t.size))
    x[..., : rate // 4] *= 1e-4  # a quiet lead-in: the VAD sees silence, then speech
    return x.astype(np.float32)


def _dictation(mod, rate=48000):
    """The dictation fork: wire (VAD gate, i16), VAD states, log-mel features."""
    return mod.fork(
        mod.chain(mod.Resample(rate, 16000, "kaiser"), input_rate=rate),
        wire=mod.chain(mod.VadGate(320), mod.QuantizeI16(), input_rate=16000),
        vad=mod.chain(mod.Vad(320), input_rate=16000),
        features=mod.chain(mod.LogMelSpec(1024, 256, 128, center=False), input_rate=16000),
    )


def _drive(session, x, pushes):
    """Push ``x`` in pieces of the sizes in ``pushes`` (cycled), flush, and
    return the results."""
    i, k = 0, 0
    with session:
        while i < x.shape[-1]:
            n = pushes[k % len(pushes)]
            session.push(x[..., i : i + n])
            i, k = i + n, k + 1
        session.flush()
        return session.poll_all()


def _assert_same_results(got, want, compare):
    assert [(r.index, r.final) for r in got] == [(r.index, r.final) for r in want]
    for a, b in zip(got, want):
        compare(a.data, np.asarray(b.data) if not isinstance(b.data, dict) else b.data)


def _logmel_close(a, b):
    np.testing.assert_allclose(a, b, atol=LOGMEL_TOL)


def _dictation_close(a, b):
    assert a.keys() == b.keys() == {"wire", "vad", "features"}
    assert a["wire"].dtype == np.int16 and np.abs(a["wire"].astype(np.int32) - np.asarray(b["wire"])).max() <= 1
    np.testing.assert_array_equal(a["vad"], np.asarray(b["vad"]))
    np.testing.assert_allclose(a["features"], np.asarray(b["features"]), atol=LOGMEL_TOL)


@pytest.mark.parametrize("pushes", [[1000, 7777, 3], [None], [8]], ids=["ragged", "per-chunk", "blocks-of-8"])
def test_session_matches_jax_session(pushes):
    g_t, g_j = t_frontend(44100, 16000, 1024, 256, 128), j_frontend(44100, 16000, 1024, 256, 128, fused=True)
    gran = g_t.chunk_granularity()
    chunk = gran * max(1, 4096 // gran)
    assert chunk == (g_j.chunk_granularity() * max(1, 4096 // g_j.chunk_granularity()))
    sizes = [chunk] if pushes == [None] else [8 * chunk] if pushes == [8] else pushes
    cap = 17 * chunk if pushes == [8] else None
    x = _signal(1.0, 44100)
    x = x[..., : 9 * chunk + 1234]
    got = _drive(StreamSession(g_t, chunk, lead_shape=(2,), ring_capacity=cap, device="cpu"), x, sizes)
    want = _drive(JSession(g_j, chunk, lead_shape=(2,), ring_capacity=cap), x, sizes)
    assert len(got) == 10 and got[-1].final
    _assert_same_results(got, want, _logmel_close)
    # the streamed results are graph.scan_stream of the zero-padded signal
    pad = np.pad(x, ((0, 0), (0, 10 * chunk - x.shape[-1])))
    scan = g_t.scan_stream(torch.from_numpy(pad), chunk).numpy()
    np.testing.assert_array_equal(np.concatenate([r.data for r in got], axis=1), scan)


def test_dictation_fork_session_matches_jax_with_capture_cadence_pushes():
    """960-sample pushes (20 ms at 48 kHz), ragged against the fork's chunk."""
    f_t, f_j = _dictation(tg), _dictation(jg)
    chunk = f_t.chunk_granularity()
    assert chunk == f_j.chunk_granularity() == 3840
    x = _signal(1.2, 48000)
    got = _drive(StreamSession(f_t, lead_shape=(2,), device="cpu"), x, [960])
    want = _drive(JSession(f_j, lead_shape=(2,)), x, [960])
    assert len(got) == 15
    _assert_same_results(got, want, _dictation_close)
    vad = np.concatenate([r.data["vad"] for r in got], axis=1)
    assert set(np.unique(vad)) >= {0, 1}


def test_results_are_lazy_and_multi_drains_share_one_fetch():
    g = t_frontend(44100, 16000, 1024, 256, 128)
    chunk = g.chunk_granularity() * 2
    s = StreamSession(g, chunk, lead_shape=(2,), ring_capacity=17 * chunk, device="cpu").open()
    assert s.push(_signal(1.5, 44100)[..., : 8 * chunk]) == 8
    res = s.poll_all()
    assert len(res) == 8 and not any(r.materialized for r in res)
    stacked = res[0]._stacked
    assert all(r._stacked is stacked for r in res)
    res[3].data
    assert stacked._host is not None and stacked._outs is None
    assert res[3].materialized and not res[4].materialized
    assert "device" in repr(res[4]) and isinstance(res[0], Result)
    s.close()
    assert s.state is SessionState.CLOSED


def test_open_precompile_leaves_the_live_state_untouched():
    """open() steps a fresh init state: the live state stays the init state,
    and no tensor of it is written in place by a step."""
    f = _dictation(tg)
    s = StreamSession(f, lead_shape=(2,), device="cpu")
    s.open(precompile="all")
    fresh = f.init_state(s.chunk_in, (2,), torch.float32, "cpu")
    for a, b in zip(state_leaves(s._carry), state_leaves(fresh)):
        np.testing.assert_array_equal(a, b)
    carry = s._carry
    tensors = [t for t in _tensors(carry)]
    versions = [t._version for t in tensors]
    s.push(_signal(0.5, 48000)[..., : 3 * s.chunk_in + 100])
    assert [t._version for t in tensors] == versions  # steps return new tensors
    s.close()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_snapshot_restores_across_packages(tmp_path, direction):
    """One package streams half the signal and snapshots; the other restores
    and finishes it: the tail equals the uninterrupted stream."""
    f_t, f_j = _dictation(tg), _dictation(jg)
    x = _signal(1.2, 48000, seed=3)
    half = 7 * 960 * 4 + 480  # leaves samples pending in the staging buffer
    first, second = (JSession, StreamSession) if direction == "jax-to-port" else (StreamSession, JSession)

    def make(cls, graph_t, graph_j):
        return cls(graph_t, lead_shape=(2,), device="cpu") if cls is StreamSession else cls(graph_j, lead_shape=(2,))

    a = make(first, f_t, f_j).open()
    for i in range(0, half, 960):
        a.push(x[..., i : min(i + 960, half)])
    n_before = len(a.poll_all())
    a.snapshot(tmp_path / "snap")
    b = make(second, f_t, f_j).restore(tmp_path / "snap")
    assert b._chunk_index == n_before and b._pending == half % b.chunk_in
    for i in range(half, x.shape[-1], 960):
        b.push(x[..., i : i + 960])
    b.flush()
    tail = b.poll_all()
    full = _drive(StreamSession(f_t, lead_shape=(2,), device="cpu"), x, [960])
    assert [r.index for r in tail] == [r.index for r in full[n_before:]]
    for r, w in zip(tail, full[n_before:]):
        _dictation_close({k: np.asarray(v) for k, v in r.data.items()}, w.data)


def test_state_leaves_follow_jax_tree_flatten():
    """The snapshot's leaf order: jax.tree_util.tree_flatten of the JAX
    state, for the dictation fork and a Mix inside a graph."""
    for t_graph, j_graph, chunk in (
        (_dictation(tg), _dictation(jg), 3840),
        (tg.chain(tg.Mix(((tg.Gain(0.0),), (tg.Resample(16000, 8000), tg.Resample(8000, 16000)))), tg.Vad(320),
                  input_rate=16000),
         jg.chain(jg.Mix(((jg.Gain(0.0),), (jg.Resample(16000, 8000), jg.Resample(8000, 16000)))), jg.Vad(320),
                  input_rate=16000), 6400),
    ):
        t_state = t_graph.init_state(chunk, (2,))
        j_state = j_graph.init_state(chunk, (2,))
        x = _signal(0.5, t_graph.input_rate)[..., :chunk]
        t_state, _ = t_graph.stream_step(t_state, torch.from_numpy(x))
        j_state, _ = jax.jit(j_graph.stream_step)(j_state, x)
        j_leaves, treedef = jax.tree_util.tree_flatten(j_state)
        t_leaves = state_leaves(t_state)
        assert [(a.shape, a.dtype) for a in t_leaves] == [(np.shape(b), np.asarray(b).dtype) for b in j_leaves]
        # the port's leaves rebuild the JAX state, and the JAX leaves the port's
        back = jax.tree_util.tree_unflatten(treedef, t_leaves)
        assert jax.tree_util.tree_structure(back) == treedef
        again = state_from_leaves(t_state, [np.asarray(v) for v in j_leaves])
        assert [a.shape for a in state_leaves(again)] == [a.shape for a in t_leaves]
        # and the structural converters keep the JAX structure both ways
        conv = stream_state_from_jax(jax.tree_util.tree_map(np.asarray, j_state))
        assert [a.shape for a in state_leaves(conv)] == [a.shape for a in t_leaves]
        assert len(jax.tree_util.tree_leaves(stream_state_to_numpy(t_state))) == len(j_leaves)


def test_shared_design_tensors_are_never_written():
    """ROADMAP C2/C3 guard: after the ported entry points run on the CPU
    (the validate report, which reaches every kernel's plain version, and a
    session over the dictation fork), every tensor the design caches hand
    out is unwritten (``_version == 0``), and running them again leaves
    every cached numpy design as it was."""
    import importlib

    from audioflow_torch.ops.kernels import fft, griffinlim, melspec, timestretch
    from audioflow_torch.utils.cache import _DEVICE_CACHE
    from audioflow_torch.validate import run_validation

    caches = {
        "device": _DEVICE_CACHE, "bands": melspec._BANDS, "norm": timestretch._NORM_CACHE,
        "inverse": griffinlim._INV_CACHE, "twiddles": fft._TWIDDLES, "filterbanks": importlib.import_module("audioflow_torch.ops.mel")._FB_CACHE,
        "banks": importlib.import_module("audioflow_torch.ops.stft")._BANK_CACHE,
    }

    def run():
        assert run_validation(device="cpu")["pass"]
        _drive(StreamSession(_dictation(tg), lead_shape=(2,), device="cpu"), _signal(0.3, 48000), [960])

    def entries():
        out = []
        for name, cache in caches.items():
            with cache._lock:
                items = list(cache._data.items())
            for key, value in items:
                for i, leaf in enumerate(_leaves(value)):
                    out.append(((name, key, i), leaf))
        return out

    run()
    before = {k: v.copy() for k, v in entries() if isinstance(v, np.ndarray)}
    run()
    tensors = [(k, v) for k, v in entries() if isinstance(v, torch.Tensor)]
    assert tensors
    assert [k for k, v in tensors if v._version != 0] == []
    changed = [k for k, v in entries() if isinstance(v, np.ndarray) and k in before
               and not np.array_equal(v, before[k], equal_nan=True)]
    assert changed == []


def _leaves(value):
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _leaves(v)
    else:
        yield value
