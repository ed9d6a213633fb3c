"""The port's ``parallel`` package against the JAX package's on the CPU.

Each case runs in gloo worlds of 2 and 4 CPU processes (spawned once for
the module, every case in the same world; ``tests/torch_parallel_worker.py``
is the rank side) and is compared with the JAX function on as many of the
conftest's 8 CPU devices, computed once for the module. The ranks' shards
are concatenated along the sharded axis. Tolerances are those of
``tests/test_parallel.py``: the time-sharded graphs and the frontend in
log-mel space, the sample-domain chains 1e-5 absolute; the Kaldi fbank
with CMVN 2e-4 (both packages normalise over the same zero-tailed frame
set). The collectives are counted on each rank: the batch-sharded chain
makes none, the spectrogram one halo exchange, the resampler one per
halo it has, the IIR and the limiter one all-gather each, the DP step at
least one gradient all-reduce, and the TP forward one all-reduce.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as W
from audioflow_tpu import models as jmodels
from audioflow_tpu import ops as jops
from audioflow_tpu import parallel as jpar
from audioflow_tpu.errors import AudioError as JAudioError
from audioflow_tpu.graph import (
    Compressor, Deltas, Gain, MelProject, NoiseGate, Resample, Spectrogram, Stft, Vad, chain,
)
from audioflow_tpu.models import TrainableFrontend as JTrainable
from audioflow_tpu.ops.resample import make_plan
from audioflow_torch import parallel
from audioflow_torch.convert import trainable_from_jax, trainable_to_numpy
from audioflow_torch.errors import AudioError
from audioflow_torch.models import TrainableFrontend, make_train_step
from audioflow_torch.parallel._worlds import run_world

WORLDS = (2, 4)
WORLD_TIMEOUT = 240.0  # seconds for a whole world; also bounds each collective
FRAMED = {"spectrogram", "frontend", "graph_frontend", "graph_kaldi", "graph_kaldi_cmvn", "graph_deltas"}
TOL = {  # name: (atol, rtol); "spectrogram" is relative to the peak
    "spectrogram": (1e-5, 0), "resample_down": (2e-5, 0), "resample_up": (2e-5, 0), "fir": (1e-5, 0),
    "frontend": (1e-3, 1e-3), "iir": (1e-5, 0), "limiter": (1e-5, 0), "master": (1e-5, 0),
    "graph_master": (1e-5, 0), "graph_frontend": (1e-5, 2e-4), "graph_dynamics": (1e-5, 0),
    "graph_kaldi": (2e-4, 2e-4), "graph_kaldi_cmvn": (2e-4, 2e-4), "graph_deltas": (1e-5, 2e-4),
    "batch": (1e-5, 0),
}
TRAIN = {"dp": dict(n_fft=256, hop=128, n_mels=8, n_classes=2),
         "tp": dict(n_fft=256, hop=128, n_mels=8, n_classes=3, hidden=16)}


def _cases():
    rng = np.random.default_rng(0)
    ipb_down = make_plan(48000, 16000, "kaiser").ipb
    ipb_up = make_plan(16000, 48000, "cubic").ipb

    def noise(shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    dyn = noise((2, 4 * 4096), 0.4)
    dyn[:, : 4 * 1024] *= 0.001  # the gate's region
    cases = {
        "spectrogram": {"x": noise((2, 4 * 4096))},
        "resample_down": {"x": noise((2, 4 * ipb_down * 4)), "rates": (48000, 16000, "kaiser")},
        "resample_up": {"x": noise((2, 4 * ipb_up * 8)), "rates": (16000, 48000, "cubic")},
        "fir": {"x": noise((2, 4 * 1024)), "h": jops.fir_design(65, (2000.0,), 16000, "lowpass")},
        "frontend": {"x": noise((1, 4 * ipb_down * 8))},
        "iir": {"x": noise((2, 4 * 4096), 0.5)},
        "limiter": {"x": noise((2, 4 * 4096), 0.5)},
        "master": {"x": noise((2, 4 * 4096), 0.5)},
        "graph_master": {"x": noise((2, 4 * 4096), 0.5)},
        "graph_frontend": {"x": noise((2, 4 * ipb_down * 12), 0.3)},
        "graph_dynamics": {"x": dyn},
        "graph_kaldi": {"x": noise((2, 4 * 160 * 40), 0.3)},
        "graph_kaldi_cmvn": {"x": noise((2, 4 * 160 * 40), 0.3)},
        "graph_deltas": {"x": noise((2, 4 * 128 * 32), 0.3)},
        "batch": {"x": noise((8, 4800))},
        "errors": {},
    }
    for kind, cfg in TRAIN.items():
        params = jax.tree_util.tree_map(np.asarray, JTrainable(**cfg).init_params())
        x, y = noise((8, 2048)), rng.integers(0, cfg["n_classes"], 8).astype(np.int32)
        cases[f"train_{kind}"] = {"config": cfg, "params": params, "x": x, "y": y}
    return cases


def _graph(name):
    return {
        "graph_master": lambda: jmodels.master_chain_graph(16000),
        "graph_frontend": lambda: chain(Resample(48000, 16000, "kaiser"), Spectrogram(512, 128, center=False),
                                        MelProject(n_mels=32), input_rate=48000),
        "graph_dynamics": lambda: chain(Gain(3.0), Compressor(threshold_db=-20.0, ratio=4.0),
                                        NoiseGate(threshold_db=-55.0), input_rate=16000),
        "graph_kaldi": lambda: jmodels.kaldi_fbank_frontend(16000, n_mels=24, cmvn=False),
        "graph_kaldi_cmvn": lambda: jmodels.kaldi_fbank_frontend(16000, n_mels=24),
        "graph_deltas": lambda: chain(Spectrogram(512, 128, center=False), MelProject(n_mels=24, log="ln"),
                                      Deltas(width=9, orders=(1,), n_bins=24), input_rate=16000),
    }[name]()


def _jax(name, inp, n):
    """The JAX package's function on ``n`` of the conftest's CPU devices,
    jitted (one program, as the JAX package's tests compile them)."""
    mesh = jpar.make_mesh(n)
    x = jnp.asarray(inp["x"])
    fns = {
        "spectrogram": lambda z: jpar.sequence_sharded_spectrogram(z, mesh, 512, 256),
        "resample_down": lambda z: jpar.sequence_sharded_resample(z, mesh, *inp["rates"]),
        "resample_up": lambda z: jpar.sequence_sharded_resample(z, mesh, *inp["rates"]),
        "fir": lambda z: jpar.sequence_sharded_fir(z, mesh, inp["h"]),
        "frontend": lambda z: jpar.sequence_sharded_frontend(z, mesh, 48000, 16000, 512, 128, 32),
        "iir": lambda z: jpar.sequence_sharded_iir(z, mesh, jmodels.eq_bands_default(16000)),
        "limiter": lambda z: jpar.sequence_sharded_limiter(z, mesh),
        "master": lambda z: jpar.sequence_sharded_master(z, mesh),
    }
    if name in fns:
        return jax.jit(fns[name])(x)
    if name == "batch":
        g = chain(Resample(48000, 16000, "kaiser"), Spectrogram(512, 128, center=False), MelProject(n_mels=32),
                  input_rate=48000)
        return jpar.compile_sharded(g, mesh)(jpar.shard_batch(inp["x"], mesh))
    return jpar.compile_sharded(_graph(name), mesh, shard="time")(x)


def _jax_errors():
    mesh = jpar.make_mesh(2)
    cases = {
        "vad": lambda: jpar.sequence_sharded_graph(chain(Vad(), input_rate=16000), mesh),
        "stft": lambda: jpar.sequence_sharded_graph(chain(Stft(512, 128, center=False), input_rate=16000), mesh),
        "center": lambda: jpar.sequence_sharded_graph(chain(Spectrogram(512, 128, center=True), input_rate=16000),
                                                      mesh),
        "shard_mode": lambda: jpar.compile_sharded(chain(Spectrogram(512, 128, center=False), input_rate=16000),
                                                   mesh, shard="nope"),
        "orders": lambda: jpar.sequence_sharded_graph(chain(
            Spectrogram(512, 128, center=False), MelProject(n_mels=24, log="ln"),
            Deltas(width=9, orders=(1, 2), n_bins=24), input_rate=16000), mesh),
        "hops": lambda: jpar.sequence_sharded_spectrogram(jnp.zeros((1, 2000)), mesh, 512, 256),
        "short": lambda: jpar.sequence_sharded_spectrogram(jnp.zeros((1, 512)), mesh, 512, 256),
        "1d": lambda: jpar.sequence_sharded_spectrogram(jnp.zeros(4096), mesh, 512, 256),
    }
    out = {}
    for key, fn in cases.items():
        with pytest.raises(JAudioError) as e:
            fn()
        out[key] = e.value.code.value
    return out


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def results(cases, tmp_path_factory):
    """The worlds' results by world size, and the JAX references by (case,
    world size): the worlds run in their own processes while this one
    computes the references."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {n: pool.submit(run_world, W.run_cases, n, (cases,), timeout=WORLD_TIMEOUT,
                                  workdir=str(tmp_path_factory.mktemp(f"world{n}")))
                   for n in WORLDS}
        refs = {(name, n): np.asarray(_jax(name, inp, n)) for name, inp in cases.items()
                if name != "errors" and not name.startswith("train") for n in WORLDS}
        worlds = {n: f.result() for n, f in futures.items()}
    return worlds, refs


@pytest.fixture(scope="module")
def worlds(results):
    return results[0]


@pytest.fixture(scope="module")
def refs(results):
    return results[1]


def _ranks(worlds, n, name):
    got = [r[name] for r in worlds[n]]
    for r in got:
        assert "error" not in r, r.get("error")
    return got


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", sorted(TOL))
def test_sharded_matches_jax(worlds, refs, name, n):
    got = _ranks(worlds, n, name)
    axis = 0 if name == "batch" else (1 if name in FRAMED else -1)
    out = np.concatenate([r["out"] for r in got], axis=axis)
    want = refs[(name, n)]
    assert out.shape == want.shape and np.isfinite(out).all(), (out.shape, want.shape)
    atol, rtol = TOL[name]
    if name == "spectrogram":
        assert np.abs(out - want).max() / want.max() < atol
    else:
        np.testing.assert_allclose(out, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("n", WORLDS)
def test_collective_footprints(worlds, n):
    plan_down, plan_up = make_plan(48000, 16000, "kaiser"), make_plan(16000, 48000, "cubic")
    halos = {"resample_down": bool(plan_down.history) + bool(plan_down.lookahead),
             "resample_up": bool(plan_up.history) + bool(plan_up.lookahead)}
    want = {
        "batch": {}, "spectrogram": {"batch_isend_irecv": 1}, "fir": {"batch_isend_irecv": 1},
        "resample_down": {"batch_isend_irecv": halos["resample_down"]},
        "resample_up": {"batch_isend_irecv": halos["resample_up"]},
        "frontend": {"batch_isend_irecv": halos["resample_down"] + 1},
        "iir": {"all_gather": 1}, "limiter": {"all_gather": 1}, "master": {"all_gather": 2},
        "graph_master": {"all_gather": 2}, "graph_dynamics": {"all_gather": 2},
        "graph_kaldi_cmvn": {"batch_isend_irecv": 2, "all_reduce": 1},
    }
    for name, counts in want.items():
        for rank, r in enumerate(_ranks(worlds, n, name)):
            assert r["counts"] == counts, (name, rank, r["counts"])


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_errors_match_jax(worlds, n):
    want = _jax_errors()
    for r in _ranks(worlds, n, "errors"):
        codes = {k: v[0] for k, v in r["out"].items()}
        assert codes == want
        msgs = r["out"]
        assert "Vad" in msgs["vad"][1] and "no sequence-parallel" in msgs["vad"][1]
        assert "FFT" in msgs["stft"][1] and "not partition" in msgs["stft"][1]
        assert "center=False" in msgs["center"][1] and "unknown shard mode" in msgs["shard_mode"][1]
        assert "orders" in msgs["orders"][1]


def _single_step(inp):
    model = TrainableFrontend(**inp["config"], device="cpu")
    trainable_from_jax(model, inp["params"])
    step, _ = make_train_step(model)
    loss = step(torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"]))
    return float(loss), trainable_to_numpy(model)


@pytest.mark.parametrize("n", WORLDS)
def test_dp_step_matches_single(worlds, cases, n):
    got = _ranks(worlds, n, "train_dp")
    loss_1, p_1 = _single_step(cases["train_dp"])
    for r in got:
        loss, params, _, counts = r["out"]
        np.testing.assert_allclose(loss, loss_1, rtol=1e-5)
        for k in p_1:
            np.testing.assert_allclose(params[k], p_1[k], atol=2e-6, err_msg=k)
        assert counts.get("all_reduce", 0) >= 1, counts  # the gradients' mean


@pytest.mark.parametrize("n", WORLDS)
def test_dp_tp_step_matches_single(worlds, cases, n):
    """DP x TP on a (n/2, 2) mesh: the Megatron-split head computes the same
    step as one process, and its forward pass makes one all-reduce."""
    inp = cases["train_tp"]
    got = _ranks(worlds, n, "train_tp")
    loss_1, p_1 = _single_step(inp)
    n_model = 2
    shards = {}
    for rank, r in enumerate(got):
        loss, params, forward, _ = r["out"]
        np.testing.assert_allclose(loss, loss_1, rtol=1e-5)
        assert forward == {"all_reduce": 1}, forward
        d, m = divmod(rank, n_model)
        for k in ("mel_gain", "pcen_alpha", "pcen_delta", "pcen_r", "b2"):
            np.testing.assert_allclose(params[k], p_1[k], atol=2e-6, err_msg=k)
        shards.setdefault(d, {})[m] = params
    for d, by_m in shards.items():
        parts = [by_m[m] for m in range(n_model)]
        assert parts[0]["w1"].shape == (8, 16 // n_model) and parts[0]["w2"].shape == (16 // n_model, 3)
        for k, dim in (("w1", 1), ("b1", 0), ("w2", 0)):
            np.testing.assert_allclose(np.concatenate([p[k] for p in parts], axis=dim), p_1[k], atol=2e-6,
                                       err_msg=f"{k} of data row {d}")


@pytest.fixture
def one_rank_world():
    """A world of one gloo rank in this process, torn down after."""
    import torch.distributed as dist

    assert parallel.multihost_init(num_processes=1, backend="gloo", timeout=60) is True
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_and_batch_helpers(one_rank_world):
    """make_mesh's size and shape errors (the JAX package's codes), the
    placements, shard_batch, pad_batch and mask_lanes."""
    with pytest.raises(AudioError) as e:
        parallel.make_mesh(2, devices="cpu")
    assert e.value.code.value == "DEVICE_UNAVAILABLE"
    with pytest.raises(AudioError) as e:
        parallel.make_mesh(axes=("data", "model"), shape=(1, 2), devices="cpu")
    assert e.value.code.value == "DEVICE_UNAVAILABLE"
    with pytest.raises(JAudioError) as je:
        jpar.make_mesh(9)
    assert je.value.code.value == "DEVICE_UNAVAILABLE"
    mesh = parallel.make_mesh(devices="cpu")
    mesh2 = parallel.make_mesh(axes=("data", "model"), shape=(1, 1), devices="cpu")
    from torch.distributed.tensor import Replicate, Shard

    assert parallel.batch_sharding(mesh) == (Shard(0),)
    assert parallel.batch_sharding(mesh2, 3) == (Shard(0), Replicate())
    x = np.random.default_rng(0).standard_normal((5, 100)).astype(np.float32)
    xp, mask = parallel.pad_batch(x, mesh)
    jxp, jmask = jpar.pad_batch(x, jpar.make_mesh(8))
    assert xp.shape[0] == 5 and mask.sum() == 5 and jxp.shape[0] == 8 and jmask.sum() == 5
    xs = parallel.shard_batch(np.arange(6, dtype=np.int32), mesh)
    assert xs.dtype == torch.int32 and xs.tolist() == list(range(6))
    masked, m = parallel.mask_lanes(torch.ones(4, 3), np.array([True, False, True, False]))
    jmasked, _ = jpar.mask_lanes(jnp.ones((4, 3)), np.array([True, False, True, False]))
    np.testing.assert_array_equal(masked.numpy(), np.asarray(jmasked))
    assert m.dtype == torch.bool


def test_make_mesh_needs_a_world():
    with pytest.raises(AudioError) as e:
        parallel.make_mesh(devices="cpu")
    assert e.value.code.value == "DEVICE_UNAVAILABLE"


def test_indivisible_batch_raises(one_rank_world):
    import torch.distributed as dist

    mesh = parallel.make_mesh(devices="cpu")
    assert dist.get_world_size() == 1 and parallel.shard_batch(np.zeros((5, 10)), mesh).shape == (5, 10)
    with pytest.raises(JAudioError):
        jpar.shard_batch(np.zeros((5, 10), np.float32), jpar.make_mesh())


def test_multihost_init_honest_error_handling(monkeypatch, caplog):
    """multihost_init: an existing group -> False, real misconfiguration ->
    logged and re-raised, success -> True, the backend passed through."""
    import torch.distributed as dist

    calls = {}

    def fake_ok(backend, **kw):
        calls["args"] = (backend, kw)

    monkeypatch.setattr(dist, "init_process_group", fake_ok)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert parallel.multihost_init("10.0.0.1:1234", 2, 0, backend="gloo") is True
    backend, kw = calls["args"]
    assert backend == "gloo" and kw == {"init_method": "tcp://10.0.0.1:1234", "world_size": 2, "rank": 0}
    assert parallel.multihost_init(backend="nccl", timeout=30) is True
    assert calls["args"][0] == "nccl" and calls["args"][1]["init_method"] == "env://"
    assert calls["args"][1]["timeout"].total_seconds() == 30

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    calls.clear()
    assert parallel.multihost_init() is False and not calls
    monkeypatch.setattr(dist, "is_initialized", lambda: False)

    def fake_bad(backend, **kw):
        raise RuntimeError("Could not connect to coordinator at 10.0.0.1:1234")

    monkeypatch.setattr(dist, "init_process_group", fake_bad)
    with pytest.raises(RuntimeError, match="coordinator"):
        parallel.multihost_init("10.0.0.1:1234", 2, 1)
    assert "multi-host init failed" in caplog.text

    def fake_valueerror(backend, **kw):
        raise ValueError("process_id 7 out of range for num_processes 2")

    monkeypatch.setattr(dist, "init_process_group", fake_valueerror)
    with pytest.raises(ValueError, match="process_id"):
        parallel.multihost_init("10.0.0.1:1234", 2, 7)
    assert "misconfigured" in caplog.text
