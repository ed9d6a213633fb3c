"""The port's YIN and pYIN against the JAX package on the CPU.

Inputs are seeded numpy fed to both packages. Host designs are compared bit
for bit; device math within stated tolerances (fp32 sums in other orders:
XLA's cumsum and FFT against torch's). The JAX pYIN runs with
``viterbi_impl="pallas"`` (its Pallas kernel in interpret mode): its
``"xla"`` scan at 0.1 semitones takes minutes to compile on a CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioflow_tpu import graph as jgraph
from audioflow_tpu import ops as jops
from audioflow_tpu.ops import pitch as jpitch
from audioflow_torch import graph as tgraph
from audioflow_torch import ops as tops
from audioflow_torch.convert import stream_state_from_jax
from audioflow_torch.errors import AudioError
from audioflow_torch.ops import pitch as tpitch

SR = 16000
# the JAX package's pYIN benchmark configuration (BENCHMARKS.md:329), the
# tests' 0.5-semitone configuration, and a narrow band
CONFIGS = [(65.0, 2093.0, 0.1, 2048), (80.0, 1200.0, 0.5, 2048), (80.0, 500.0, 0.1, 1024)]


def _tone(f0=220.0, n=SR):
    return (0.5 * np.sin(2 * np.pi * f0 * np.arange(n) / SR)).astype(np.float32)


def _vibrato(seed=0):
    """The vibrato pair with an unvoiced gap (``tests/test_pitch.py:420-426``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(SR) / SR
    x = (0.5 * np.sin(2 * np.pi * (220 + 8 * np.sin(2 * np.pi * 3 * t)) * t)).astype(np.float32)
    x[6000:8000] = 0.001 * rng.standard_normal(2000)
    return np.stack([x, np.roll(x, 1000)])


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("fmin,fmax,resolution,frame_length", CONFIGS)
def test_host_designs_bit_identical(fmin, fmax, resolution, frame_length):
    w = frame_length // 2
    t_max = min(int(np.ceil(SR / fmin)) + 1, w)
    for a, b in zip(tpitch._acf_banks(w, t_max), jpitch._acf_banks(w, t_max)):
        assert np.array_equal(a, b)
    nbps, n_bins = tpitch._pyin_bins(resolution, fmin, fmax)
    for a, b in zip(tpitch._pyin_bin_split(float(SR), fmin, n_bins, nbps, t_max + 1, 3),
                    jpitch._pyin_bin_split(float(SR), fmin, n_bins, nbps, t_max + 1, 3)):
        assert np.array_equal(a, b)
    assert np.array_equal(tpitch._pitch_bin_centers(fmin, n_bins, nbps).numpy(),
                          np.asarray(jpitch._pitch_bin_centers(fmin, n_bins, nbps, jnp.float32)))
    half, lk, stay, switch = tpitch._pyin_hmm_consts(SR, 256, nbps, 35.92, 0.01)
    jhalf, jlk, jstay, jswitch = jpitch._pyin_hmm_consts(SR, 256, nbps, 35.92, 0.01, jnp.float32)
    assert half == jhalf and np.array_equal(lk.numpy(), np.asarray(jlk))
    assert stay.item() == float(jstay) and switch.item() == float(jswitch)
    if resolution == 0.1 and fmax == 2093.0:  # the full-width configuration
        assert (n_bins, 2 * half + 1, t_max) == (602, 139, 248)
    for a, b, m in [(2.0, 18.0, 100), (1.0, 1.0, 7), (3.5, 4.5, 13)]:
        assert np.array_equal(tpitch._beta_interval_masses(a, b, m), jpitch._beta_interval_masses(a, b, m))
    assert tpitch.min_even_length(1271) == jpitch.min_even_length(1271) == 1272


@pytest.mark.parametrize("impl", ["fft", "matmul"])
def test_cmnd_frames_matches_jax(impl):
    rng = np.random.default_rng(1)
    t = np.arange(1024) / SR
    fr = (0.5 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal((2, 6, 1024))).astype(np.float32)
    got = tops.cmnd_frames(torch.from_numpy(fr), 512, 200, impl).numpy()
    want = np.asarray(jops.cmnd_frames(jnp.asarray(fr), 512, 200, impl, "highest"))
    assert got.shape == want.shape == (2, 6, 201) and (got[..., 0] == 1.0).all()
    assert _rel(got, want) < 1e-5
    assert tpitch._resolve_acf_impl("auto") == "fft"
    with pytest.raises(ValueError):
        tops.cmnd_frames(torch.from_numpy(fr), 512, 200, "dct")
    with pytest.raises(ValueError):
        tops.cmnd_frames(torch.zeros(4, 100), 80)  # needs frame >= 2 * win


@pytest.mark.parametrize("batched", [False, True])
def test_yin_matches_jax(batched):
    if batched:  # silence, a tone, a tone in noise
        x = np.zeros((3, SR // 2), np.float32)
        x[1] = _tone(330.0, SR // 2)
        x[2] = _tone(147.0, SR // 2) + 0.05 * np.random.default_rng(2).standard_normal(SR // 2)
    else:  # validate.py:202-204
        x = _tone()
    f0, ap = tops.yin_voicing(x, SR, fmin=80, fmax=1200, device="cpu")
    jf0, jap = jops.yin_voicing(jnp.asarray(x), SR, fmin=80, fmax=1200)
    jf0, jap = np.asarray(jf0), np.asarray(jap)
    assert f0.shape == jf0.shape and f0.dtype == torch.float32
    assert np.abs(f0.numpy() / jf0 - 1.0).max() < 1e-4
    assert np.abs(ap.numpy() - jap).max() < 1e-4
    if not batched:
        yin_220 = float(np.abs(f0.numpy()[4:-4] - 220.0).max() / 220.0)  # validate.py's yin_220_rel
        assert yin_220 < 5e-3
        assert torch.equal(tops.yin(x, SR, fmin=80, fmax=1200, device="cpu"), f0)


def test_yin_validation_errors():
    x = np.zeros(4096, np.float32)
    with pytest.raises(ValueError):
        tops.yin(x, SR, fmin=8000.0, fmax=9000.0, device="cpu")  # lags collapse below 2


@pytest.fixture(scope="module")
def vibrato_pyin():
    """The port's and the JAX package's pYIN of the vibrato pair at 0.5
    semitones and 32 thresholds (the JAX Viterbi in interpret mode)."""
    x = _vibrato()
    kw = dict(resolution=0.5, n_thresholds=32)
    got = tops.pyin(x, SR, 80, 1200, device="cpu", **kw)
    want = jops.pyin(jnp.asarray(x), SR, 80, 1200, viterbi_impl="pallas", **kw)
    return got, [np.asarray(w) for w in want]


def test_pyin_matches_jax(vibrato_pyin):
    (f0, vf, vp), (jf0, jvf, jvp) = vibrato_pyin
    assert f0.shape == vf.shape == vp.shape == jf0.shape == (2, 63)
    assert vf.dtype == torch.bool and np.abs(vp.numpy() - jvp).max() < 1e-5
    assert (vf.numpy() == jvf).mean() >= 0.99
    both = vf.numpy() & jvf
    assert both.sum() > 60
    assert np.median(np.abs(f0.numpy()[both] / jf0[both] - 1.0)) < 1e-4


def test_pyin_gates():
    # validate.py:336-346, pyin_220_rel
    f0, vf, _ = tops.pyin(_tone(), SR, fmin=80, fmax=1200, resolution=0.5, n_thresholds=32, device="cpu")
    f0, vf = f0.numpy()[4:-4], vf.numpy()[4:-4]
    assert vf.all() and np.abs(f0 - 220.0).max() / 220.0 < 5e-3
    # tests/test_pitch.py:256-267, voicing segmentation at the defaults
    rng = np.random.default_rng(0)
    x = _tone(n=2 * SR)
    x[: SR // 2] = 0.01 * rng.standard_normal(SR // 2).astype(np.float32)
    f0, vf, vp = (a.numpy() for a in tops.pyin(x, SR, fmin=80, fmax=500, device="cpu"))
    assert (~vf[2 : SR // 2 // 256 - 2]).all()  # noise head: unvoiced
    mid = slice(SR // 2 // 256 + 4, len(f0) - 4)
    assert vf[mid].all() and np.abs(f0[mid] - 220.0).max() < 1.0 and vp[mid].min() > 0.5


def test_pyin_validation_errors():
    x = np.zeros(4096, np.float32)
    with pytest.raises(ValueError):
        tops.pyin(x, SR, resolution=0.0, device="cpu")
    with pytest.raises(ValueError):
        tops.pyin(x, SR, switch_prob=1.5, device="cpu")
    with pytest.raises(ValueError):
        tops.pyin(x, SR, impl="dct", device="cpu")


def test_yin_node_streams_exactly_and_matches_jax():
    x = _tone(n=2 * SR)
    node = dict(fmin=80, fmax=1200, frame_length=1024, hop=256, center=False)
    g = tgraph.chain(tgraph.Yin(**node), input_rate=SR)
    out = g.chain(torch.from_numpy(x))
    assert out.shape == (122, 2) and g.streamable
    want = np.asarray(jgraph.chain(jgraph.Yin(**node), input_rate=SR).chain(jnp.asarray(x)))
    assert np.abs(out.numpy()[:, 0] / want[:, 0] - 1.0).max() < 1e-4
    chunk = g.chunk_granularity() * 8
    n = len(x) // chunk * chunk
    streamed = g.scan_stream(torch.from_numpy(x[:n]), chunk)
    lat = g.stream_latency(chunk)
    assert lat == 3 and streamed.shape == (n // 256, 2)
    m = streamed.shape[0] - lat
    assert torch.equal(streamed[lat:], out[:m])
    # compile()'s chunked form streams it, equal to the whole-array chain
    assert torch.equal(g.compile(chunked=True)(x, device="cpu"), out)
    gc = tgraph.chain(tgraph.Yin(center=True), input_rate=SR)
    assert not gc.streamable
    with pytest.raises(AudioError):
        gc.init_state(2048)


def test_jax_yin_state_continues_in_port():
    """JAX streams 2 chunks of a Yin graph, hands its state over, the port
    streams 2 more: the result equals JAX streaming all 4."""
    chunk = 2048
    x = np.stack([_tone(n=4 * chunk), _tone(330.0, 4 * chunk)])
    chunks = [x[:, i * chunk : (i + 1) * chunk] for i in range(4)]
    node = dict(fmin=80, fmax=1200, frame_length=1024, hop=256, center=False)
    j = jgraph.chain(jgraph.Yin(**node), input_rate=SR)
    g = tgraph.chain(tgraph.Yin(**node), input_rate=SR)
    step = jax.jit(j.stream_step)
    state = j.init_state(chunk, (2,))
    want = []
    for i, c in enumerate(chunks):
        state, out = step(state, jnp.asarray(c))
        want.append(np.asarray(out))
        if i == 1:
            handed = jax.tree_util.tree_map(np.asarray, state)
    pstate = stream_state_from_jax(handed, device="cpu")
    got = []
    for c in chunks[2:]:
        pstate, out = g.stream_step(pstate, torch.from_numpy(c))
        got.append(out.numpy())
    got, want = np.concatenate(got, 1), np.concatenate(want[2:], 1)
    assert got.shape == want.shape == (2, 16, 2)
    assert np.abs(got[..., 0] / want[..., 0] - 1.0).max() < 1e-4
    assert np.abs(got[..., 1] - want[..., 1]).max() < 1e-4


def test_pyin_node(vibrato_pyin):
    x = _vibrato()
    node = tgraph.Pyin(fmin=80, fmax=1200, resolution=0.5)
    g = tgraph.Graph((node,), input_rate=SR)
    assert not g.streamable and "Pyin" in tgraph.node_registry() and "Yin" in tgraph.node_registry()
    out = g.compile()(x, device="cpu")  # numpy input, on the CPU as asked
    assert out.shape == (2, 63, 3) and g.nodes[0].out_len(SR) == 63
    assert tgraph.Pyin(center=False).out_len(SR) == 55
    # the node keeps the op's ACF impl and thresholds (100): compare with the op
    f0, vf, vp = tops.pyin(x, SR, 80, 1200, resolution=0.5, device="cpu")
    assert torch.equal(out[..., 0], f0) and torch.equal(out[..., 1], vf.float()) and torch.equal(out[..., 2], vp)
    with pytest.raises(AudioError):
        g.init_state(2048)


def test_numpy_input_runs_on_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _tone(n=4096)
    g = tgraph.Graph((tgraph.Pyin(fmin=80, fmax=1200, resolution=0.5),), input_rate=SR)
    for run in (
        lambda **kw: tops.yin(x, SR, **kw),
        lambda **kw: tops.yin_voicing(x, SR, **kw)[0],
        lambda **kw: tops.pyin(x, SR, 80, 1200, resolution=0.5, n_thresholds=8, **kw)[0],
        lambda **kw: g.compile()(x, **kw),
    ):
        with pytest.raises(AudioError):
            run()
        assert run(device="cpu").device.type == "cpu"
