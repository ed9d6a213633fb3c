"""The port's Griffin-Lim path against the JAX package on the CPU.

Inputs are seeded numpy (the JAX kernel test's signal: batch 2 x 1.5 s at
16 kHz, a 440 + 880 Hz tone with noise and a pure tone) fed to both packages.
On the CPU the fused kernel's wrapper runs its plain version, which is held
against the JAX Pallas kernel in interpret mode.

Full Griffin-Lim audio is not comparable elementwise between two
implementations: magnitude replacement divides by |a|, so rounding at weak
bins becomes an O(1) phase difference (the zero-phase start on a pure tone
does so within one iteration: a rebuilt bin of 3e-4 beside a target of 25).
So a single projection is compared elementwise, a seeded random start phase
makes one whole iteration well conditioned enough to compare, and longer runs
are compared by spectral convergence and the true-phase oracle.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import ops as jops
from audioflow_tpu.ops.pallas import griffinlim as jgl
from audioflow_torch import graph as tgraph
from audioflow_torch import ops as tops
from audioflow_torch.errors import AudioError
from audioflow_torch.models import stft_magnitude_graph
from audioflow_torch.ops.kernels import griffinlim as tgl

jstft = importlib.import_module("audioflow_tpu.ops.stft")  # ops.stft names a function


def _signal(batch=2, seconds=1.5, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    rows = [
        0.5 * np.sin(2 * np.pi * 440.0 * t)
        + 0.2 * np.sin(2 * np.pi * 880.0 * t + 0.7)
        + 0.02 * rng.standard_normal(t.size)
    ]
    for b in range(1, batch):
        rows.append(0.4 * np.sin(2 * np.pi * (200.0 + 60 * b) * t))
    return np.stack(rows).astype(np.float32)


def _mag(x, n_fft=1024, hop=256):
    """|stft(x)| as numpy (the port's stft, within 1e-6 of the JAX one), fed to both packages."""
    return tops.stft(torch.from_numpy(np.array(x, np.float32)), n_fft, hop).abs().numpy()


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def _specconv(y, mag, n_fft=1024, hop=256):
    """||(|stft(y)| - mag)|| / ||mag||, the JAX kernel test's quality metric."""
    m2 = _mag(np.asarray(y), n_fft, hop)[..., : mag.shape[-2], :]
    return float(np.linalg.norm(m2 - mag) / np.linalg.norm(mag))


def _state(mag, phase):
    m = torch.from_numpy(mag)
    if phase is None:
        return m, torch.zeros_like(m), m
    p = torch.from_numpy(phase)
    return m * torch.cos(p), m * torch.sin(p), m


@pytest.fixture(scope="module")
def mag():
    return _mag(_signal())


def test_host_designs_bit_identical():
    """Banks and the WOLA row inverse, as the JAX wrapper designs them
    (pallas/griffinlim.py:280-299), bit for bit."""
    n_fft, hop, window, f = 1024, 256, "hann", 94
    w = jops.get_window(window, n_fft, periodic=True).astype(np.float64)
    ci, si = jstft._idft_banks(n_fft)
    d = tgl.designs(n_fft, hop, window, f, "cpu")
    bk, got_inv = d.banks, d.inv
    assert np.array_equal(d.window.numpy(), w.astype(np.float32))
    assert np.array_equal(bk.icos.numpy(), (np.asarray(ci, np.float64) * w[None, :]).astype(np.float32))
    assert np.array_equal(bk.isin.numpy(), (np.asarray(si, np.float64) * w[None, :]).astype(np.float32))
    cosb, sinb = jstft._dft_banks(n_fft, window, None)
    assert np.array_equal(bk.cos.numpy(), cosb) and np.array_equal(bk.sin.numpy(), sinb)
    k = n_fft // hop
    wsq = (w * w).reshape(k, hop)
    wsum = np.zeros((128, hop), np.float64)  # the JAX wrapper's padded rows
    for j in range(k):
        wsum[j : min(j + f, f + k - 1)] += wsq[j]
    inv = np.where(wsum > 0, 1.0 / np.maximum(wsum, 1e-11), 1.0).astype(np.float32)
    assert np.array_equal(got_inv.numpy(), inv[: f + k - 1])
    assert got_inv.numpy()[0, 0] == 1.0  # the periodic window's zero: wsum 0 there


# one projection, every frame (the edge frames included): zero start phase
# with no momentum; a random start phase with momentum 0.99; k = 2 on a
# magnitude with exact zeros
@pytest.mark.parametrize("case", ["plain", "phase_momentum", "k2_zeros"])
def test_single_projection_matches_pallas_interpret(mag, case):
    n_fft, hop, momentum, phase = 1024, 256, 0.0, None
    if case == "phase_momentum":
        momentum = 0.99
        phase = np.random.default_rng(1).uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    if case == "k2_zeros":
        n_fft = 512
        mag = _mag(_signal(), n_fft, hop)
        mag[:, :, ::7] = 0.0
        mag[:, 5] = 0.0
    want = np.asarray(
        jgl.griffin_lim_pallas(
            jnp.asarray(mag), n_fft, hop, n_iter=1, momentum=momentum,
            init_phase=None if phase is None else jnp.asarray(phase),
            precision="highest", interpret=True, _debug_rebuilt=True,
        )
    )
    r_re, r_im, m = _state(mag, phase)
    o_re, o_im = tgl.griffin_lim_iteration(r_re, r_im, r_re, r_im, m, momentum, n_fft, hop)
    got = torch.complex(o_re, o_im).numpy()
    assert got.shape == want.shape == mag.shape
    assert np.isfinite(got).all()
    # fp32 on both sides, the sums in another order
    assert _rel(got, want) <= 1e-5


def test_projection_differs_from_matmul_path_only_at_the_edges(mag):
    """The plain kernel version re-analyses the raw row stream; the matmul
    path re-analyses the trimmed signal with reflect padding. Interior frames
    agree; the first two and the last differ by design."""
    m = torch.from_numpy(mag)
    o_re, o_im = tgl.griffin_lim_iteration(m, torch.zeros_like(m), m, torch.zeros_like(m), m, 0.0)
    got = torch.complex(o_re, o_im)
    y = tops.istft(torch.complex(m, torch.zeros_like(m)), 1024, 256)
    want = tops.stft(y, 1024, 256)[:, : mag.shape[-2]]
    err = ((got - want).abs() / want.abs().max()).numpy()
    assert err[:, 2:-1].max() <= 1e-5
    assert err[:, 0].max() > 1e-3 and err[:, -1].max() > 1e-3  # not one path compared with itself


@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_matmul_path_one_iteration_matches_jax(mag, momentum):
    """Elementwise, from a seeded random start phase (see the module note)."""
    phase = np.random.default_rng(2).uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    want = np.asarray(
        jops.griffin_lim(jnp.asarray(mag), n_iter=1, momentum=momentum, impl="matmul",
                         precision="highest", init_phase=jnp.asarray(phase))
    )
    got = tops.griffin_lim(torch.from_numpy(mag), n_iter=1, momentum=momentum, impl="matmul",
                           init_phase=phase).numpy()
    assert got.shape == want.shape == (2, 94 * 256)
    assert _rel(got, want) <= 1e-4


def test_eight_iterations_converge_like_jax(mag):
    """Spectral convergence after 8 iterations: the port's matmul path within
    0.02 of the JAX matmul path, and the plain kernel version within 0.02 of
    the port's matmul path (the edge frames differ by design)."""
    sc_jax = _specconv(jops.griffin_lim(jnp.asarray(mag), n_iter=8, impl="matmul", precision="highest"), mag)
    sc_mm = _specconv(tops.griffin_lim(torch.from_numpy(mag), n_iter=8, impl="matmul"), mag)
    sc_k = _specconv(tops.griffin_lim(torch.from_numpy(mag), n_iter=8, impl="pallas"), mag)
    assert abs(sc_mm - sc_jax) <= 0.02, (sc_mm, sc_jax)
    assert sc_k <= sc_mm + 0.02, (sc_k, sc_mm)


@pytest.mark.parametrize("impl", ["matmul", "pallas"])
def test_init_phase_oracle_is_kept(impl):
    """Seeding with the true phase makes the first projection a no-op up to
    rounding: the reconstruction is near-exact in the interior."""
    x = _signal(batch=1)
    spec = tops.stft(torch.from_numpy(x), 1024, 256).numpy()
    mag, ph = np.abs(spec), np.angle(spec).astype(np.float32)
    y = tops.griffin_lim(torch.from_numpy(mag), n_iter=2, init_phase=ph, length=x.shape[-1], impl=impl).numpy()
    sl = slice(2048, x.shape[-1] - 2048)
    assert np.abs(y[:, sl] - x[:, sl]).max() / np.abs(x).max() < 1e-3


@pytest.mark.parametrize("impl", ["matmul", "pallas"])
def test_zero_magnitude_is_finite(impl):
    """An all-zero magnitude, and zero bins beside live ones, give zeros
    through the 1e-16 guard, not NaN."""
    y = tops.griffin_lim(torch.zeros(2, 12, 513), n_iter=3, impl=impl)
    assert torch.equal(y, torch.zeros_like(y))
    m = torch.from_numpy(_mag(_signal(seconds=0.5)))
    m[..., 100:] = 0.0
    assert torch.isfinite(tops.griffin_lim(m, n_iter=3, impl=impl)).all()


def test_lead_axes_are_rows():
    mag = torch.from_numpy(_mag(_signal(batch=4, seconds=0.5)))
    y = tops.griffin_lim(mag.reshape(2, 2, *mag.shape[1:]), n_iter=1, impl="pallas")
    assert y.shape == (2, 2, mag.shape[1] * 256)
    torch.testing.assert_close(y.reshape(4, -1), tops.griffin_lim(mag, n_iter=1, impl="pallas"), rtol=0, atol=0)


def test_auto_on_the_cpu_takes_the_matmul_path():
    mag = torch.from_numpy(_mag(_signal(batch=1, seconds=0.5)))
    torch.testing.assert_close(tops.griffin_lim(mag, n_iter=2), tops.griffin_lim(mag, n_iter=2, impl="matmul"),
                               rtol=0, atol=0)


def test_momentum_zero_length_and_numpy_input():
    mag = _mag(_signal(batch=1, seconds=0.5))
    y = tops.griffin_lim(mag, n_iter=2, momentum=0.0, length=6789, impl="pallas", device="cpu")
    assert y.shape == (1, 6789) and y.device.type == "cpu" and torch.isfinite(y).all()
    if not torch.cuda.is_available():  # numpy goes to the card unless told otherwise
        with pytest.raises(AudioError):
            tops.griffin_lim(mag, n_iter=1)


@pytest.mark.parametrize("impl", ["matmul", "pallas"])
def test_griffinlim_tone_err(impl):
    """The JAX package's validate row (validate.py:348-372): 1 s of 440 Hz,
    16 iterations, spectral convergence under 0.2."""
    x = torch.from_numpy((0.5 * np.sin(2 * np.pi * 440.0 * np.arange(16000) / 16000.0)).astype(np.float32))
    mg = tops.stft(x, 1024, 256).abs()
    rec = tops.stft(tops.griffin_lim(mg, 1024, 256, n_iter=16, impl=impl), 1024, 256).abs()
    f = min(rec.shape[0], mg.shape[0])
    assert (torch.linalg.norm(rec[:f] - mg[:f]) / torch.linalg.norm(mg)).item() < 0.2


def test_supported_accepts_every_jax_configuration():
    grid = [(n, h) for n in (256, 400, 501, 512, 1024, 2048, 2400, 4096) for h in (8, 16, 64, 100, 128, 167, 256, 512)]
    taken = 0
    for n_fft, hop in grid:
        for precision in ("default", "highest"):
            if jgl.supported(n_fft, hop, precision=precision):
                taken += 1
                assert tgl.supported(n_fft, hop, precision=precision), (n_fft, hop, precision)
    assert taken > 20
    assert tgl.supported(1024, 8) and not jgl.supported(1024, 8)  # a superset: ROADMAP Queue C
    for n_fft, hop in ((1024, 300), (1024, 1024), (8192, 2048)):
        assert not tgl.supported(n_fft, hop)
    assert not tgl.supported(1024, 256, win_length=800)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"momentum": 1.0}, "momentum"),
        ({"n_iter": 0}, "pallas"),
        ({"precision": "high"}, "pallas"),
        ({"center": False}, "pallas"),
        ({"bins": 512}, "bins"),
    ],
)
def test_pallas_raises_where_jax_raises(kwargs, match):
    kwargs = dict(kwargs)
    mag = np.zeros((2, 16, kwargs.pop("bins", 513)), np.float32)
    with pytest.raises(ValueError, match=match):
        jops.griffin_lim(jnp.asarray(mag), impl="pallas", **kwargs)
    with pytest.raises(ValueError, match=match):
        tops.griffin_lim(mag, impl="pallas", device="cpu", **kwargs)


def test_node_round_trip():
    """chain(Spectrogram(power=False), GriffinLim) as the JAX node test runs it
    (test_nodes_dynamics_features.py:120-139), through Graph.compile()."""
    fs = 16000
    x = (0.4 * np.sin(2 * np.pi * 440.0 * np.arange(fs // 2) / fs)).astype(np.float32)
    g = tgraph.chain(
        tgraph.Spectrogram(512, 128, center=True, power=False),
        tgraph.GriffinLim(512, 128, n_iter=32, center=True),
        input_rate=fs,
    )
    assert not g.streamable
    y = g.compile()(x, device="cpu")
    assert y.ndim == 1 and torch.isfinite(y).all()
    assert g.nodes[-1].out_len(10) == 1280
    m_in = tops.spectrogram(torch.from_numpy(x), 512, 128, power=False)
    m_out = tops.spectrogram(y[: x.shape[-1]], 512, 128, power=False)
    n = min(m_in.shape[0], m_out.shape[0])
    err = torch.sqrt(((m_out[:n] - m_in[:n]) ** 2).mean()) / torch.sqrt((m_in**2).mean())
    assert err.item() < 0.15
    assert "GriffinLim" in tgraph.node_registry()


def test_stft_magnitude_graph_matches_jax():
    from audioflow_tpu.models import stft_magnitude_graph as jax_graph

    x = _signal(seconds=0.5)
    got = stft_magnitude_graph().compile()(x, device="cpu").numpy()
    want = np.asarray(jax_graph().compile()(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 32, 513)
    assert _rel(got, want) < 1e-5
