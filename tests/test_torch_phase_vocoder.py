"""The port's time-stretch / pitch-shift path against the JAX package on the CPU.

Inputs are seeded numpy (batch 2 x 1 s at 16 kHz) fed to both packages. On
the CPU the fused kernel's wrapper runs its plain version, which is held
against the JAX Pallas kernel in interpret mode.
"""

import ast
import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu import ops as jops
from audioflow_tpu.ops.pallas import timestretch as jts
from audioflow_torch import graph as tgraph
from audioflow_torch import ops as tops
from audioflow_torch.errors import AudioError
from audioflow_torch.ops.kernels import timestretch as tts

# `ops.stft` and `ops.phase_vocoder` name functions; fetch the modules
jstft, tstft, jpv, tpv = (
    importlib.import_module(m)
    for m in (
        "audioflow_tpu.ops.stft", "audioflow_torch.ops.stft",
        "audioflow_tpu.ops.phase_vocoder", "audioflow_torch.ops.phase_vocoder",
    )
)

ROOT = Path(__file__).resolve().parents[1]
RATES = [1.25, 0.8, 2.0 / 3.0, 2.0, 0.5]
# The matmul path accumulates the absolute phase of each bin in fp32 with
# one cumsum: after 100 frames the top bins sit near 8e4 rad, where an fp32
# step is 8e-3 rad. XLA's scan and torch's cumsum sum in other orders (and
# round atan2 differently), so the two packages' outputs differ by up to
# 1.1e-3 of the peak at 1 s (measured at rate 0.5; 3e-4 to 8e-4 at the
# other rates). Magnitudes, which carry no accumulated phase, agree to 1e-5.
MATMUL_TOL = 2e-3


def _signal(batch=2, seconds=1.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    rows = [0.5 * np.sin(2 * np.pi * 523.0 * t) + 0.1 * rng.standard_normal(t.size)]
    for b in range(1, batch):
        rows.append(0.3 * np.sin(2 * np.pi * (180.0 + 60 * b) * t) + 0.05 * rng.standard_normal(t.size))
    return np.stack(rows).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def x():
    return _signal()


@pytest.mark.parametrize("length,hop", [(1024, 256), (1000, 300)])
def test_overlap_add_matches_jax(rng, length, hop):
    frames = rng.standard_normal((2, 7, length)).astype(np.float32)
    got = tops.overlap_add(torch.from_numpy(frames), hop).numpy()
    want = np.asarray(jops.overlap_add(jnp.asarray(frames), hop))
    assert got.shape == want.shape == (2, 6 * hop + length)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # the same adds in the same order


@pytest.mark.parametrize("center", [True, False])
def test_stft_istft_match_jax(x, center):
    spec = tops.stft(torch.from_numpy(x), 1024, 256, center=center).numpy()
    jspec = np.array(jops.stft(jnp.asarray(x), 1024, 256, center=center, impl="matmul", precision="highest"))
    assert spec.shape == jspec.shape and spec.dtype == np.complex64
    # fp32 DFT sums; JAX folds the banks at "highest" (the same function)
    assert _rel(spec.real, jspec.real) < 1e-5 and _rel(spec.imag, jspec.imag) < 1e-5
    np.testing.assert_allclose(tops.power(torch.from_numpy(jspec)).numpy(), np.asarray(jops.power(jspec)), rtol=1e-6)
    np.testing.assert_allclose(
        tops.magnitude(torch.from_numpy(jspec)).numpy(), np.asarray(jops.magnitude(jspec)), rtol=1e-6
    )
    y = tops.istft(torch.from_numpy(jspec), 1024, 256, center=center, length=16000 if center else None)
    jy = jops.istft(jnp.asarray(jspec), 1024, 256, center=center, length=16000 if center else None,
                    impl="matmul", precision="highest")
    assert y.shape == jy.shape
    # center=False keeps the edges, where the window-square sum falls to
    # 1e-10 and divides the iDFT's rounding up: compare where it is whole
    edge = 0 if center else 1024
    assert _rel(y.numpy()[:, edge : y.shape[-1] - edge], np.asarray(jy)[:, edge : y.shape[-1] - edge]) < 1e-5
    if center:  # the round trip restores the signal
        assert _rel(y.numpy(), x) < 1e-5


def test_stft_rejects_unknown_names(x):
    with pytest.raises(ValueError):
        tops.stft(torch.from_numpy(x), 1024, 256, impl="bogus")
    with pytest.raises(ValueError):
        tops.istft(torch.zeros(2, 10, 513, dtype=torch.complex64), 1024, 256, impl="folded")
    with pytest.raises(ValueError):
        tops.stft(torch.from_numpy(x), 512, 128, win_length=600)


@pytest.mark.parametrize("n_fft,window", [(1024, "hann"), (512, "hamming")])
def test_banks_bit_identical(n_fft, window):
    for a, b in zip(tstft._idft_banks(n_fft), jstft._idft_banks(n_fft)):
        assert np.array_equal(a, b)
    # the JAX wrapper's synthesis banks (timestretch.py:428-431)
    ci, si = jstft._idft_banks(n_fft)
    w = jops.get_window(window, n_fft, periodic=True)
    ciw, siw = tstft.synthesis_banks(n_fft, window)
    assert np.array_equal(ciw, (ci * w[None, :]).astype(np.float32))
    assert np.array_equal(siw, (si * w[None, :]).astype(np.float32))
    for a, b in zip(tstft._dft_banks(n_fft, window, None), jstft._dft_banks(n_fft, window, None)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("rate", RATES)
def test_phase_vocoder_and_matmul_path_match_jax(x, rate):
    jspec = np.array(jops.stft(jnp.asarray(x), 1024, 256, impl="matmul", precision="highest"))
    got = tpv.phase_vocoder(torch.from_numpy(jspec), rate, 256, 1024).numpy()
    want = np.asarray(jops.phase_vocoder(jnp.asarray(jspec), rate, 256, 1024))
    assert got.shape == want.shape
    assert _rel(np.abs(got), np.abs(want)) < 1e-5
    assert _rel(got, want) < MATMUL_TOL
    y = tops.time_stretch(torch.from_numpy(x), rate, impl="matmul").numpy()
    jy = np.asarray(jops.time_stretch(jnp.asarray(x), rate, impl="matmul", precision="highest"))
    assert y.shape == jy.shape == (2, round(16000 / rate))
    assert _rel(y, jy) < MATMUL_TOL


def test_phasor_helpers_match_jax(rng):
    s = (rng.standard_normal((3, 5)) + 1j * rng.standard_normal((3, 5))).astype(np.complex64)
    s[0, 0] = 0
    m = np.abs(s)
    got = tpv.increment_phasors(*(torch.from_numpy(a) for a in (s[:-1], s[1:], m[:-1], m[1:])))
    want = jpv.increment_phasors(s[:-1], s[1:], m[:-1], m[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    u = got.numpy()
    np.testing.assert_allclose(
        tpv.cumulative_phasor(got, 0).numpy(),
        np.asarray(jpv.cumulative_phasor(jnp.asarray(u), 0)), atol=1e-6,
    )
    p = torch.tensor([-7.0, -3.2, 0.0, 3.2, 7.0])
    np.testing.assert_allclose(
        tpv._wrap_phase(p).numpy(), np.asarray(jpv._wrap_phase(p.numpy())),
        atol=1e-6,
    )


@functools.cache
def _pallas(rate):
    """The TPU kernel in interpret mode on the module's signal (about 2.5 s)."""
    return np.asarray(jts.time_stretch_pallas(jnp.asarray(_signal()), rate, precision="highest", interpret=True))


@pytest.mark.parametrize("rate", RATES)
def test_reference_matches_pallas_kernel(x, rate):
    """The kernel's plain version against the TPU kernel (interpret mode,
    full fp32 dots) on every sample, tail included: the same tail convention
    and the same phasor recurrence, so only fp32 rounding and the carry's
    renormalisation (every step here, every tile there) differ; measured
    6.6e-6 to 1.4e-5 of the peak."""
    threads = [torch.get_num_threads()]
    got = tts.time_stretch_reference(torch.from_numpy(x), rate).numpy()
    want = _pallas(rate)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4, _worst_sample(got, want)
    # on the CPU the wrapper is the plain version
    threads.append(torch.get_num_threads())
    fused = tts.time_stretch_fused(torch.from_numpy(x), rate).numpy()
    np.testing.assert_array_equal(fused, got, err_msg=f"{_worst_sample(fused, got)}; torch threads {threads}")


def _worst_sample(got, want, hop=256):
    """Where two stretched signals ``[row, sample]`` differ most, and the
    output frames (of ``hop``) in which they differ (ROADMAP C3)."""
    d = np.abs(got - want)
    r, i = np.unravel_index(int(np.argmax(d)), d.shape)
    frames = sorted({(int(a), int(b) // hop) for a, b in zip(*np.nonzero(d))})
    return (f"worst (row, sample) ({r}, {i}), frame {i // hop}: {got[r, i]} vs {want[r, i]}; "
            f"{(d > 0).mean():.4f} of the samples differ, in (row, frame) {frames[:40]}")


@pytest.mark.parametrize("rate", RATES)
def test_segmented_phase_model_matches_reference_and_pallas(x, rate):
    """The kernel's phase pass in plain torch (8 segments of the output
    frames, each walked from 1, the phase carried across them, renormalised
    at each boundary) against the sequential walk of the plain version: the
    same recurrence with the carries multiplied in another order, so within
    1e-6 of the peak (measured 1.9e-7 to 2.8e-7); and against the TPU
    kernel's tiled scan, within the plain version's 1e-4."""
    xt = torch.from_numpy(x)
    got = tts.time_stretch_model(xt, rate).numpy()
    assert _rel(got, tts.time_stretch_reference(xt, rate).numpy()) <= 1e-6
    assert _rel(got, _pallas(rate)) <= 1e-4
    # one segment is the sequential walk itself
    np.testing.assert_array_equal(tts.time_stretch_model(xt, rate, segments=1).numpy(),
                                  tts.time_stretch_reference(xt, rate).numpy())


@pytest.mark.parametrize("semitones", [12.0, 7.0])
def test_pitch_shift_matches_jax(x, semitones):
    got = tops.pitch_shift(torch.from_numpy(x), semitones).numpy()
    want = np.asarray(jops.pitch_shift(jnp.asarray(x), semitones))
    assert got.shape == want.shape == x.shape
    assert _rel(got, want) < MATMUL_TOL  # the stretch's matmul path, then the resampler


@pytest.mark.parametrize(
    "tnode,jnode",
    [
        (tgraph.TimeStretch(1.25), jgraph.TimeStretch(1.25)),
        (tgraph.PitchShift(12.0), jgraph.PitchShift(12.0)),
        (tgraph.TimeStretch(0.8, 512, 128), jgraph.TimeStretch(0.8, 512, 128)),
    ],
)
def test_nodes_through_compile_match_jax(x, tnode, jnode):
    g = tgraph.Graph((tnode,), input_rate=16000)
    j = jgraph.Graph((jnode,), input_rate=16000)
    assert not g.streamable
    got = g.compile()(torch.from_numpy(x)).numpy()
    want = np.asarray(j.compile()(jnp.asarray(x)))
    assert got.shape == want.shape
    assert _rel(got, want) < MATMUL_TOL
    assert set(tgraph.node_registry()) >= {"TimeStretch", "PitchShift"}


@pytest.mark.parametrize("impl", ["auto", "matmul", "pallas", "fft"])
def test_1d_input_length_and_errors(x, impl):
    y = tops.time_stretch(torch.from_numpy(x[0]), 1.25, impl=impl)
    assert y.ndim == 1 and y.shape[-1] == round(16000 / 1.25)
    with pytest.raises(ValueError):
        tops.time_stretch(torch.from_numpy(x), 0.0, impl=impl)
    with pytest.raises(ValueError):
        tops.time_stretch(torch.from_numpy(x), -1.25, impl=impl)


def test_auto_takes_the_matmul_path_on_the_cpu(x):
    xt = torch.from_numpy(x)
    torch.testing.assert_close(tops.time_stretch(xt, 1.25), tops.time_stretch(xt, 1.25, impl="matmul"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        tops.time_stretch(xt, 1.25, impl="bogus")
    with pytest.raises(ValueError):
        tts.time_stretch_fused(xt, 3.14159)  # not a small rational
    with pytest.raises(ValueError):
        tts.time_stretch_fused(xt, 1.25, precision="tf32")


@pytest.mark.parametrize("impl", ["pallas", "matmul"])
def test_leading_axes_are_rows(x, impl):
    """[2, 1, T] and [T] give the rows of the [2, T] result."""
    xt = torch.from_numpy(x)
    want = tops.time_stretch(xt, 0.8, impl=impl)
    got = tops.time_stretch(xt[:, None], 0.8, impl=impl)
    assert got.shape == (2, 1, round(16000 / 0.8))
    torch.testing.assert_close(got[:, 0], want, rtol=0, atol=1e-6)
    torch.testing.assert_close(tops.time_stretch(xt[1], 0.8, impl=impl), want[1], rtol=0, atol=1e-6)


def test_supported_accepts_every_jax_configuration():
    """The port drops the TPU's VMEM model; it must accept all that the JAX
    predicate accepts."""
    configs = [(1024, 256), (512, 128), (2048, 512), (1024, 512), (256, 64), (1000, 256)]
    rates = sorted({p / q for q in range(1, 13) for p in range(1, 3 * q + 1)})
    n_jax = 0
    for n_fft, hop in configs:
        for rate in rates:
            if jts.supported(rate, n_fft, hop):
                n_jax += 1
                assert tts.supported(rate, n_fft, hop), (rate, n_fft, hop)
    assert n_jax > 100
    # where the VMEM model rejects and the card takes it
    assert not jts.supported(1.25, 2048, 512) and tts.supported(1.25, 2048, 512)
    assert not jts.supported(9 / 5) and tts.supported(9 / 5)
    assert not tts.supported(np.pi / 2) and not tts.supported(1.25, 1000, 256)
    assert not tts.supported(1.25, 4096, 1024)  # over the shared memory of a block


def test_numpy_input_runs_on_the_card_unless_cpu_is_asked(x, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tgraph.Graph((tgraph.TimeStretch(1.25),), input_rate=16000)
    for run in (
        lambda **kw: tops.time_stretch(x, 1.25, **kw),
        lambda **kw: tops.pitch_shift(x, 12.0, **kw),
        lambda **kw: g.compile()(x, **kw),
        lambda **kw: g.compile(chunked=False)(x, **kw),
    ):
        with pytest.raises(AudioError):
            run()
        assert run(device="cpu").device.type == "cpu"
    np.testing.assert_array_equal(
        g.compile()(x, device="cpu").numpy(), g.compile()(torch.from_numpy(x)).numpy()
    )
    np.testing.assert_array_equal(
        tops.pitch_shift(x, 12.0, device="cpu").numpy(), tops.pitch_shift(torch.from_numpy(x), 12.0).numpy()
    )
    s = tgraph.chain(tgraph.Spectrogram(1024, 256, center=False), input_rate=16000)
    with pytest.raises(AudioError):
        s.scan_stream(x[:, :4096], 1024)
    np.testing.assert_array_equal(
        s.scan_stream(x[:, :4096], 1024, device="cpu").numpy(),
        s.scan_stream(torch.from_numpy(x[:, :4096]), 1024).numpy(),
    )


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port (the CQT and rhythm families among them), not
    chip_smoke.py, not the port's example and not the test helpers the card
    tests import names JAX or the JAX package in an import; and importing
    every module of the port in a fresh interpreter loads neither."""
    files = [*sorted((ROOT / "audioflow_torch").rglob("*.py")), ROOT / "chip_smoke.py", ROOT / "tests" / "ws_loopback.py",
             ROOT / "tests" / "decision_margins.py", *sorted((ROOT / "examples").glob("*_torch.py"))]
    assert {"cqt.py", "rhythm.py", "lpc.py", "segment.py", "streaming_session_torch.py", "bench.py",
            "version.py"} <= {p.name for p in files}
    for path in files:
        bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "audioflow_tpu")]
        assert not bad, (path, bad)
    code = (
        "import importlib, pkgutil, sys\n"
        "base = set(sys.modules)\n"
        "import audioflow_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(audioflow_torch.__path__, 'audioflow_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in set(sys.modules) - base if m.split('.')[0] in ('jax', 'jaxlib', 'audioflow_tpu'))\n"
        "print(len(names), bad)\n"
        "need = {'audioflow_torch.bench', 'audioflow_torch.obs.profiling', 'audioflow_torch.version'}\n"
        "sys.exit(1 if bad or len(names) < 20 or not need <= set(names) else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
