"""The port's CQT family (``ops/cqt.py``; the ``Cqt``, ``Icqt`` and
``CqtRoundTripMultirate`` nodes; ``cqt_frontend``; ``convert``'s multirate
coefficients; ``examples/cqt_edit_torch.py``) against the JAX package on the
CPU, on seeded inputs. Each JAX reference is jitted and computed once per
module, on signals of at most 3 s.

Tolerances, each relative to the reference's peak:

* the host designs (analysis, painless dual, hybrid and multirate banks,
  the window's cosine coefficients) are float64 copied bit for bit: equal;
* forward coefficients within ``FWD_TOL`` = 1e-5: a CQT bin is a sum of up
  to F0 = 8,448 fp32 products, taken as a hop-block correlation in the port
  and as a frame matmul in the JAX package;
* inverses within ``INV_TOL``: the hybrid's dual branch sums 2K·Tb = 12,144
  terms per output sample (K = 46 dual bins, Tb = 132 taps at 16 kHz), and
  sums of n fp32 terms taken in another order differ by about
  sqrt(n)·2^-24 of their magnitude; three times that is 2.0e-5;
* streamed against offline within 1e-6: the same frames, each computed by a
  correlation over another stretch of blocks.

The hybrid inverse takes discrete decisions per frame and bin (the local
peak test, the magnitude floor, the score gate, the first-minimum candidate
and the top-16 cut). Its comparisons first assert, on the coefficients both
packages are given, that every decision is clear of their fp32 differences:
magnitudes by ``MAG_MARGIN`` of the frame set's peak (the packages compute
them with the same operations, up to one rounding), scores by
``SCORE_MARGIN`` (logs, sincs and arctangents from two libraries, a few
ulps apart on terms of order 1-10).
"""

import dataclasses
import importlib.util
import json
import math
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu import config as jconfig
from audioflow_tpu import graph as jgraph
from audioflow_tpu import models as jmodels
from audioflow_tpu import ops as jops
from audioflow_torch import config as tconfig
from audioflow_torch import graph as tgraph
from audioflow_torch import models as tmodels
from audioflow_torch import ops as tops
from audioflow_torch.convert import multirate_cqt_from_jax, multirate_cqt_to_numpy
from audioflow_torch.errors import AudioError
from audioflow_torch.validate import within_budget
from decision_margins import hybrid_decisions_clear
from thread_limits import one_blas_thread_per_module, two_torch_threads_per_module  # noqa: F401  (autouse)

jcqt = importlib.import_module("audioflow_tpu.ops.cqt")
tcqt = importlib.import_module("audioflow_torch.ops.cqt")

ROOT = Path(__file__).resolve().parents[1]
RATE = 16000
FWD_TOL = 1e-5
INV_TOL = 3 * math.sqrt(2 * 46 * 132) * 2.0**-24
STREAM_TOL = 1e-6
# the small config: 48 bins from 110 Hz (the validate rows' CQT); the
# painless one: the same at hop 48 (icqt_max_hop is 54)
SMALL = dict(hop=256, n_bins=48, fmin=110.0)
PAINLESS = dict(hop=48, n_bins=48, fmin=110.0)


def _rel(got, want) -> float:
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def signal():
    """Two 1 s lanes: a tone and a two-tone chord over noise."""
    rng = np.random.default_rng(0)
    t = np.arange(RATE) / RATE
    x = np.stack([
        0.5 * np.sin(2 * np.pi * 440.0 * t),
        0.3 * np.sin(2 * np.pi * 196.0 * t) + 0.2 * np.sin(2 * np.pi * 1318.5 * t),
    ]) + 0.05 * rng.standard_normal((2, RATE))
    return x.astype(np.float32)


def _tones(bins, seconds: float, n_bins: int = 84, fmin: float = jops.FMIN_C1) -> np.ndarray:
    f = jops.cqt_frequencies(n_bins, fmin)
    n = np.arange(int(seconds * RATE))
    return np.stack([np.sin(2 * np.pi * f[k] * n / RATE) for k in bins]).astype(np.float32)


def _harmonic(seconds: float) -> np.ndarray:
    n = np.arange(int(seconds * RATE))
    return sum((0.5 / (i + 1)) * np.sin(2 * np.pi * 150.0 * (i + 1) * n / RATE) for i in range(12)).astype(np.float32)


# ------------------------------------------------------------------ designs


@pytest.mark.parametrize("rate,hop,n_bins,fmin", [(16000, 256, 84, jops.FMIN_C1), (16000, 48, 48, 110.0),
                                                  (44100, 256, 84, jops.FMIN_C1)])
def test_designs_equal_jax(rate, hop, n_bins, fmin):
    args = (rate, hop, n_bins, fmin, 12, "hann", 1.0)
    jf0, jgroups, jbank = jcqt._design(*args)
    tf0, tgroups, tbank = tcqt._design(*args)
    assert tf0 == jf0 and np.array_equal(tbank, jbank)
    assert len(tgroups) == len(jgroups)
    for (tl, tcb, tsb), (jl, jcb, jsb) in zip(tgroups, jgroups):
        assert tl == jl and np.array_equal(tcb, jcb) and np.array_equal(tsb, jsb)
    assert np.array_equal(tops.cqt_frequencies(n_bins, fmin), jops.cqt_frequencies(n_bins, fmin))
    assert np.array_equal(tops.cqt_lengths(rate, n_bins, fmin), jops.cqt_lengths(rate, n_bins, fmin))
    assert tops.cqt_window_length(rate, hop, n_bins, fmin) == jops.cqt_window_length(rate, hop, n_bins, fmin)
    assert tops.icqt_max_hop(rate, n_bins, fmin) == jops.icqt_max_hop(rate, n_bins, fmin)
    if hop == 48:
        (tnd, tdual), (jnd, jdual) = tcqt._dual_design(*args), jcqt._dual_design(*args)
        assert tnd == jnd and np.array_equal(tdual, jdual)
        return
    assert tops.multirate_hops(rate, hop, n_bins, fmin) == jops.multirate_hops(rate, hop, n_bins, fmin)
    tm, jm = tcqt._multirate_design(*args), jcqt._multirate_design(*args)
    assert tm["nd"] == jm["nd"] and tm["hops"] == jm["hops"]
    for (th, tl, tb), (jh, jl, jb) in zip(tm["octs"], jm["octs"]):
        assert (th, tl) == (jh, jl) and np.array_equal(tb, jb)
    for t, j in zip(tm["duals"], jm["duals"]):
        assert t[0] == j[0] and np.array_equal(t[1], j[1]) and np.array_equal(t[2], j[2])
    if rate == 16000:
        th, jh = tcqt._hybrid_design(*args), jcqt._hybrid_design(*args)
        assert th.keys() == jh.keys()
        for key, v in jh.items():
            assert np.array_equal(th[key], v) if isinstance(v, np.ndarray) else th[key] == v, key
        for w in ("hann", "hamming", "blackman"):
            assert np.array_equal(tcqt._window_cos_coeffs(w), jcqt._window_cos_coeffs(w))


# ------------------------------------------------------------------ forward


@pytest.fixture(scope="module")
def jax_forward(signal):
    x = jnp.asarray(signal)
    out = {}
    for impl in ("onedot", "split", "direct"):
        for output in ("magnitude", "power", "complex"):
            fn = jax.jit(lambda z, impl=impl, output=output: jops.cqt(z, RATE, **SMALL, impl=impl, output=output))
            out[impl, output] = np.asarray(fn(x))
    for center in (True, False):
        out["default", center] = np.asarray(jops.cqt(x, RATE, center=center, output="complex"))
    out["chroma"] = np.asarray(jops.chroma_cqt(x, RATE))
    out["chroma24"] = np.asarray(jops.chroma_cqt(x, RATE, n_octaves=4, fmin=65.0, bins_per_octave=24))
    return out


@pytest.mark.parametrize("impl", ["onedot", "split", "direct"])
@pytest.mark.parametrize("output", ["magnitude", "power", "complex"])
def test_cqt_matches_jax(signal, jax_forward, impl, output):
    got = tops.cqt(torch.from_numpy(signal), RATE, **SMALL, impl=impl, output=output)
    assert got.dtype == (torch.complex64 if output == "complex" else torch.float32)
    assert _rel(got, jax_forward[impl, output]) < FWD_TOL


@pytest.mark.parametrize("center", [True, False])
def test_cqt_default_config_matches_jax(signal, jax_forward, center):
    got = tops.cqt(torch.from_numpy(signal), RATE, center=center, output="complex")
    assert _rel(got, jax_forward["default", center]) < FWD_TOL


def test_cqt_impls_agree(signal):
    """The three impls and the two product forms compute one function, as
    the JAX package's ``test_cqt_impls_agree`` requires of its impls."""
    x = torch.from_numpy(signal)
    ref = tops.cqt(x, RATE, output="complex", impl="onedot")
    for impl in ("split", "direct"):
        assert _rel(tops.cqt(x, RATE, output="complex", impl=impl), ref.numpy()) < FWD_TOL
    f0, _, bank = tcqt._design(RATE, 256, 84, jops.FMIN_C1, 12, "hann", 1.0)
    xp = torch.nn.functional.pad(x, (f0 // 2, f0 - f0 // 2))
    n = (xp.shape[-1] - f0) // 256 + 1
    conv, unfold = (tcqt._framed_dot(xp, bank, 256, n, form) for form in ("conv", "unfold"))
    assert _rel(conv, unfold.numpy()) < FWD_TOL


def test_chroma_cqt_matches_jax(signal, jax_forward):
    x = torch.from_numpy(signal)
    assert _rel(tops.chroma_cqt(x, RATE), jax_forward["chroma"]) < FWD_TOL
    got = tops.chroma_cqt(x, RATE, n_octaves=4, fmin=65.0, bins_per_octave=24)
    assert _rel(got, jax_forward["chroma24"]) < FWD_TOL


# ------------------------------------------------------------------ inverses


@pytest.fixture(scope="module")
def painless():
    x = _tones((0, 24, 47), 1.5, 48, 110.0)
    fn = jax.jit(lambda z: jops.icqt(jops.cqt(z, RATE, **PAINLESS, output="complex"), RATE, **PAINLESS,
                                     length=x.shape[-1]))
    return x, np.asarray(fn(jnp.asarray(x)))


def test_icqt_painless_matches_jax(painless):
    x, want = painless
    c = tops.cqt(torch.from_numpy(x), RATE, **PAINLESS, output="complex")
    got = tops.icqt(c, RATE, **PAINLESS, length=x.shape[-1])
    assert _rel(got, want) < INV_TOL
    mid = slice(8000, 16000)
    snr = 10 * np.log10((x[:, mid] ** 2).sum(-1) / ((got.numpy()[:, mid] - x[:, mid]) ** 2).sum(-1))
    assert snr.min() > 30.0, snr  # the icqt_painless_snr_db budget
    # center=False and a default length, against the JAX package
    c_nc = tops.cqt(torch.from_numpy(x), RATE, **PAINLESS, center=False, output="complex")
    j_nc = jax.jit(lambda c: jops.icqt(c, RATE, **PAINLESS, center=False))(jnp.asarray(c_nc.numpy()))
    assert _rel(tops.icqt(c_nc, RATE, **PAINLESS, center=False), j_nc) < INV_TOL


def test_icqt_painless_past_the_cliff_warns(painless):
    x, _ = painless
    c = tops.cqt(torch.from_numpy(x[:1, :8000]), RATE, **SMALL, output="complex")
    with pytest.warns(UserWarning, match="exceeds icqt_max_hop=54"):
        tops.icqt(c, RATE, **SMALL, method="painless")


@pytest.fixture(scope="module")
def hybrid():
    """The framework default (hop 256, 84 bins from C1): tones at bins 1
    (a hop-alias-colliding bottom bin), 42 (the crossfade band) and 63 (the
    sinusoidal branch), and a 150 Hz harmonic complex, 3 s each; both
    packages invert the port's coefficients."""
    x = np.concatenate([_tones((1, 42, 63), 3.0), _harmonic(3.0)[None]])
    c = tops.cqt(torch.from_numpy(x), RATE, output="complex")
    fn = jax.jit(lambda z: jops.icqt(z, RATE, length=x.shape[-1]))
    return x, c, np.asarray(fn(jnp.asarray(c.numpy())))


def test_icqt_hybrid_matches_jax(hybrid):
    x, c, want = hybrid
    hybrid_decisions_clear(c)
    got = tops.icqt(c, RATE, length=x.shape[-1])
    assert _rel(got, want) < INV_TOL
    lo, hi = 17000, x.shape[-1] - 17000
    snr = 10 * np.log10((x[:3, lo:hi] ** 2).sum(-1) / ((got.numpy()[:3, lo:hi] - x[:3, lo:hi]) ** 2).sum(-1))
    assert snr.min() > 30.0, snr  # the icqt_tone_snr_db budget


def test_icqt_hybrid_center_false_and_method(hybrid):
    x, _, _ = hybrid
    c = tops.cqt(torch.from_numpy(x[1:3, :24000]), RATE, center=False, output="complex")
    hybrid_decisions_clear(c)
    want = jax.jit(lambda z: jops.icqt(z, RATE, center=False, method="hybrid"))(jnp.asarray(c.numpy()))
    got = tops.icqt(c, RATE, center=False, method="auto")  # auto takes the hybrid at hop 256
    assert _rel(got, want) < INV_TOL


@pytest.fixture(scope="module")
def multirate():
    """Band noise (the hybrid's failure case) and a top-octave tone, 2 s."""
    rng = np.random.default_rng(3)
    n = 2 * RATE
    zf = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1.0 / RATE)
    zf[(f < 800.0) | (f > 2000.0)] = 0
    noise = np.fft.irfft(zf, n)
    x = np.stack([0.5 * noise / np.abs(noise).max(), _tones((80,), 2.0)[0]]).astype(np.float32)
    jc = jax.jit(lambda z: jops.cqt(z, RATE, multirate=True, output="complex"))(jnp.asarray(x))
    return x, jc, np.asarray(jax.jit(lambda c: jops.icqt(c))(jc))


def test_cqt_multirate_matches_jax(multirate):
    x, jc, want = multirate
    c = tops.cqt(torch.from_numpy(x), RATE, multirate=True, output="complex")
    assert isinstance(c, tops.MultirateCqt) and c.hops == jc.hops == (256, 256, 256, 128, 64, 32, 8)
    assert c.meta == tcqt._MrMeta(*(getattr(jc.meta, k) for k in tcqt._MrMeta.__slots__))
    peak = max(float(np.abs(np.asarray(o)).max()) for o in jc.octaves)  # the transform's peak, every octave
    for got, ref in zip(c.octaves, jc.octaves):
        assert got.shape == ref.shape and np.abs(got.numpy() - np.asarray(ref)).max() / peak < FWD_TOL
    assert _rel(c.to_grid(), jc.to_grid()) < FWD_TOL
    got = tops.icqt(c)
    assert _rel(got, want) < INV_TOL
    # the JAX package's coefficients through the port's inverse, and back
    octs, meta = [np.asarray(o) for o in jc.octaves], {k: getattr(jc.meta, k) for k in jc.meta.__slots__}
    c_j = multirate_cqt_from_jax(octs, meta)
    assert _rel(tops.icqt_multirate(c_j), want) < INV_TOL
    back_octs, back_meta = multirate_cqt_to_numpy(c_j)
    assert back_meta == meta and all(np.array_equal(a, b) for a, b in zip(back_octs, octs))
    lo, hi = 17000 // 2, x.shape[-1] - 17000 // 2
    snr = 10 * np.log10((x[:, lo:hi] ** 2).sum(-1) / ((got.numpy()[:, lo:hi] - x[:, lo:hi]) ** 2).sum(-1))
    assert snr.min() > 30.0, snr  # the icqt_multirate_noise_snr_db budget


def test_cqt_edit_example_matches_jax(multirate):
    """``examples/cqt_edit_torch.py``'s edit (zero the bins below 440 Hz,
    resynthesize) against the JAX example's, on the same signal."""
    spec = importlib.util.spec_from_file_location("cqt_edit_torch", ROOT / "examples" / "cqt_edit_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    x, _, _ = multirate
    keep = jnp.asarray((jops.cqt_frequencies(84) >= 440.0).astype(np.float32))

    @jax.jit
    def j_edit(z):  # examples/cqt_edit.py's edit
        jc = jops.cqt(z, RATE, multirate=True, output="complex")
        octs, lo = [], 0
        for o in jc.octaves:
            octs.append(o * keep[lo : lo + o.shape[-1]])
            lo += o.shape[-1]
        return jops.icqt(type(jc)(octs, jc.meta))

    want = np.asarray(j_edit(jnp.asarray(x)))
    assert _rel(example.edit(torch.from_numpy(x), RATE, 440.0), want) < INV_TOL


# ---------------------------------------------------------- errors, advice


def _raises(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the type and message are the result
        return type(e).__name__, getattr(e, "code", None) and e.code.value, str(e)
    return None


_ERRORS = {
    "output": lambda p, x: p.cqt(x, RATE, output="db"),
    "impl": lambda p, x: p.cqt(x, RATE, impl="fft"),
    "multirate_center": lambda p, x: p.cqt(x, RATE, center=False, multirate=True),
    "multirate_impl": lambda p, x: p.cqt(x, RATE, impl="split", multirate=True),
    "multirate_output": lambda p, x: p.cqt_multirate(x, RATE, output="db"),
    "nyquist": lambda p, x: p.cqt(x, 8000, n_bins=96),
    "too_short": lambda p, x: p.cqt(x[..., :4000], RATE, center=False),
    "icqt_method": lambda p, x: p.icqt(p.cqt(x, RATE, **SMALL, output="complex"), RATE, **SMALL, method="x"),
    "icqt_rate": lambda p, x: p.icqt(p.cqt(x, RATE, **SMALL, output="complex")),
    "icqt_shape": lambda p, x: p.icqt(p.cqt(x, RATE, **SMALL, output="complex"), RATE, **PAINLESS | {"n_bins": 36}),
    "hybrid_shape": lambda p, x: p.icqt(p.cqt(x, RATE, **SMALL, output="complex"), RATE, hop=256, n_bins=36,
                                        fmin=110.0, method="hybrid"),
    "hybrid_low_bins": lambda p, x: p.icqt(p.cqt(x, RATE, hop=1024, n_bins=48, fmin=440.0, output="complex"),
                                           RATE, hop=1024, n_bins=48, fmin=440.0),
    "hybrid_window": lambda p, x: p.icqt(p.cqt(x, RATE, window="kaiser:8.0", output="complex"), RATE,
                                         window="kaiser:8.0"),
    "mr_rate": lambda p, x: p.icqt(p.cqt(x, RATE, multirate=True, output="complex"), 22050),
    "mr_conflict": lambda p, x: p.icqt(p.cqt(x, RATE, multirate=True, output="complex"), hop=128, n_bins=72),
    "mr_method": lambda p, x: p.icqt(p.cqt(x, RATE, multirate=True, output="complex"), method="hybrid"),
    "mr_not_complex": lambda p, x: p.icqt_multirate(p.cqt(x, RATE, multirate=True)),
    "mr_odd_hop": lambda p, x: p.multirate_hops(RATE, 255),
    "chroma_bins": lambda p, x: p.chroma_cqt(x, RATE, bins_per_octave=18),
}


@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_errors_match_jax(signal, case):
    """Each misuse raises in the port what it raises in the JAX package: the
    same exception type (by name), error code and message."""
    call = _ERRORS[case]
    got = _raises(lambda: call(tops, torch.from_numpy(signal)))
    want = _raises(lambda: call(jops, jnp.asarray(signal)))
    assert got is not None and got == want, (got, want)


def test_icqt_multirate_takes_only_multirate_coefficients(signal):
    with pytest.raises(TypeError, match="icqt_multirate takes a MultirateCqt"):
        tops.icqt_multirate(tops.cqt(torch.from_numpy(signal), RATE, output="complex"))


def test_reference_behaviours_kept(signal):
    """The reference behaviours that ADVICE.md lists and the port keeps:
    ``cqt(multirate=True)`` returns magnitudes unless asked for complex;
    ``icqt`` of a MultirateCqt does not check a conflicting ``filter_scale``;
    the hybrid inverse's broadband rows are gated two-sided."""
    x = torch.from_numpy(signal)
    c = tops.cqt(x, RATE, multirate=True)
    jc = jax.eval_shape(lambda z: jops.cqt(z, RATE, multirate=True), jnp.asarray(signal))
    assert not any(o.is_complex() for o in c.octaves)
    assert not any(jnp.issubdtype(o.dtype, jnp.complexfloating) for o in jc.octaves)
    cc = tops.cqt(x, RATE, multirate=True, output="complex")
    want = jax.jit(lambda z: jops.icqt(jops.cqt(z, RATE, multirate=True, output="complex"), filter_scale=2.0))(
        jnp.asarray(signal))
    assert _rel(tops.icqt(cc, filter_scale=2.0), want) < INV_TOL
    for key, inside, outside in (("icqt_hybrid_noise_snr_db", (-24.0, 9.0), (-26.0, 11.0)),
                                 ("icqt_hybrid_harm_snr_db", (1.0, 24.0), (-1.0, 26.0))):
        assert all(within_budget(key, v) for v in inside)
        assert not any(within_budget(key, v) for v in outside)


# ------------------------------------------------------------------- nodes


@pytest.fixture(scope="module")
def node_signal():
    rng = np.random.default_rng(5)
    t = np.arange(3 * 16384) / RATE
    x = 0.4 * np.sin(2 * np.pi * 261.6 * t) + 0.05 * rng.standard_normal((2, t.size))
    return x.astype(np.float32)


def test_cqt_node_offline_and_streamed(node_signal):
    """The ``Cqt`` node (split impl, center=False) against the JAX node
    offline, streamed against its own offline output at its latency, and
    ``cqt_frontend`` streamed in 16,384-sample chunks against the JAX
    package's stream."""
    x = torch.from_numpy(node_signal)
    g = tgraph.chain(tgraph.Cqt(**SMALL, center=False), input_rate=RATE)
    j = jgraph.chain(jgraph.Cqt(**SMALL, center=False), input_rate=RATE)
    offline = g.chain(x)
    assert _rel(offline, jax.jit(j.chain)(jnp.asarray(node_signal))) < FWD_TOL
    lat = g.stream_latency(4096)
    assert lat == j.stream_latency(4096) == (tops.cqt_window_length(RATE, **SMALL) - 256) // 256
    streamed = g.scan_stream(x, 4096)
    assert _rel(streamed[:, lat:], offline[:, : streamed.shape[1] - lat].numpy()) < STREAM_TOL
    tf, jf = tmodels.cqt_frontend(RATE), jmodels.cqt_frontend(RATE)
    t_stream = tf.scan_stream(x, 16384)
    assert _rel(t_stream, jf.scan_stream(jnp.asarray(node_signal), 16384)) < FWD_TOL
    lat = tf.stream_latency(16384)
    assert lat == 32
    assert _rel(t_stream[:, lat:], tf.chain(x)[:, : t_stream.shape[1] - lat].numpy()) < STREAM_TOL
    assert not tgraph.Cqt(center=False, output="complex").streamable and not tgraph.Cqt().streamable


def test_icqt_and_roundtrip_nodes_match_jax(node_signal):
    x = torch.from_numpy(node_signal)
    xj = jnp.asarray(node_signal)
    pairs = [
        (tgraph.chain(tgraph.Cqt(**PAINLESS, output="complex", impl="onedot"), tgraph.Icqt(**PAINLESS),
                      input_rate=RATE),
         jgraph.chain(jgraph.Cqt(**PAINLESS, output="complex", impl="onedot"), jgraph.Icqt(**PAINLESS),
                      input_rate=RATE)),
        (tgraph.chain(tgraph.CqtRoundTripMultirate(), input_rate=RATE),
         jgraph.chain(jgraph.CqtRoundTripMultirate(), input_rate=RATE)),
    ]
    for g, j in pairs:
        assert not g.streamable
        got = g.compile()(x)
        assert _rel(got, j.compile()(xj)) < INV_TOL
    assert tgraph.Icqt().out_len(10) == 9 * 256


def test_specs_round_trip_and_load_from_jax():
    graphs = [
        (tmodels.cqt_frontend(RATE), jmodels.cqt_frontend(RATE)),
        (tgraph.chain(tgraph.Cqt(hop=256, output="complex", impl="onedot"), tgraph.Icqt(hop=256), input_rate=RATE),
         jgraph.chain(jgraph.Cqt(hop=256, output="complex", impl="onedot"), jgraph.Icqt(hop=256), input_rate=RATE)),
        (tgraph.chain(tgraph.CqtRoundTripMultirate(hop=256), input_rate=44100),
         jgraph.chain(jgraph.CqtRoundTripMultirate(hop=256), input_rate=44100)),
    ]
    for tg, jg in graphs:
        spec = json.loads(json.dumps(dataclasses.asdict(tconfig.graph_to_spec(tg))))
        assert tconfig.graph_from_spec(spec) == tg
        assert spec == json.loads(json.dumps(dataclasses.asdict(jconfig.graph_to_spec(jg))))
        j_spec = json.loads(json.dumps(dataclasses.asdict(jconfig.graph_to_spec(jg))))
        assert tconfig.graph_from_spec(j_spec) == tg


def test_node_errors():
    with pytest.raises(AudioError, match="sample_rate unresolved"):
        tgraph.Icqt().apply(torch.zeros(2, 84, dtype=torch.complex64))
    with pytest.raises(AudioError, match="center=False"):
        tgraph.chain(tgraph.Cqt(), input_rate=RATE).chunk_lens(4096)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tgraph.Cqt(center=False).bind(RATE).latency(256) == 32
