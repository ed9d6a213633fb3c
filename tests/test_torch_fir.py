"""The port's FIR family (``ops/fir.py``, the ``Fir`` node) against the JAX
package on the CPU, on seeded inputs.

Tolerances: the designs are float64 host code copied bit for bit, so equal;
``fir_apply`` and ``convolve`` within 1e-6 of the JAX package's output peak
(fp32 sums of up to 300 taps in another order: ``conv1d`` against XLA's
convolution, ``torch.fft`` against ``jnp.fft``); the carried state ``zf``
exactly (it is a slice of the input); the node streamed exactly equal to
the node offline (zero latency, the prehistory carry)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu import graph as jgraph
from audioflow_tpu import ops as jops
from audioflow_tpu.config import graph_from_spec as j_from_spec
from audioflow_torch import graph as tgraph
from audioflow_torch import ops as tops
from audioflow_torch.config import graph_from_spec, graph_to_spec

RATE = 16000
TOL = 1e-6


def _signal(shape=(2, 3, 3000), seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize(
    "kind,cutoff,window,taps",
    [
        ("lowpass", 4000.0, "hamming", 101),
        ("lowpass", 2000.0, "hann", 64),
        ("highpass", 70.0, "hamming", 101),
        ("bandpass", (300.0, 3400.0), "blackman", 129),
        ("bandstop", (900.0, 1100.0), "hamming", 201),
    ],
)
def test_fir_design_equals_jax(kind, cutoff, window, taps):
    got = tops.fir_design(taps, cutoff, RATE, kind, window)
    want = jops.fir_design(taps, cutoff, RATE, kind, window)
    assert got.dtype == np.float64 and np.array_equal(got, want)


@pytest.mark.parametrize("impl,taps", [("direct", 65), ("fft", 65), ("auto", 65), ("auto", 301)])
def test_fir_apply_matches_jax(impl, taps):
    x = _signal()
    h = jops.fir_design(taps, 2000.0, RATE)
    zi = _signal((2, 3, taps - 1), seed=1)
    got, zf = tops.fir_apply(torch.from_numpy(x), h, zi=torch.from_numpy(zi), impl=impl)
    want, jzf = jops.fir_apply(jnp.asarray(x), h, zi=jnp.asarray(zi), impl=impl)
    assert _rel(got, want) < TOL
    np.testing.assert_array_equal(zf.numpy(), np.asarray(jzf))


def test_fir_apply_single_tap_and_errors():
    x = torch.from_numpy(_signal())
    y, zf = tops.fir_apply(x, np.array([0.5]))
    assert torch.equal(y, x * 0.5) and zf.shape == (2, 3, 0)
    with pytest.raises(ValueError, match="unknown fir impl"):
        tops.fir_apply(x, np.ones(5), impl="winograd")
    with pytest.raises(ValueError, match="odd num_taps"):
        tops.fir_design(100, 70.0, RATE, "highpass")


@pytest.mark.parametrize("mode,taps", [("full", 33), ("same", 33), ("full", 257), ("same", 257)])
def test_convolve_matches_jax(mode, taps):
    x = _signal((2, 2000))
    ir = np.random.default_rng(3).standard_normal(taps) * np.exp(-np.arange(taps) / 40.0)
    got = tops.convolve(torch.from_numpy(x), ir, mode)
    assert _rel(got, jops.convolve(jnp.asarray(x), ir, mode)) < TOL


@pytest.mark.parametrize(
    "kw", [dict(kind="highpass", num_taps=101, cutoff=(70.0,)), dict(taps=(0.25, 0.5, 0.25))], ids=["design", "taps"]
)
def test_fir_node_offline_and_streamed(kw):
    x = _signal((2, 4096))
    tg = tgraph.chain(tgraph.Fir(**kw), input_rate=RATE)
    jg = jgraph.chain(jgraph.Fir(**kw), input_rate=RATE)
    off = tg.chain(torch.from_numpy(x))
    assert _rel(off, jax.jit(jg.chain)(jnp.asarray(x))) < TOL
    streamed = tg.scan_stream(torch.from_numpy(x), 512)
    assert tg.stream_latency(512) == 0
    assert torch.equal(streamed, off)
    assert _rel(streamed, jg.scan_stream(jnp.asarray(x), 512)) < TOL
    # the spec round trip, and the JAX package's spec of the same graph
    back = graph_from_spec(dataclasses.asdict(graph_to_spec(tg)))
    assert back.nodes == tg.nodes
    assert graph_from_spec(json_spec(jg)).nodes == tg.nodes


def json_spec(jg):
    from audioflow_tpu.config import graph_to_spec as j_to_spec

    spec = dataclasses.asdict(j_to_spec(jg))
    assert j_from_spec(spec).nodes == jg.nodes
    return spec
