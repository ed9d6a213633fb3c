"""Host tables of the streaming resampler's kernel (``csrc/resample.cu``), on
the CPU: the per-column tables read out of a plan rebuild its band exactly,
the kernel's grouped, shifted tables compute the step (a float64 model of
the kernel's sums), the wrapper on a CPU tensor is the plain version, and
the rule that reads a chunk as rows at one stride. The kernel itself is
tested on a card in test_torch_cuda.py."""

import importlib

import numpy as np
import pytest
import torch

from audioflow_torch.ops.kernels import _build
from audioflow_torch.ops.kernels import resample as kr

rs = importlib.import_module("audioflow_torch.ops.resample")  # ops.resample is also a function's name

# (input rate, output rate, chunk_in): the benchmark's pair at its chunk,
# the dictation trunk's decimation, and an interpolating pair
RATES = [(44100, 16000, 14112), (48000, 16000, 1536), (16000, 48000, 344)]
MODES = ["kaiser", "cubic", "linear"]


def _plan(rates, mode):
    return rs.make_stream_plan(rates[0], rates[1], mode, chunk_in=rates[2])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rates", RATES)
def test_tables_rebuild_the_band(rates, mode):
    plan = _plan(rates, mode)
    phase, base, bank = kr.stream_tables(plan)
    assert bank.shape == (plan.up, plan.k_taps) and bank.dtype == np.float32
    assert set(phase.tolist()) == set(range(plan.up))
    band = np.zeros_like(plan.matrix)
    for g in range(plan.block_out):
        band[base[g] : base[g] + plan.k_taps, g] = bank[phase[g]]
    np.testing.assert_array_equal(band, plan.matrix)


def _model_step(plan, carry, chunk):
    """The kernel's sums in float64: output j of group q of block b reads
    ``ct[s, j // 4, q, j % 4]`` against ``buf[b*ipb + qbase[q] + s]``."""
    t = kr.kernel_tables(plan)
    buf = np.concatenate([carry, chunk], axis=-1).astype(np.float64)
    n_blocks = plan.n_out_chunk // plan.block_out
    pos = (np.arange(n_blocks)[:, None, None] * plan.ipb + t.qbase[None, :, None]
           + np.arange(t.span)[None, None, :])
    buf = np.pad(buf, [(0, 0)] * (buf.ndim - 1) + [(0, max(0, int(pos.max()) + 1 - buf.shape[-1]))])
    y = np.einsum("...bqs,shqj->...bqhj", buf[..., pos], t.ct.astype(np.float64))
    y = y.reshape(*chunk.shape[:-1], n_blocks, -1)[..., : plan.block_out]
    return y.reshape(*chunk.shape[:-1], plan.n_out_chunk)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rates", RATES)
def test_kernel_tables_compute_the_step(rates, mode):
    plan = _plan(rates, mode)
    t = kr.kernel_tables(plan)
    assert t.ct.shape == (t.span, 2, t.n_groups, 4) and t.n_groups * kr.GROUP >= plan.block_out
    assert t.window <= plan.ipb + t.span  # a block reads at most one block's inputs and a span more
    rng = np.random.default_rng(7)
    carry = rng.standard_normal((3, plan.hist)).astype(np.float32)
    chunk = rng.standard_normal((3, plan.chunk_in)).astype(np.float32)
    _, want = rs.resample_stream_step_reference(plan, torch.from_numpy(carry), torch.from_numpy(chunk))
    # the plain version's fp32 sums against float64 over the same coefficients
    np.testing.assert_allclose(_model_step(plan, carry, chunk), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("lead", [(), (3,), (2, 4)])
def test_wrapper_on_the_cpu_is_the_plain_version(lead):
    plan = rs.make_stream_plan(44100, 16000, chunk_in=882)
    rng = np.random.default_rng(3)
    carry = torch.from_numpy(rng.standard_normal((*lead, plan.hist)).astype(np.float32))
    chunk = torch.from_numpy(rng.standard_normal((*lead, plan.chunk_in)).astype(np.float32))
    want = rs.resample_stream_step_reference(plan, carry, chunk)
    before = kr.COUNT.launches
    for step in (kr.resample_stream_step, rs.resample_stream_step):
        got = step(plan, carry, chunk)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert kr.COUNT.launches == before
    meta = kr.resample_stream_step(plan, carry.to("meta"), chunk.to("meta"))
    assert [tuple(m.shape) for m in meta] == [(*lead, plan.hist), (*lead, plan.n_out_chunk)]


def test_row_stride():
    """The rule both stream kernels' wrappers read a chunk by (``_build`` holds it)."""
    wide = torch.zeros(2, 4, 100)
    assert _build._row_stride(torch.zeros(7)) == 7
    assert _build._row_stride(torch.zeros(3, 10)) == 10
    assert _build._row_stride(wide[..., 20:40]) == 100  # a column slice: rows 100 apart
    assert _build._row_stride(wide.reshape(8, 100)[:, 5:15]) == 100
    assert _build._row_stride(torch.zeros(1, 10).expand(5, 10)) == 0  # one row read five times
    assert _build._row_stride(wide.transpose(0, 1)[..., :10]) is None  # lead axes at no one stride
    assert _build._row_stride(wide[..., ::2]) is None  # samples not adjacent
    t, stride = _build._rows(wide.transpose(0, 1)[..., :10])
    assert t.is_contiguous() and stride == 10
