"""Whole runs of each cell on the CPU at small sizes, past the look for a
card: sound runs come out correct; runs with the timed path broken
underneath, and the control, come out not correct.

The faults each cell can have: a step that returns its state unchanged
(the streamed cells), half of the batch left out (its rows never computed),
and an answer altered where it is produced (one log-mel value, one wire
sample). The control is the reference in TF32 put in the program's place.
"""

import time

import pytest
import torch

from audioflow_torch.graph import Graph, LogMelSpec, QuantizeI16
from flowbench.cell import run_cell, run_control

import smallcells
from smallcells import SECONDS, SMALL, small_traffic

STREAMED = ["logmel-stream-2048", "dictation-live-64", "logmel-live-64"]


def _run(workload, trace=False, seed=77):
    bench = smallcells.bench()
    result, notes = run_cell(bench, workload, seed, SECONDS, trace, torch.device("cpu"), time.perf_counter(),
                             small_traffic(bench, workload))
    return result, notes


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", list(SMALL))
def test_a_sound_run_is_correct_and_reports_its_metrics(workload, trace):
    result, notes = _run(workload, trace)
    assert result["correct"], notes
    assert list(result)[-1] == "checks" and result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = smallcells.bench()
    wanted = {m["name"] for m in bench.metrics(workload, trace)}
    got = set(result["metrics"])
    if trace:  # no device here: the device's readings are empty, the counts and host times are not
        assert "breakdown" in result and got <= wanted
        assert {"step_ops.live", "step_ops.resident", "decode_ms_per_batch", "session_host_ms_per_chunk"} & got
    else:
        assert got == wanted
    assert notes[-len(result["checks"]):] == [
        f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in result["checks"].items()
    ]


def _zero_half(out):
    def cut(t):
        t = t.clone()
        t[t.shape[0] // 2 :] = 0
        return t

    return {k: cut(v) for k, v in out.items()} if isinstance(out, dict) else cut(out)


@pytest.mark.parametrize("workload", STREAMED)
def test_a_step_that_returns_its_state_unchanged_is_caught(workload, monkeypatch):
    step = Graph.stream_step

    def stuck(self, state, chunk):
        return state, step(self, state, chunk)[1]

    monkeypatch.setattr(Graph, "stream_step", stuck)
    assert not _run(workload)[0]["correct"]


@pytest.mark.parametrize("workload", list(SMALL))
def test_half_of_the_batch_left_out_is_caught(workload, monkeypatch):
    if workload == "logmel-files-32":
        chain = Graph.chain
        monkeypatch.setattr(Graph, "chain", lambda self, x, taps=(): _zero_half(chain(self, x, taps)))
    else:
        step = Graph.stream_step

        def half(self, state, chunk):
            state, out = step(self, state, chunk)
            return state, _zero_half(out)

        monkeypatch.setattr(Graph, "stream_step", half)
    assert not _run(workload)[0]["correct"]


@pytest.mark.parametrize("workload", list(SMALL))
def test_a_log_mel_value_altered_where_it_is_produced_is_caught(workload, monkeypatch):
    frames = LogMelSpec._frames

    def altered(self, x):  # each call's loudest value in its first row
        out = frames(self, x)
        if out.device.type == "meta":  # the graph's shape pass
            return out
        out = out.clone()
        row = out[0].view(-1)
        row[row.argmax()] += 0.02
        return out

    monkeypatch.setattr(LogMelSpec, "_frames", altered)
    result, notes = _run(workload)
    assert not result["correct"]
    assert any(k.endswith("logmel_err") and not v["value"] <= v["limit"] for k, v in result["checks"].items())


def test_a_wire_sample_altered_where_it_is_produced_is_caught(monkeypatch):
    apply = QuantizeI16.apply

    def altered(self, x):
        out = apply(self, x).clone()
        out[0, -1] += 8
        return out

    monkeypatch.setattr(QuantizeI16, "apply", altered)
    result, _ = _run("dictation-live-64")
    assert not result["correct"] and result["checks"]["wire.i16_lsb"]["value"] >= 7


@pytest.mark.parametrize("workload", list(SMALL))
def test_the_control_fails_the_cells_limits(workload):
    bench = smallcells.bench()
    numbers = run_control(bench, workload, 99, SECONDS, torch.device("cpu"), small_traffic(bench, workload))
    limits = bench.limits(workload)
    failed = [k for k, v in numbers.items() if not v <= limits[k]]
    assert failed, numbers


@pytest.mark.cuda
def test_a_small_run_of_each_cell_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    bench = smallcells.bench()
    for workload in SMALL:
        result, notes = run_cell(bench, workload, 5, SECONDS, True, torch.device("cuda"), time.perf_counter(),
                                 small_traffic(bench, workload))
        assert result["correct"], notes
        assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
