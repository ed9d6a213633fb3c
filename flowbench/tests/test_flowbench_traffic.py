"""Each traffic generator gives the same inputs for the same seed, other
inputs for another seed, and the same sizes for every seed."""

import numpy as np
import pytest
import torch

from flowbench import signals
from flowbench.bench import Bench
from flowbench.case import Context

import smallcells
from smallcells import SECONDS, small_traffic

BIG = 2**31 + 12345  # seeds run past 32 signed bits


@pytest.mark.parametrize("recipe", ["tones", "speech"])
def test_a_recipe_repeats_for_its_seed(recipe):
    bench = smallcells.bench()
    kind = {
        "tones": bench.traffic("resident-2048x10s")["signal"],
        "speech": bench.traffic("live-64x20ms")["signal"],
    }[recipe]
    make = lambda seed: np.asarray(signals.make(kind, 3, 48000, 48000, seed, "cpu"))  # noqa: E731
    a, b, c = make(BIG), make(BIG), make(BIG + 1)
    assert a.dtype == np.float32 and a.shape == c.shape == (3, 48000)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_speech_bursts_stand_clear_of_the_floor_and_the_vad_threshold():
    kind = Bench().traffic("live-64x20ms")["signal"]
    x = signals.speech(4, 16000 * 8, 16000, 7, "cpu", kind).numpy()
    frames = x[:, : x.shape[1] // 320 * 320].reshape(4, -1, 320)
    db = 20 * np.log10(np.maximum((frames.astype(np.float64) ** 2).mean(-1), 1e-300))
    assert (db < -150).mean() > 0.2 and (db > -35).mean() > 0.2  # silences and bursts, both common


@pytest.mark.parametrize("workload", ["logmel-stream-2048", "dictation-live-64", "logmel-files-32", "logmel-live-64"])
def test_a_cells_inputs_repeat_for_its_seed(workload):
    bench = smallcells.bench()
    w = bench.workload(workload)
    config, traffic = bench.config(w["config"]), small_traffic(bench, workload)

    def inputs(seed):
        ctx = Context(workload, config, traffic, seed, SECONDS, torch.device("cpu"))
        return bench.driver(traffic["driver"]).Case(ctx).inputs()

    (a, rate), (b, _), (c, _) = inputs(BIG), inputs(BIG), inputs(5)
    assert rate == (config.get("graph") or config["fork"]["trunk"])["input_rate"]
    assert a.shape == c.shape and torch.equal(a, b) and not torch.equal(a, c)


def test_wav_files_hold_the_pcm_they_were_given(tmp_path):
    from audioflow_torch.io import read_audio

    pcm = np.array([0, 1, -1, 32767, -32768, 1234], np.int16)
    signals.write_wav(tmp_path / "a.wav", pcm, 44100)
    data, rate = read_audio(str(tmp_path / "a.wav"))
    assert rate == 44100 and np.array_equal(np.round(np.asarray(data).reshape(-1) * 32768), pcm)
