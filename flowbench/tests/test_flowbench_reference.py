"""The plain reference against audioflow_torch at small sizes on the CPU, its
TF32 rounding, and what it and a run import."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowbench import reference
from flowbench.reference import design

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / "flowbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("rates", [(44100, 16000), (48000, 16000), (16000, 44100)])
def test_the_kaiser_bank_and_resampler_agree_with_the_ports(rates):
    import importlib

    port = importlib.import_module("audioflow_torch.ops.resample")

    up, down = design.rational(*rates)
    bank, offset = design.kaiser_bank(up, down)
    want = port.kaiser_sinc_bank(up, down)
    assert np.array_equal(bank, want) and offset == -((want.shape[1] - 1) // 2)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 9000)))
    spec = {"graph": {"input_rate": rates[0], "nodes": [
        {"type": "Resample", "input_rate": rates[0], "output_rate": rates[1], "mode": "kaiser"}]}}
    ours = reference.run(spec, x, rates[0])["out"].value
    theirs = port.resample(x.to(torch.float32), *rates).to(torch.float64)
    assert ours.shape == theirs.shape
    assert float((ours - theirs).abs().max()) < 2e-5 * float(x.abs().max())


def test_the_filterbank_and_window_agree_with_the_ports():
    from audioflow_torch.ops.mel import mel_filterbank
    from audioflow_torch.ops.windows import get_window

    fb = design.slaney_filterbank(1024, 128, 16000, 0.0, 8000.0)
    assert np.allclose(fb, mel_filterbank(513, 128, 16000, dtype=np.float64), rtol=1e-12, atol=1e-15)
    assert np.allclose(design.hann(1024), get_window("hann", 1024), rtol=0, atol=1e-15)


def test_logmel16k_offline_agrees_with_the_port_within_float32_rounding():
    from flowbench.case import build_graph

    cfg = _config("logmel16k")
    rng = np.random.default_rng(2)
    t = np.arange(44100) / 44100
    x = (0.3 * np.sin(2 * np.pi * 523.0 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)[None]
    ref = reference.run(cfg, torch.from_numpy(x), 44100)["out"].value
    got = build_graph(cfg).chain(torch.from_numpy(x)).to(torch.float64)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) < 2e-4


def test_the_dictation_fork_agrees_with_the_port():
    from flowbench.case import build_graph
    from flowbench.signals import speech

    cfg = _config("dictation48k")
    kind = json.loads((ROOT / "flowbench" / "traffic" / "live-64x20ms.json").read_text())["signal"]
    x = speech(3, 48000 * 6, 48000, 11, "cpu", kind).numpy()
    ref = reference.run(cfg, torch.from_numpy(x), 48000)
    got = build_graph(cfg).chain(torch.from_numpy(x))
    assert set(ref) == set(got) == {"wire", "vad", "features"}
    keep = ~ref["vad"].ambiguous
    assert keep.all()
    assert torch.equal(got["vad"].to(torch.int64), ref["vad"].value)
    assert len(torch.unique(ref["vad"].value)) == 3  # silence, speech and ending all occur
    assert int((got["wire"].to(torch.int64) - ref["wire"].value).abs().max()) <= 1
    loud = ref["features"].value > ref["features"].value.max() - 13.8
    assert float((got["features"].to(torch.float64) - ref["features"].value)[loud].abs().max()) < 2e-4


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-11 + 2**-20, -1.5, 0.0])
    want = torch.tensor([1.0, 1 + 2**-10, 1.0, 1 + 2 * 2**-10, 1 + 2**-10, -1.5, 0.0])
    assert torch.equal(reference.round_tf32(x), want)


def _modules_after(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program_or_jax():
    mods = _modules_after(
        "import json, torch\nfrom flowbench import reference\n"
        "cfg = json.load(open('flowbench/configs/dictation48k.json'))\n"
        "reference.run(cfg, torch.zeros(2, 9600) + 0.1, 48000)\n"
        "reference.run(cfg, torch.zeros(2, 9600) + 0.1, 48000, 'tf32')"
    )
    assert not mods & {"audioflow_torch", "audioflow_tpu", "jax", "jaxlib", "flax"}


def test_a_run_of_every_cell_loads_nothing_of_jax():
    mods = _modules_after(
        "import sys, time, torch\nsys.path.insert(0, 'flowbench/tests')\n"
        "from flowbench.bench import Bench\nfrom flowbench.cell import run_cell\n"
        "from smallcells import SMALL, SECONDS, bench, small_traffic\nb = bench()\n"
        "for w in SMALL:\n"
        "    r, _ = run_cell(b, w, 1, SECONDS, True, torch.device('cpu'), time.perf_counter(), small_traffic(b, w))\n"
        "    assert r['correct'], r"
    )
    assert "audioflow_torch" in mods
    assert not mods & {"audioflow_tpu", "jax", "jaxlib", "flax"}
