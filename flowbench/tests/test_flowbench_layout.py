"""BENCHMARK.json against the contract's shape, and discovery by name: a
configuration, traffic mix, metric and cell dropped in as new files and new
entries run with no edit to any file that is there."""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from flowbench.bench import Bench
from flowbench.cell import run_cell

import smallcells
from smallcells import SECONDS, SMALL, small_traffic

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contracts_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["flowbench"] and 1 <= spec["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in spec["command"])
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("flowbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    names = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "flowbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "flowbench" / "limits" / f"{w['name']}.json").is_file()
        names.add(w["name"])
    assert {c["name"] for c in spec["configs"]} == {w["config"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= names
        assert (ROOT / "flowbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", names))
    for w in names:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert sum(w in m.get("workloads", names) for m in spec["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in spec["per_layer"])


def _copy_root(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "flowbench", root / "flowbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_cell_configuration_traffic_and_metric_dropped_in_are_found_by_name(tmp_path):
    root = _copy_root(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}
    fb = root / "flowbench"
    cfg = json.loads((fb / "configs" / "logmel16k.json").read_text())
    cfg["name"] = "logmel16k-hop128"
    cfg["graph"]["nodes"][1]["hop"] = 128
    (fb / "configs" / "logmel16k-hop128.json").write_text(json.dumps(cfg))
    traffic = json.loads((fb / "traffic" / "resident-2048x10s.json").read_text())
    traffic["clips"] = 2
    (fb / "traffic" / "resident-2x10s.json").write_text(json.dumps(traffic))
    (fb / "limits" / "hop128-stream-2.json").write_text(
        (fb / "limits" / "logmel-stream-2048.json").read_text())
    (fb / "metrics" / "passes_in_window.py").write_text(
        "def read(r):\n    return r.window.attempted\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "logmel16k-hop128", "source": "a test", "reduced": ["hop"],
                            "file": "flowbench/configs/logmel16k-hop128.json", "why": "a test"})
    spec["workloads"].append({"name": "hop128-stream-2", "config": "logmel16k-hop128",
                              "traffic": "resident-2x10s", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "passes_in_window", "unit": "passes", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["hop128-stream-2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(root)
    t = bench.traffic("resident-2x10s")
    t["clip_seconds"] = 1.0
    result, _ = run_cell(bench, "hop128-stream-2", 3, SECONDS, False, torch.device("cpu"), time.perf_counter(), t)
    assert result["correct"]
    assert set(result["metrics"]) == {"passes_in_window", "setup_s"}
    assert result["metrics"]["passes_in_window"]["value"] == result["attempted"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there was edited


def test_run_exits_non_zero_and_prints_no_result_without_a_card_or_without_the_program(tmp_path):
    root = _copy_root(tmp_path)  # only BENCHMARK.json and the files under paths
    for cwd, script in ((ROOT, ROOT / "flowbench" / "run.py"), (root, root / "flowbench" / "run.py")):
        p = subprocess.run([sys.executable, str(script), "--workload", "logmel-live-64", "--seed", "1",
                            "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == "", (p.returncode, p.stdout[-300:])


@pytest.mark.parametrize("workload", list(SMALL))
def test_each_cell_finds_its_files(workload):
    bench = smallcells.bench()
    w = bench.workload(workload)
    bench.config(w["config"])
    t = small_traffic(bench, workload)
    assert hasattr(bench.driver(t["driver"]), "Case")
    for m in bench.metrics(workload, False) + bench.metrics(workload, True):
        assert callable(bench.reader(m["name"]).read)
