"""The benchmark's files, found by the names ``BENCHMARK.json`` gives them.

Under the checkout's root:

* ``BENCHMARK.json``: the cells, configurations and metrics;
* a configuration's ``file`` (``flowbench/configs/<config>.json``): the
  graph as it is run, with its source, what was assumed and reduced;
* ``flowbench/traffic/<traffic>.json``: a traffic mix's parameters, with
  the ``driver`` that runs it;
* ``flowbench/drivers/<driver>.py``: a general driver of one way of
  offering load (a ``Case`` class);
* ``flowbench/metrics/<metric>.py``: the reader of one metric (``read``);
* ``flowbench/limits/<cell>.json``: each compared number's limit in a cell.

A new cell, configuration, traffic mix or metric is new files and new
entries in ``BENCHMARK.json``: no file here names any of them.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _by_name(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} {name!r}; known: {sorted(e['name'] for e in entries)}")


class Bench:
    """The benchmark under the checkout root ``root`` (``spec`` in place of
    its ``BENCHMARK.json``, where given)."""

    def __init__(self, root: Path | str = ROOT, spec: dict | None = None):
        self.root = Path(root)
        self.dir = self.root / "flowbench"
        self.spec = spec if spec is not None else json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: dict[Path, object] = {}

    def workload(self, name: str) -> dict:
        return _by_name(self.spec["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = _by_name(self.spec["configs"], name, "configuration")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.dir / "limits" / f"{workload}.json").read_text())

    def _module(self, path: Path):
        mod = self._modules.get(path)
        if mod is None:
            if not path.is_file():
                raise FileNotFoundError(f"{path} is missing")
            name = "flowbench_" + re.sub(r"\W", "_", str(path.relative_to(self.dir).with_suffix("")))
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def driver(self, name: str):
        return self._module(self.dir / "drivers" / f"{name}.py")

    def reader(self, metric: str):
        return self._module(self.dir / "metrics" / f"{metric}.py")

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end ones
        untraced, its per-layer ones traced."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]
