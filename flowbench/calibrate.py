"""Readings that the limits of a cell are set from.

    python3 flowbench/calibrate.py --workload <name> --seconds <s> \\
        --program-seeds 1,2,... --control-seeds 7,8,9 [--out <file.jsonl>]

For each program seed, one whole run of the cell in this process (set-up,
window, comparison) and its compared numbers. For each control seed, the
control: the plain reference computed in TF32 (operands of its products
rounded to TF32, sums in float32), put in the program's place on the same
inputs a run compares, and read by the same comparison. One JSON line per
seed, and a summary: each number's largest program reading and smallest
control reading. Needs a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "flowbench":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import json  # noqa: E402


def main() -> int:
    import torch

    from flowbench.bench import Bench
    from flowbench.cell import run_cell, run_control

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = Bench(ROOT)
    out = open(ARGS.out, "a") if ARGS.out else None
    lines = []

    def emit(rec):
        lines.append(rec)
        text = json.dumps(rec)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    for seed in [int(s) for s in ARGS.program_seeds.split(",") if s]:
        t0 = time.perf_counter()
        result, notes = run_cell(bench, ARGS.workload, seed, ARGS.seconds, False, dev, t0)
        emit({"side": "program", "seed": seed, "correct": result["correct"],
              "numbers": {k: v["value"] for k, v in result["checks"].items()},
              "metrics": {k: v["value"] for k, v in result["metrics"].items()}, "notes": notes[:2]})
    for seed in [int(s) for s in ARGS.control_seeds.split(",") if s]:
        emit({"side": "control", "seed": seed, "numbers": run_control(bench, ARGS.workload, seed, ARGS.seconds, dev)})
    summary = {"workload": ARGS.workload, "program_max": {}, "control_min": {}}
    for rec in lines:
        key = "program_max" if rec["side"] == "program" else "control_min"
        pick = max if key == "program_max" else min
        for k, v in rec["numbers"].items():
            summary[key][k] = pick(summary[key].get(k, v), v)
    emit({"side": "summary", **summary})
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    ARGS = ap.parse_args()
    sys.exit(main())
